"""The flash-attention backward at S != T (cross-attention, K14) on the CPU:
its plain version, its scope and its routing.

``kernels/ref.py::flash_attention_bwd_ref`` with S queries against T != S
keys and no mask (whisper's decoder over the encoder's keys) is held
against ``torch.autograd`` of ``flash_attention_ref`` and against
``jax.grad`` (``jax.vjp``) of the JAX package's ``sdpa_ref(causal=False)``,
with T on and off the kernels' 64-row tiles, S above and below T, GQA
groups of 1 and 4 and dh 64, 112 and 128.  Inputs are numpy arrays from
seeded generators, given to both packages.  Tolerance: fp32 within 1e-5
of each output's largest magnitude (the same fp32 products summed in
another order).

``check_bwd_scope`` takes non-causal S != T and refuses a causal mask, a
window, ``q_offset`` or ``kv_len`` there.  The CUDA kernels do not run
here: ``ops.flash_attention`` is checked to send cross-attention that needs
gradients through ``FlashAttention`` with the kernel wrappers replaced by
their plain versions, as ``test_torch_flash_bwd.py`` does for S == T.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.models.attention import sdpa_ref as jax_sdpa_ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops
from repro_torch.kernels import ref

torch.set_num_threads(1)

REL_TOL = 1e-5
B, KV = 2, 2
# (S, T): T ragged past one and several 64-row tiles, S below and above T
CROSS = [(12, 37), (37, 12), (20, 70), (65, 130)]


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= REL_TOL, f"{what}: max|diff| / max|ref| = {err:.3e}"


def _inputs(S, T, G, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32)
            for shape in ((B, S, KV * G, dh), (B, T, KV, dh), (B, T, KV, dh),
                          (B, S, KV * G, dh))]


@pytest.mark.parametrize("dh", [64, 112, 128])
@pytest.mark.parametrize("G", [1, 4])
@pytest.mark.parametrize("S,T", CROSS, ids=[f"S{s}-T{t}" for s, t in CROSS])
def test_cross_bwd_ref_matches_autograd_and_jax_grad(S, T, G, dh):
    q, k, v, do = _inputs(S, T, G, dh, seed=S * 1000 + T + 7 * G + dh)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ref.flash_attention_ref(qt, kt, vt, causal=False)
    dot = torch.from_numpy(do)
    want_t = torch.autograd.grad(out, (qt, kt, vt), dot)
    _, vjp = jax.vjp(lambda a, b, c: jax_sdpa_ref(a, b, c, causal=False),
                     *map(jnp.asarray, (q, k, v)))
    want_j = vjp(jnp.asarray(do))

    qt, kt, vt, out = (t.detach() for t in (qt, kt, vt, out))
    lse = ref.flash_attention_lse_ref(qt, kt, vt, causal=False)
    assert lse.shape == (B, S, KV * G) and bool(torch.isfinite(lse).all())
    got = ref.flash_attention_bwd_ref(qt, kt, vt, out, dot, lse,
                                      causal=False)
    assert [tuple(g.shape) for g in got] == [q.shape, k.shape, v.shape]
    for name, g, wt, wj in zip(("dq", "dk", "dv"), got, want_t, want_j):
        assert g.dtype == torch.float32
        _close(g.numpy(), wt.numpy(), f"{name} vs torch.autograd")
        _close(g.numpy(), np.asarray(wj), f"{name} vs jax.grad")


def test_check_bwd_scope_takes_unmasked_cross_attention_only():
    fa.check_bwd_scope(448, 1500, causal=False, window=None)
    fa.check_bwd_scope(1500, 448, causal=False)
    for S in (24, 1500):                # S == T: every training mask
        fa.check_bwd_scope(S, S, causal=True, window=8)
    with pytest.raises(ValueError, match="causal=True"):
        fa.check_bwd_scope(448, 1500, causal=True)
    with pytest.raises(ValueError, match="window=8"):
        fa.check_bwd_scope(448, 1500, causal=False, window=8)
    for name in ("q_offset", "kv_len"):
        with pytest.raises(ValueError, match=name):
            fa.check_bwd_scope(448, 1500, causal=False,
                               **{name: torch.zeros(1, dtype=torch.int32)})


def test_bwd_wrapper_takes_cross_attention_up_to_the_device_check():
    """The wrapper's scope passes non-causal S != T and stops at the CPU
    tensors (no kernel route there), and refuses a causal S != T before
    that; nothing is launched or counted."""
    q = torch.zeros(1, 8, 4, 64)
    k = torch.zeros(1, 6, 2, 64)
    lse = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_bwd_cuda(q, k, k, q, q, lse, causal=False)
    with pytest.raises(ValueError, match="S=8, T=6"):
        fa.flash_attention_bwd_cuda(q, k, k, q, q, lse, causal=True)
    assert fa.flash_attention_bwd_cuda.launches == 0
    assert fa.flash_attention_bwd_cuda.cross_launches == 0


@pytest.fixture
def plain_kernels(monkeypatch):
    """``ops.flash_attention`` taking the CUDA route on CPU tensors, with
    the kernel wrappers replaced by their plain versions; returns the (S,
    T, causal) of every backward call and the forward's ``with_lse``."""
    calls = {"fwd": [], "bwd": []}

    def fwd(q, k, v, *, causal=True, window=None, q_offset=None,
            kv_len=None, with_lse=False):
        calls["fwd"].append(with_lse)
        out = ref.flash_attention_ref(q, k, v, causal=causal, window=window,
                                      q_offset=q_offset, kv_len=kv_len)
        if not with_lse:
            return out
        return out, ref.flash_attention_lse_ref(q, k, v, causal=causal,
                                                window=window)

    def bwd(q, k, v, o, dout, lse, *, causal=True, window=None):
        calls["bwd"].append((q.shape[1], k.shape[1], causal))
        return ref.flash_attention_bwd_ref(q, k, v, o, dout, lse,
                                           causal=causal, window=window)

    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    monkeypatch.setattr(ops, "flash_attention_cuda", fwd)
    monkeypatch.setattr(fa, "flash_attention_cuda", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_cuda", bwd)
    return calls


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_ops_routes_cross_attention_through_the_backward(plain_kernels,
                                                         remat):
    S, T = 20, 70
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(S, T, 4, 64, seed=5))
    q, k, v = (t.requires_grad_() for t in (q, k, v))

    def attend(q, k, v):
        return ops.flash_attention(q, k, v, causal=False)

    out = (checkpoint(attend, q, k, v, use_reentrant=False) if remat
           else attend(q, k, v))
    got = torch.autograd.grad(out, (q, k, v), do)
    assert plain_kernels == {"fwd": [True] * (1 + remat),
                             "bwd": [(S, T, False)]}
    want = torch.autograd.grad(
        ref.flash_attention_ref(q, k, v, causal=False), (q, k, v), do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g.numpy(), w.numpy(), name)

    with torch.no_grad():               # serving's lean launch: no lse
        attend(q, k, v)
    assert plain_kernels["fwd"][-1] is False
    for kw, name in ((dict(causal=True), "causal"),
                     (dict(causal=False, window=9), "window")):
        with pytest.raises(ValueError, match=name):
            ops.flash_attention(q, k, v, **kw)
    assert len(plain_kernels["bwd"]) == 1
