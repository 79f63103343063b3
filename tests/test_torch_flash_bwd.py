"""The flash-attention backward's plain versions and routing, on the CPU.

``kernels/ref.py::flash_attention_bwd_ref`` (the backward kernel's D / P /
dS formulation) is held against ``torch.autograd`` of
``flash_attention_ref`` and against ``jax.grad`` of the JAX package's
``sdpa_ref``, and ``flash_attention_lse_ref`` against a masked
``logsumexp``.  Inputs are numpy arrays from seeded generators, given to
both packages.  Tolerance: fp32 within 1e-5 of each output's largest
magnitude (the same fp32 products summed in another order).

The CUDA kernels do not run here; the routing of ``ops.flash_attention``
(inputs that need gradients through ``FlashAttention``, others to the lean
forward) is checked with the kernel wrappers replaced by their plain
versions, and the ctypes argument list against the C signature.
"""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro.models.attention import sdpa_ref as jax_sdpa_ref
from repro_torch.kernels import _build, ops
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref

torch.set_num_threads(1)

REL_TOL = 1e-5
S, B, KV = 20, 2, 2


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= REL_TOL, f"{what}: max|diff| / max|ref| = {err:.3e}"


def _inputs(G, dh, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32)
            for shape in ((B, S, KV * G, dh), (B, S, KV, dh), (B, S, KV, dh),
                          (B, S, KV * G, dh))]


@pytest.mark.parametrize("window", [None, 7], ids=["full", "window7"])
@pytest.mark.parametrize("causal", [True, False], ids=["causal", "bidir"])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("G", [1, 4])
def test_bwd_ref_matches_autograd_and_jax_grad(G, dh, causal, window):
    q, k, v, do = _inputs(G, dh, seed=G * 1000 + dh + 2 * causal
                          + (window or 0))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = ref.flash_attention_ref(qt, kt, vt, causal=causal, window=window)
    dot = torch.from_numpy(do)
    want_t = torch.autograd.grad(out, (qt, kt, vt), dot)
    _, vjp = jax.vjp(lambda a, b, c: jax_sdpa_ref(a, b, c, causal=causal,
                                                  window=window),
                     *map(jnp.asarray, (q, k, v)))
    want_j = vjp(jnp.asarray(do))

    qt, kt, vt, out = (t.detach() for t in (qt, kt, vt, out))
    lse = ref.flash_attention_lse_ref(qt, kt, vt, causal=causal,
                                      window=window)
    got = ref.flash_attention_bwd_ref(qt, kt, vt, out, dot, lse,
                                      causal=causal, window=window)
    for name, g, wt, wj in zip(("dq", "dk", "dv"), got, want_t, want_j):
        assert g.dtype == torch.float32
        _close(g.numpy(), wt.numpy(), f"{name} vs torch.autograd")
        _close(g.numpy(), np.asarray(wj), f"{name} vs jax.grad")


@pytest.mark.parametrize("causal,window,S_,T_", [
    (True, None, 20, 20), (False, 5, 20, 20), (True, 3, 12, 12),
    (True, 2, 10, 4),       # queries 5.. see no key of the 4: +inf rows
])
def test_lse_ref_is_the_masked_logsumexp(causal, window, S_, T_):
    rng = np.random.default_rng(S_ + T_ + (window or 0))
    q = torch.from_numpy(rng.standard_normal((2, S_, 4, 16), np.float32))
    k = torch.from_numpy(rng.standard_normal((2, T_, 2, 16), np.float32))
    got = ref.flash_attention_lse_ref(q, k, k, causal=causal, window=window)
    assert got.shape == (2, S_, 4) and got.dtype == torch.float32
    s = torch.einsum("bshd,bthd->bsht", q.double(),
                     k.double().repeat_interleave(2, dim=2)) / 4.0
    i, j = torch.arange(S_)[:, None], torch.arange(T_)[None, :]
    mask = torch.ones(S_, T_, dtype=torch.bool)
    if causal:
        mask &= j <= i
    if window is not None:
        mask &= j > i - window
    want = torch.logsumexp(s.masked_fill(~mask[:, None, :], -np.inf), -1)
    empty = ~mask.any(-1)
    assert bool(empty.any()) == (T_ < S_)
    assert torch.isinf(got[:, empty]).all() and (got[:, empty] > 0).all()
    np.testing.assert_allclose(got[:, ~empty].numpy(),
                               want[:, ~empty].numpy(), rtol=0, atol=1e-5)


def test_bwd_binding_matches_the_c_signature():
    """One ctypes entry per parameter of ``flash_attention_bwd``, pointers
    as c_void_p (a short list shifts every argument)."""
    src = (_build.CSRC / "flash_attention.cu").read_text()
    sig = re.search(r'extern "C" int flash_attention_bwd\((.*?)\)', src,
                    re.S).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert len(params) == len(fa.BWD_ARGTYPES)
    for p, t in zip(params, fa.BWD_ARGTYPES):
        want = (ctypes.c_void_p if "*" in p else
                ctypes.c_float if p.startswith("float") else ctypes.c_int)
        assert t is want, p


def test_bwd_wrapper_refuses_what_it_does_not_take():
    q = torch.zeros(1, 8, 4, 64)
    k = torch.zeros(1, 8, 2, 64)
    lse = torch.zeros(1, 8, 4)
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_bwd_cuda(q, k, k, q, q, lse)
    with pytest.raises(ValueError, match="T=6"):
        fa.flash_attention_bwd_cuda(q, k[:, :6], k[:, :6], q, q, lse)
    for name in ("q_offset", "kv_len"):
        with pytest.raises(ValueError, match=name):
            fa.check_bwd_scope(8, 8,
                               **{name: torch.zeros(1, dtype=torch.int32)})
    assert fa.flash_attention_bwd_cuda.launches == 0


@pytest.fixture
def plain_kernels(monkeypatch):
    """``ops.flash_attention`` taking the CUDA route on CPU tensors, with
    the kernel wrappers replaced by their plain versions; returns the calls
    made to each wrapper."""
    calls = {"fwd": [], "bwd": 0}

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
        calls["bwd"] += 1
        return ref.flash_attention_bwd_ref(q, k, v, o, dout, lse,
                                           causal=causal, window=window)

    monkeypatch.setattr(ops, "_on_cuda", lambda x: True)
    monkeypatch.setattr(ops, "flash_attention_cuda", fwd)
    monkeypatch.setattr(fa, "flash_attention_cuda", fwd)
    monkeypatch.setattr(fa, "flash_attention_bwd_cuda", bwd)
    return calls


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_ops_routes_inputs_that_need_grad_through_the_backward(
        plain_kernels, remat):
    q, k, v, do = (torch.from_numpy(a) for a in _inputs(4, 64, seed=3))
    q, k, v = (t.requires_grad_() for t in (q, k, v))

    def attend(q, k, v):
        return ops.flash_attention(q, k, v, causal=True, window=9)

    out = (checkpoint(attend, q, k, v, use_reentrant=False) if remat
           else attend(q, k, v))
    got = torch.autograd.grad(out, (q, k, v), do)
    # the forward with lse, and under remat once more in the backward: the
    # recomputed forward's lse is the one the backward reads
    assert plain_kernels == {"fwd": [True] * (1 + remat), "bwd": 1}
    want = torch.autograd.grad(
        ref.flash_attention_ref(q, k, v, causal=True, window=9), (q, k, v), do)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        _close(g.numpy(), w.numpy(), name)

    with torch.no_grad():               # serving's lean launch: no lse
        attend(q, k, v)
    attend(q.detach(), k.detach(), v.detach())
    assert plain_kernels["fwd"][-2:] == [False, False]
    with pytest.raises(ValueError, match="q_offset"):
        ops.flash_attention(q, k, v,
                            q_offset=torch.zeros(B, dtype=torch.int32))
