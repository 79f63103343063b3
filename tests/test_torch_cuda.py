"""The port's kernels on the card, against their plain PyTorch versions.

Marked ``gpu``: they need a CUDA device and skip without one (the kernels
have no CPU mode).  They import neither JAX nor the JAX package, so they
run where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: fp32 1e-5 (the same fp32 arithmetic in another order); bf16
attention 2e-2 (bf16 rounding of outputs of size ~1); bf16 RMSNorm one
bf16 ulp (fp32 math, one rounding at the end).  Backward kernels and the
SSD scan are held against ``torch.autograd`` of the plain versions, with
the error taken relative to the largest magnitude of each reference:
fp32 1e-4 (sums of up to chunk x state x head-dim products in another
order); bf16 2e-2 (inputs and outputs rounded to bf16, fp32 inside).  The
fp32 SSD cases are held against the plain version in float64, since the
fp32 plain version is itself off by up to ~1e-4 in the gradients of dt and
A (sums over a chunk of differences of sums): the kernel passes within
1e-4 of float64, or no further from it than twice the fp32 plain version.
Ring attention's panel-visit kernel writes fp32 (acc, m, l) whatever its
input type: fp32 inputs within 1e-5 of the plain version relative to each
output's largest magnitude, bf16 inputs within 2e-3 (the same bf16 values
read by both, fp32 sums in another order; the bf16 kernel multiplies V by
P split into two bf16 terms, about 2^-16 of P from the fp32 P); rows the
panel rejects whole exactly (0, -1e30, 0).  The attention cases run GQA
groups of 1, 4, 5 and 8, which the bf16 kernel packs into one CTA's rows.
The flash backward is held against both its plain version (the kernel's
formulation on the same output and log-sum-exp) and ``torch.autograd`` of
``flash_attention_ref`` at the backward tolerances, the forward's row
log-sum-exp against ``flash_attention_lse_ref`` at the forward's, and a
second call must give the same bits (no atomics), as must the SSD scan's
backward; its cases include cross-attention (S != T, no mask, K14).
Reduced fp32 whisper-medium serves and trains on the card as on the CPU
(losses within 1e-4).
"""
import copy

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import (flash_attention_bwd_cuda,
                                                 flash_attention_cuda)
from repro_torch.kernels.rmsnorm import (RMSNorm, rmsnorm_bwd_cuda,
                                         rmsnorm_cuda)
from repro_torch.kernels.ring_attention import flash_partial_cuda
from repro_torch.kernels.ssd_scan import SSDScan, ssd_scan_cuda

torch.set_num_threads(1)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# (S, T, causal, window): ragged lengths, windows off the 64-row tiles
FLASH_CASES = [(5, 5, True, None), (13, 29, True, 7), (37, 37, False, None),
               (21, 21, True, 9), (130, 200, True, None)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels do not run on the CPU")
    return torch.device("cuda")


# query heads over KV 2: GQA groups of 1, 4, 5 (qwen2.5-14b) and 8, which
# the bf16 kernel packs into the rows of one CTA
GQA_HEADS = [2, 8, 10, 16]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [64, 112, 128])
@pytest.mark.parametrize("H", GQA_HEADS)
@pytest.mark.parametrize("S,T,causal,window", FLASH_CASES)
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, dh, H, S, T,
                                            causal, window):
    rng = np.random.default_rng(S + T + dh + H)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(cuda_device, dtype)
               for shape in ((2, S, H, dh), (2, T, 2, dh), (2, T, 2, dh)))
    lanes = dict(q_offset=torch.tensor([0, 3], dtype=torch.int32,
                                       device=cuda_device),
                 kv_len=torch.tensor([T, T - 2], dtype=torch.int32,
                                     device=cuda_device))
    for kw in ({}, lanes):
        out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   **kw)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window, **kw)
        assert (out.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [64, 112, 128])
@pytest.mark.parametrize("H", GQA_HEADS)
def test_flash_kernel_decode_matches_plain_on_card(cuda_device, dtype, dh,
                                                   H):
    """One query row a lane (S = 1) at per-lane positions from -1 (no
    admissible key: exact zeros) to T - 1, full and cut kv_len."""
    T = 300
    rng = np.random.default_rng(dh + H)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(cuda_device, dtype)
               for shape in ((6, 1, H, dh), (6, T, 2, dh), (6, T, 2, dh)))
    q_offset = torch.tensor([-1, 0, 5, 64, 200, T - 1], dtype=torch.int32,
                            device=cuda_device)
    for kv_len in (None, torch.tensor([T, T, 3, 65, 150, T],
                                      dtype=torch.int32, device=cuda_device)):
        out = flash_attention_cuda(q, k, v, q_offset=q_offset, kv_len=kv_len)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, q_offset=q_offset,
                                       kv_len=kv_len)
        assert (out.float() - want.float()).abs().max().item() <= TOL[dtype]
        assert bool((out[0] == 0).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [64, 112, 128])
@pytest.mark.parametrize("H", GQA_HEADS)
def test_flash_kernel_dense_decode_matches_plain_on_card(cuda_device, dtype,
                                                         dh, H):
    """The dense-cache engine's launch: one query row a lane (S = 1),
    non-causal, a per-lane kv_len from 1 to T over a cache of T slots."""
    T = 300
    rng = np.random.default_rng(dh + H + 1)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(cuda_device, dtype)
               for shape in ((6, 1, H, dh), (6, T, 2, dh), (6, T, 2, dh)))
    kv_len = torch.tensor([1, 2, 64, 65, 150, T], dtype=torch.int32,
                          device=cuda_device)
    out = flash_attention_cuda(q, k, v, causal=False, kv_len=kv_len)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, causal=False, kv_len=kv_len)
    assert (out.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 5], ids=["in-place", "gathered"])
def test_attention_decode_on_card_matches_cpu(cuda_device, monkeypatch,
                                              dtype, window):
    """attention_decode over a ring of 8 slots for 12 tokens on the card
    and on the CPU from the same weights.  With no window every launch
    reads the cache tensors themselves, non-causal with a kv_len; with a
    window of 5 the launches after the wrap read a gathered copy."""
    from repro_torch.models.attention import (attention_decode,
                                              init_attention, init_kv_cache)
    from repro_torch.models.common import ModelConfig

    cfg = ModelConfig(name="t", arch_type="dense", n_layers=1, d_model=256,
                      n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=64,
                      head_dim=64, qk_norm=True, dtype=dtype)
    g = torch.Generator().manual_seed(0)
    p_cpu = init_attention(cfg, generator=g, device=torch.device("cpu"))
    p_gpu = copy.deepcopy(p_cpu).to(cuda_device)
    caches = {dev: init_kv_cache(cfg, 2, 8, device=dev)
              for dev in ("cpu", cuda_device)}
    launches = []
    real = ops.flash_attention_cuda

    def recording(q, k, v, **kw):
        launches.append((k.data_ptr() == caches[cuda_device]["k"].data_ptr(),
                         kw["causal"], kw.get("kv_len") is not None))
        return real(q, k, v, **kw)

    monkeypatch.setattr(ops, "flash_attention_cuda", recording)
    xs = torch.randn(2, 12, 256, generator=g).to(dtype)
    for t in range(12):
        with torch.inference_mode():
            want, _ = attention_decode(p_cpu, xs[:, t:t + 1], caches["cpu"],
                                       t, cfg, window=window)
            got, _ = attention_decode(p_gpu, xs[:, t:t + 1].to(cuda_device),
                                      caches[cuda_device], t, cfg,
                                      window=window)
        torch.cuda.synchronize()
        assert _rel_err(got.cpu(), want) <= REL_TOL[dtype], f"t={t}"
    in_place = [(True, False, True)] * 12
    if window is not None:      # causal in place, then gathered after t = 7
        in_place = [(True, True, False)] * 8 + [(False, True, False)] * 4
    assert launches == in_place


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 2560), (3, 7, 128), (1, 100),
                                   (8, 4096), (8, 5120), (8, 6144),
                                   (8, 7168), (8, 8192), (512, 7168)])
def test_rmsnorm_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    w = torch.randn(shape[-1], generator=g, device=cuda_device).to(dtype)
    out = rmsnorm_cuda(x, w, 1e-6).float()
    torch.cuda.synchronize()
    want = ref.rmsnorm_ref(x, w, 1e-6).float()
    if dtype == torch.float32:
        tol = TOL[dtype]
    else:
        tol = torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(1e-30))) - 7)
    assert bool(((out - want).abs() <= tol).all())


REL_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


def _rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp_min(1e-30)).item()


def ssd_inputs(B, S, H, P, N, device, dtype, *, broadcast=True, seed=0,
               groups=None):
    """SSD scan inputs as ``models/ssm.py`` makes them: dt = softplus of a
    normal draw, A = -exp(log linspace(1, 16)); Bm/Cm one group for every
    head, (B,S,1,N), unless ``broadcast`` is False (one per head) or
    ``groups`` is given.  Returns the leaf tensors and a function of leaves
    giving the (x, dt, A, Bm, Cm) the scan takes."""
    rng = np.random.default_rng(seed)
    G = groups or (1 if broadcast else H)

    def leaf(shape, dt=dtype, scale=1.0):
        a = rng.standard_normal(shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(device, dt).requires_grad_()

    x = leaf((B, S, H, P))
    dt_raw = leaf((B, S, H), torch.float32)
    a_log = torch.log(torch.linspace(1.0, 16.0, H)).to(device)
    a_log.requires_grad_()
    bg, cg = leaf((B, S, G, N), scale=0.5), leaf((B, S, G, N), scale=0.5)
    leaves = (x, dt_raw, a_log, bg, cg)

    def views(x, dt_raw, a_log, bg, cg):
        return (x, torch.nn.functional.softplus(dt_raw), -torch.exp(a_log),
                bg, cg)

    return leaves, views


def float64_leaves(leaves):
    return tuple(t.detach().double().requires_grad_() for t in leaves)


# (B, S, H, P, N, chunk): the reduced and full model widths, ragged S,
# S shorter than a chunk, odd widths
SSD_CASES = [(2, 64, 4, 64, 16, 16), (1, 100, 3, 64, 128, 64),
             (2, 37, 2, 32, 24, 16), (1, 50, 2, 64, 128, 64),
             (1, 130, 2, 48, 40, 32)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("broadcast", [True, False],
                         ids=["bc-broadcast", "bc-per-head"])
@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_CASES)
def test_ssd_scan_kernels_match_plain_on_card(cuda_device, dtype, broadcast,
                                              B, S, H, P, N, chunk):
    leaves, views = ssd_inputs(B, S, H, P, N, cuda_device, dtype,
                               broadcast=broadcast)
    dy = torch.randn(B, S, H, P, device=cuda_device).to(dtype)
    launches = ssd_scan_cuda.launches
    y = SSDScan.apply(*views(*leaves), chunk)
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    assert ssd_scan_cuda.launches == launches + 1
    y_ref = ref.ssd_scan_ref(*views(*leaves), chunk)
    grads_ref = torch.autograd.grad(y_ref, leaves, dy)
    assert y.dtype == dtype and y.shape == (B, S, H, P)
    assert all(g.shape == t.shape for g, t in zip(grads, leaves))
    if dtype == torch.bfloat16:
        assert _rel_err(y, y_ref) <= REL_TOL[dtype]
        for name, g, gr in zip(("dx", "ddt", "dA", "dB", "dC"), grads,
                               grads_ref):
            assert _rel_err(g, gr) <= REL_TOL[dtype], name
        return
    leaves64 = float64_leaves(leaves)
    y64 = ref.ssd_scan_ref(*views(*leaves64), chunk)
    grads64 = torch.autograd.grad(y64, leaves64, dy.double())
    for name, g, gr, g64 in zip(("y", "dx", "ddt", "dA", "dB", "dC"),
                                (y, *grads), (y_ref, *grads_ref),
                                (y64, *grads64)):
        tol = max(REL_TOL[dtype], 2 * _rel_err(gr, g64))
        assert _rel_err(g, g64) <= tol, name


# bf16 runs the chunk-parallel backward (three kernels, one CTA per chunk
# in two of them): 16 or more chunks, ragged, narrow and odd widths, and G
# groups of heads.  (B, S, H, P, N, chunk, G)
SSD_BF16_CASES = [(2, 1024, 4, 64, 128, 64, 1), (2, 1024, 4, 64, 128, 64, 2),
                  (1, 1100, 4, 64, 128, 64, 2), (2, 600, 6, 48, 40, 32, 3),
                  (1, 333, 2, 32, 24, 16, 2), (1, 300, 3, 33, 37, 32, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("B,S,H,P,N,chunk,G", SSD_BF16_CASES)
def test_ssd_scan_bf16_chunk_parallel_backward_on_card(cuda_device, B, S, H,
                                                       P, N, chunk, G):
    leaves, views = ssd_inputs(B, S, H, P, N, cuda_device, torch.bfloat16,
                               groups=G, seed=1)
    dy = torch.randn(B, S, H, P, device=cuda_device).to(torch.bfloat16)
    y = SSDScan.apply(*views(*leaves), chunk)
    grads = torch.autograd.grad(y, leaves, dy)
    torch.cuda.synchronize()
    y_ref = ref.ssd_scan_ref(*views(*leaves), chunk)
    grads_ref = torch.autograd.grad(y_ref, leaves, dy)
    assert leaves[3].shape == (B, S, G, N)
    for name, g, gr in zip(("dx", "ddt", "dA", "dB", "dC"), grads,
                           grads_ref):
        assert g.shape == gr.shape and g.dtype == gr.dtype, name
        assert bool(torch.isfinite(g).all()), name
        assert _rel_err(g, gr) <= REL_TOL[torch.bfloat16], name


@pytest.mark.gpu
@pytest.mark.parametrize("strided", [False, True],
                         ids=["contiguous", "bc-views"])
@pytest.mark.parametrize("B,S,H,P,N,chunk,G", SSD_BF16_CASES)
def test_ssd_scan_bf16_chunk_parallel_forward_on_card(cuda_device, B, S, H,
                                                      P, N, chunk, G,
                                                      strided):
    """The bf16 forward (three chunk-parallel kernels) against the plain
    version in fp32 on the same bf16 values; with ``strided``, Bm and Cm
    are views of one (B,S,G,2N+8) tensor, as models/ssm.py slices them."""
    leaves, views = ssd_inputs(B, S, H, P, N, cuda_device, torch.bfloat16,
                               groups=G, seed=2)
    x, dt, A, Bm, Cm = (t.detach() for t in views(*leaves))
    if strided:
        bc = torch.cat([Bm, Cm, torch.zeros_like(Bm[..., :8])], -1)
        Bm, Cm = bc[..., :N], bc[..., N:2 * N]
        assert not Bm.is_contiguous()
    launches = ssd_scan_cuda.launches
    y = ssd_scan_cuda(x, dt, A, Bm, Cm, chunk)
    torch.cuda.synchronize()
    assert ssd_scan_cuda.launches == launches + 1
    y_ref = ref.ssd_scan_ref(x.float(), dt, A, Bm.float(), Cm.float(), chunk)
    assert y.dtype == torch.bfloat16 and y.shape == (B, S, H, P)
    assert bool(torch.isfinite(y).all())
    assert _rel_err(y, y_ref) <= REL_TOL[torch.bfloat16]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 2560), (3, 7, 128), (1, 100),
                                   (700, 1024), (33, 2048), (4352, 6144)])
def test_rmsnorm_backward_kernel_matches_plain_on_card(cuda_device, dtype,
                                                       shape):
    g = torch.Generator(device=cuda_device).manual_seed(1)
    x = (torch.randn(shape, generator=g, device=cuda_device) * 2).to(dtype)
    w = torch.randn(shape[-1], generator=g, device=cuda_device).to(dtype)
    dy = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    x.requires_grad_()
    w.requires_grad_()
    dx, dw = torch.autograd.grad(RMSNorm.apply(x, w, 1e-6), (x, w), dy)
    torch.cuda.synchronize()
    dx_ref, dw_ref = torch.autograd.grad(ref.rmsnorm_ref(x, w, 1e-6),
                                         (x, w), dy)
    assert dx.dtype == dtype and dw.dtype == dtype
    assert _rel_err(dx, dx_ref) <= REL_TOL[dtype]
    assert _rel_err(dw, dw_ref) <= REL_TOL[dtype]


def _assert_y_close(out, want):
    """fp32 within TOL; bf16 within one ulp (fp32 math, one rounding)."""
    out, dtype, want = out.float(), out.dtype, want.float()
    if dtype == torch.float32:
        tol = TOL[dtype]
    else:
        tol = torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(1e-30))) - 7)
    assert bool(((out - want).abs() <= tol).all())


def _rmsnorm_both_ways(x, w, dy):
    """(y, dx, dw) of the kernels and of the plain version, eps 1e-6."""
    x, w = x.detach().requires_grad_(), w.detach().requires_grad_()
    y = RMSNorm.apply(x, w, 1e-6)
    got = (y, *torch.autograd.grad(y, (x, w), dy))
    torch.cuda.synchronize()
    y_ref = ref.rmsnorm_ref(x, w, 1e-6)
    return got, (y_ref, *torch.autograd.grad(y_ref, (x, w), dy))


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,shape", [(torch.bfloat16, (4099, 2048)),
                                         (torch.bfloat16, (16384, 1024)),
                                         (torch.float32, (1000, 1024)),
                                         (torch.bfloat16, (300, 4096)),
                                         (torch.bfloat16, (4096, 5120)),
                                         (torch.bfloat16, (4352, 6144))],
                         ids=["bf16-2048", "bf16-1024", "fp32-1024",
                              "bf16-4096-wide", "bf16-5120-wide",
                              "bf16-6144-wide"])
def test_rmsnorm_backward_dw_is_bitwise_stable_on_card(cuda_device, dtype,
                                                       shape):
    """A fixed partition of the rows and fixed-order sums: two calls give
    the same dw bits (and dx bits)."""
    g = torch.Generator(device=cuda_device).manual_seed(2)
    x, dy = (torch.randn(shape, generator=g, device=cuda_device).to(dtype)
             for _ in range(2))
    w = torch.randn(shape[-1], generator=g, device=cuda_device).to(dtype)
    dx1, dw1 = rmsnorm_bwd_cuda(dy, x, w)
    dx2, dw2 = rmsnorm_bwd_cuda(dy, x, w)
    torch.cuda.synchronize()
    assert torch.equal(dw1, dw2) and torch.equal(dx1, dx2)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,d", [(torch.bfloat16, 2560),
                                     (torch.bfloat16, 128),
                                     (torch.float32, 1024),
                                     (torch.bfloat16, 6144)],
                         ids=["bf16-2560", "bf16-128", "fp32-1024",
                              "bf16-6144"])
def test_rmsnorm_unaligned_base_on_card(cuda_device, dtype, d):
    """Rows of a view at storage offset 1 (base and rows off the 16-byte
    grid) take the kernels' scalar body, both ways."""
    g = torch.Generator(device=cuda_device).manual_seed(3)
    rows = 77
    flat = torch.randn(rows * d + 1, generator=g, device=cuda_device)
    x = flat.to(dtype)[1:].view(rows, d)
    assert x.data_ptr() % 16 != 0
    w = torch.randn(d, generator=g, device=cuda_device).to(dtype)
    dy = torch.randn(rows, d, generator=g, device=cuda_device).to(dtype)
    got, want = _rmsnorm_both_ways(x, w, dy)
    _assert_y_close(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert _rel_err(a, b) <= REL_TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(0, 2560), (2, 0, 128), (3, 0)],
                         ids=["rows0-2560", "rows0-128", "d0"])
def test_rmsnorm_zero_rows_on_card(cuda_device, shape):
    """No rows (or no columns): empty outputs, dw zeros, no launch."""
    x = torch.randn(shape, device=cuda_device).bfloat16()
    w = torch.randn(shape[-1], device=cuda_device).bfloat16()
    before = (rmsnorm_cuda.launches, rmsnorm_bwd_cuda.launches)
    y = rmsnorm_cuda(x, w)
    dx, dw = rmsnorm_bwd_cuda(x, x, w)
    assert y.shape == x.shape and dx.shape == x.shape
    assert dw.shape == w.shape and not dw.any()
    assert (rmsnorm_cuda.launches, rmsnorm_bwd_cuda.launches) == before


@pytest.mark.gpu
@pytest.mark.parametrize("xdt,wdt,shape", [
    (torch.bfloat16, torch.bfloat16, (37, 4096)),
    (torch.bfloat16, torch.bfloat16, (129, 777)),
    (torch.bfloat16, torch.bfloat16, (5, 100)),
    (torch.float32, torch.float32, (33, 5000)),
    (torch.bfloat16, torch.float32, (65, 2560)),
    (torch.float32, torch.bfloat16, (9, 1024)),
    (torch.bfloat16, torch.bfloat16, (9, 8192)),
    (torch.bfloat16, torch.bfloat16, (65, 3001)),
    (torch.bfloat16, torch.float32, (33, 6144)),
    (torch.bfloat16, torch.bfloat16, (5, 12288)),
    (torch.bfloat16, torch.bfloat16, (9, 16392)),
    (torch.float32, torch.float32, (9, 8200))],
    ids=["bf16-4096", "bf16-777", "bf16-100", "fp32-5000", "bf16-w-fp32",
         "fp32-w-bf16", "bf16-8192", "bf16-3001", "bf16-6144-w-fp32",
         "bf16-12288", "bf16-16392", "fp32-8200"])
def test_rmsnorm_wide_odd_and_mixed_on_card(cuda_device, xdt, wdt, shape):
    """d past the register bodies (the cta bodies; at 12288 their shared
    memory passes 48 KB; past bf16 16384 and fp32 8192 the looped
    kernels), odd d (the scalar bodies) and w in another dtype than x, both
    ways; dx in x's dtype and dw in w's."""
    g = torch.Generator(device=cuda_device).manual_seed(4)
    x = (torch.randn(shape, generator=g, device=cuda_device) * 2).to(xdt)
    w = torch.randn(shape[-1], generator=g, device=cuda_device).to(wdt)
    dy = torch.randn(shape, generator=g, device=cuda_device).to(xdt)
    got, want = _rmsnorm_both_ways(x, w, dy)
    assert got[1].dtype == xdt and got[2].dtype == wdt
    _assert_y_close(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        assert _rel_err(a, b) <= REL_TOL[xdt if wdt == xdt else
                                          torch.bfloat16]


# (S, T, delta, causal, window): ragged S and T off the 64-row tiles; the
# panel behind, on and ahead of the q shard (ahead: causally dead); deltas
# that kill the first q tile's keys but not the second's, and a window that
# starts past the panel's end
PARTIAL_CASES = [(77, 77, 0, True, None), (77, 77, 77, True, None),
                 (77, 77, -77, True, None), (64, 64, -192, True, None),
                 (130, 130, -70, True, None), (130, 100, 37, True, 50),
                 (130, 130, 390, True, 50), (100, 130, 1000, False, None),
                 (100, 130, -1000, False, 60)]
PARTIAL_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-3}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [64, 112, 128])
@pytest.mark.parametrize("H", GQA_HEADS)
@pytest.mark.parametrize("S,T,delta,causal,window", PARTIAL_CASES)
def test_flash_partial_kernel_matches_plain_on_card(cuda_device, dtype, dh,
                                                    H, S, T, delta, causal,
                                                    window):
    rng = np.random.default_rng(S + T + dh + H + abs(delta))
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(cuda_device, dtype)
               for shape in ((2, S, H, dh), (2, T, 2, dh), (2, T, 2, dh)))
    launches = flash_partial_cuda.launches
    acc, m, l = flash_partial_cuda(q, k, v, delta, causal=causal,
                                   window=window)
    torch.cuda.synchronize()
    assert flash_partial_cuda.launches == launches + 1
    acc_r, m_r, l_r = ref.flash_partial_ref(q, k, v, delta, causal=causal,
                                            window=window)
    assert all(t.dtype == torch.float32 for t in (acc, m, l))
    seen = l_r[..., 0] > 0
    assert torch.equal(l[..., 0] > 0, seen)
    if seen.any():
        for got, want in ((acc[seen], acc_r[seen]), (m[seen], m_r[seen]),
                          (l[seen], l_r[seen])):
            assert _rel_err(got, want) <= PARTIAL_TOL[dtype]
    empty = ~seen
    assert bool((acc[empty] == 0).all() and (l[empty] == 0).all())
    assert bool((m[empty] == -1e30).all())


# (S, causal, window): S off the 64-row tiles, windows off them, one tile;
# then across the bf16 kernels' 128-row CTA tiles and their TMA ring: one
# full 128-key tile and a partial one, a window across a 128-key boundary,
# and many wraps of the three stages' parity
# and cross-attention (K14): (S, T) with S != T and no mask, T ragged past
# one and 23 key tiles (whisper's 1500 encoder frames), S below and above T
FLASH_BWD_CASES = [(5, True, None), (100, True, None), (100, False, None),
                   (100, True, 8), (130, False, 9), (64, True, 70),
                   (192, True, None), (300, True, 70), (2048, True, None),
                   *(pytest.param((S, T), False, None, id=f"S{S}-T{T}-cross")
                     for S, T in ((37, 200), (200, 37), (130, 1500),
                                  (448, 1500)))]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [64, 112, 128])
@pytest.mark.parametrize("H", GQA_HEADS)
@pytest.mark.parametrize("S,causal,window", FLASH_BWD_CASES)
def test_flash_backward_matches_plain_on_card(cuda_device, dtype, dh, H, S,
                                              causal, window):
    S, T = S if isinstance(S, tuple) else (S, S)
    rng = np.random.default_rng(S + T + dh + H + 2 * causal + (window or 0))
    q, k, v, do = (torch.from_numpy(rng.standard_normal(shape, np.float32))
                   .to(cuda_device, dtype)
                   for shape in ((2, S, H, dh), (2, T, 2, dh), (2, T, 2, dh),
                                 (2, S, H, dh)))
    win = None if window is not None and window >= S else window
    out, lse = flash_attention_cuda(q, k, v, causal=causal, window=win,
                                    with_lse=True)
    got = flash_attention_bwd_cuda(q, k, v, out, do, lse, causal=causal,
                                   window=win)
    again = flash_attention_bwd_cuda(q, k, v, out, do, lse, causal=causal,
                                     window=win)
    torch.cuda.synchronize()
    lse_ref = ref.flash_attention_lse_ref(q, k, v, causal=causal, window=win)
    assert (lse - lse_ref).abs().max().item() <= TOL[dtype]
    plain = ref.flash_attention_bwd_ref(q, k, v, out, do, lse, causal=causal,
                                        window=win)
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    auto = torch.autograd.grad(
        ref.flash_attention_ref(*leaves, causal=causal, window=win), leaves,
        do)
    for g, g2, p, a in zip(got, again, plain, auto):
        assert g.dtype == dtype and torch.equal(g, g2)
        assert _rel_err(g, p) <= REL_TOL[dtype]
        assert _rel_err(g, a) <= REL_TOL[dtype]


@pytest.mark.gpu
def test_flash_partial_on_card_raises_under_grad(cuda_device):
    """The panel visit has no backward (K5): on the card its outputs would
    carry no ``grad_fn``, so an input that needs gradients raises while
    grad is enabled, before any launch; under ``no_grad`` it launches."""
    g = torch.Generator(device=cuda_device).manual_seed(6)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device)
               .bfloat16() for shape in ((1, 64, 8, 128), (1, 64, 2, 128),
                                         (1, 64, 2, 128)))
    launches = flash_partial_cuda.launches
    with pytest.raises(ValueError, match="K5"):
        ops.flash_partial(q, k.requires_grad_(), v, 0)
    assert flash_partial_cuda.launches == launches
    with torch.no_grad():
        ops.flash_partial(q, k, v, 0)
    assert flash_partial_cuda.launches == launches + 1


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_flash_autograd_runs_the_kernels_on_card(cuda_device, dtype):
    """``ops.flash_attention`` on inputs that need gradients: one forward
    launch with the log-sum-exp and one backward launch; without gradients
    the forward alone."""
    g = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device)
               .to(dtype).requires_grad_()
               for shape in ((2, 77, 8, 128), (2, 77, 2, 128),
                             (2, 77, 2, 128)))
    do = torch.randn(q.shape, generator=g, device=cuda_device).to(dtype)
    fwd, bwd = flash_attention_cuda.launches, flash_attention_bwd_cuda.launches
    got = torch.autograd.grad(ops.flash_attention(q, k, v, window=20),
                              (q, k, v), do)
    assert (flash_attention_cuda.launches - fwd,
            flash_attention_bwd_cuda.launches - bwd) == (1, 1)
    want = torch.autograd.grad(ref.flash_attention_ref(q, k, v, window=20),
                               (q, k, v), do)
    for a, b in zip(got, want):
        assert _rel_err(a, b) <= REL_TOL[dtype]
    with torch.no_grad():
        ops.flash_attention(q, k, v)
    assert flash_attention_bwd_cuda.launches - bwd == 1


# ---------------------------------------------------------------------------
# SSM and hybrid serving: the kernels at its shapes, and decode on the card
# ---------------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["decode", "prefill"])
def test_flash_kernel_at_zamba2_shapes_on_card(cuda_device, dtype, case):
    """zamba2's shared block (MHA, H = KV = 32, dh 64): the dense engine's
    decode, 8 lanes over 2048 slots with kv_len from 1 to 2048, and the
    causal prefill of 1024 tokens."""
    g = torch.Generator(device=cuda_device).manual_seed(7)
    B, S, T = (8, 1, 2048) if case == "decode" else (1, 1024, 1024)
    q, k, v = (torch.randn(shape, generator=g, device=cuda_device).to(dtype)
               for shape in ((B, S, 32, 64), (B, T, 32, 64), (B, T, 32, 64)))
    kw = {} if case == "prefill" else dict(causal=False, kv_len=torch.tensor(
        [1, 2, 63, 64, 65, 1000, 2047, 2048], dtype=torch.int32,
        device=cuda_device))
    out = flash_attention_cuda(q, k, v, **kw)
    torch.cuda.synchronize()
    want = ref.flash_attention_ref(q, k, v, **kw)
    assert (out.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("d", [1024, 2048, 4096])
def test_rmsnorm_kernel_at_ssm_decode_rows_on_card(cuda_device, dtype, d):
    """The SSM decode step's rows: 8 lanes at mamba2's d_model and d_inner
    (1024, 2048) and zamba2's (2048, 4096)."""
    g = torch.Generator(device=cuda_device).manual_seed(d)
    x = (torch.randn(8, 1, d, generator=g, device=cuda_device) * 3).to(dtype)
    w = torch.randn(d, generator=g, device=cuda_device).to(dtype)
    out = rmsnorm_cuda(x, w, 1e-5).float()
    torch.cuda.synchronize()
    want = ref.rmsnorm_ref(x, w, 1e-5).float()
    tol = TOL[dtype] if dtype == torch.float32 else torch.exp2(torch.floor(
        torch.log2(want.abs().clamp_min(1e-30))) - 7)
    assert bool(((out - want).abs() <= tol).all())


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_ssd_scan_forward_at_zamba2_width_on_card(cuda_device, dtype):
    """The forward at zamba2's H 64, P 64, N 64 (one B/C group), 600
    tokens: ragged against the 64-token chunk."""
    leaves, views = ssd_inputs(1, 600, 64, 64, 64, cuda_device, dtype)
    args = [t.detach() for t in views(*leaves)]
    y = ssd_scan_cuda(*args, 64)
    torch.cuda.synchronize()
    if dtype == torch.bfloat16:
        assert _rel_err(y, ref.ssd_scan_ref(*args, 64)) <= REL_TOL[dtype]
        return
    y64 = ref.ssd_scan_ref(*(t.double() for t in args), 64)
    tol = max(REL_TOL[dtype], 2 * _rel_err(ref.ssd_scan_ref(*args, 64), y64))
    assert _rel_err(y, y64) <= tol


def _ssm_configs(arch):
    from repro_torch.configs import get_config
    cfg = get_config(arch).reduced().with_(dtype=torch.float32)
    return cfg.with_(n_layers=5) if cfg.attn_every else cfg


@pytest.mark.gpu
def test_ssm_block_decode_on_card_matches_cpu(cuda_device):
    """One reduced fp32 mamba2 layer, 10 tokens on 3 lanes: the output and
    the state written in place, on the card against the CPU."""
    from repro_torch.models.ssm import (init_ssm, init_ssm_state,
                                        ssm_block_decode)
    cfg = _ssm_configs("mamba2-370m")
    p_cpu = init_ssm(cfg, generator=torch.Generator().manual_seed(0),
                     device=torch.device("cpu"))
    p_gpu = copy.deepcopy(p_cpu).to(cuda_device)
    states = {dev: init_ssm_state(cfg, 3, device=dev)
              for dev in ("cpu", cuda_device)}
    xs = torch.randn(3, 10, cfg.d_model, generator=torch.Generator()
                     .manual_seed(1))
    for t in range(10):
        with torch.inference_mode():
            want, _ = ssm_block_decode(p_cpu, xs[:, t:t + 1], states["cpu"],
                                       cfg)
            got, _ = ssm_block_decode(p_gpu, xs[:, t:t + 1].to(cuda_device),
                                      states[cuda_device], cfg)
        torch.cuda.synchronize()
        assert _rel_err(got.cpu(), want) <= REL_TOL[torch.float32], f"t={t}"
        for name in ("ssm", "conv"):
            assert _rel_err(states[cuda_device][name].cpu(),
                            states["cpu"][name]) <= REL_TOL[torch.float32]


@pytest.mark.gpu
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_ssm_serve_on_card_token_identical_to_cpu(cuda_device, arch):
    """Reduced fp32 ``serve`` (zamba2 at 5 layers), 5 requests on 2 lanes,
    so three are served on recycled lanes: the same greedy tokens on the
    card and on the CPU from the same weights, every kernel launched on the
    card (flash only for the hybrid's shared block)."""
    from repro_torch.launch.serve import Request, serve
    from repro_torch.models import init_lm
    cfg = _ssm_configs(arch)
    params_cpu = init_lm(cfg, seed=0, device="cpu")
    params_gpu = copy.deepcopy(params_cpu).to(cuda_device)
    rng = np.random.default_rng(3)
    spec = [(rng.integers(0, cfg.vocab_size, int(rng.integers(2, 12))
                          ).tolist(), int(rng.integers(3, 8)))
            for _ in range(5)]
    tokens = {}
    for dev, params in (("cpu", params_cpu), (cuda_device, params_gpu)):
        reqs = [Request(i, p, n) for i, (p, n) in enumerate(spec)]
        flash, norm = flash_attention_cuda.launches, rmsnorm_cuda.launches
        serve(cfg, reqs, 2, 32, verbose=False, device=dev, params=params)
        tokens[str(dev)] = [r.generated for r in reqs]
    assert tokens["cpu"] == tokens[str(cuda_device)]
    assert rmsnorm_cuda.launches > norm
    assert (flash_attention_cuda.launches > flash) == bool(cfg.attn_every)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype,G", [(torch.float32, 1), (torch.float32, 2),
                                     (torch.bfloat16, 1),
                                     (torch.bfloat16, 2)],
                         ids=["float32-G1", "float32-G2", "bfloat16-G1",
                              "bfloat16-G2"])
def test_ssd_scan_backward_gives_the_same_bits_twice_on_card(cuda_device,
                                                             dtype, G):
    """Each head's dB and dC terms are written once and summed over a
    group's heads in a fixed order (no atomics): a second call gives the
    same bits, so training steps repeat."""
    leaves, views = ssd_inputs(2, 1024, 8, 64, 128, cuda_device, dtype,
                               groups=G, seed=4)
    dy = torch.randn(2, 1024, 8, 64, device=cuda_device).to(dtype)
    first = torch.autograd.grad(SSDScan.apply(*views(*leaves), 64), leaves,
                                dy)
    again = torch.autograd.grad(SSDScan.apply(*views(*leaves), 64), leaves,
                                dy)
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC"), first, again):
        assert torch.equal(a, b), name


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
def test_flash_backward_at_kimi_heads_gives_the_same_bits_twice_on_card(
        cuda_device, dtype):
    """Kimi-k2's heads (H 64, KV 8, dh 112: tiles padded to 128 columns):
    the forward, its row log-sum-exp and the backward against their plain
    versions, and a second backward call the same bits."""
    g = torch.Generator(device=cuda_device).manual_seed(12)
    q, do = (torch.randn(1, 300, 64, 112, generator=g,
                         device=cuda_device).to(dtype) for _ in range(2))
    k, v = (torch.randn(1, 300, 8, 112, generator=g,
                        device=cuda_device).to(dtype) for _ in range(2))
    out, lse = flash_attention_cuda(q, k, v, with_lse=True)
    assert (out.float() - ref.flash_attention_ref(q, k, v).float()
            ).abs().max().item() <= TOL[dtype]
    assert (lse - ref.flash_attention_lse_ref(q, k, v)).abs().max().item() \
        <= TOL[dtype]
    first = flash_attention_bwd_cuda(q, k, v, out, do, lse)
    want = ref.flash_attention_bwd_ref(q, k, v, out, do, lse)
    for a, b in zip(first, want):
        assert _rel_err(a, b) <= REL_TOL[dtype]
    again = flash_attention_bwd_cuda(q, k, v, out, do, lse)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def _whisper(dtype=torch.float32):
    from repro_torch.configs import get_config
    return get_config("whisper-medium").reduced().with_(dtype=dtype)


@pytest.mark.gpu
def test_encdec_serving_on_card_matches_cpu(cuda_device):
    """Reduced fp32 whisper-medium from the same weights on the card and
    on the CPU: ``make_prefill_step`` logits within 1e-4 of the largest,
    then 8 steps of ``make_serve_step`` with the same greedy tokens, every
    attention (encoder, decoder, cross-attention at S != T, the decode
    step's cache) through the flash kernel on the card."""
    from repro_torch.models import init_encdec, init_encdec_decode_state
    from repro_torch.runtime.executor import make_prefill_step, \
        make_serve_step
    cfg = _whisper()
    params_cpu = init_encdec(cfg, max_dec_len=64, seed=0, device="cpu")
    params_gpu = copy.deepcopy(params_cpu).to(cuda_device)
    rng = np.random.default_rng(8)
    frames = torch.from_numpy(rng.standard_normal(
        (2, cfg.encoder_seq, cfg.d_model), np.float32))
    tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9)
                                           ).astype(np.int32))
    logits, greedy = {}, {}
    for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        launches = flash_attention_cuda.launches
        logits[dev] = make_prefill_step(cfg)(params, {
            "tokens": tokens.to(dev), "frames": frames.to(dev)}).cpu()
        state = init_encdec_decode_state(params, frames.to(dev), cfg, 16)
        step, tok, out = make_serve_step(cfg), tokens[:, 0].to(dev), []
        for _ in range(8):
            lg, state = step(params, state, tok)
            tok = lg.argmax(-1).to(torch.int32)
            out.append(tok.cpu())
        greedy[dev] = torch.stack(out)
        flash = flash_attention_cuda.launches - launches
        L, E = cfg.n_layers, cfg.n_enc_layers
        assert flash == ((2 * E + 2 * L) + 8 * 2 * L if dev == "cuda"
                         else 0)
    assert _rel_err(logits["cuda"], logits["cpu"]) <= 1e-4
    assert torch.equal(greedy["cuda"], greedy["cpu"])


@pytest.mark.gpu
@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_encdec_training_on_card_matches_cpu(cuda_device, remat):
    """Reduced fp32 whisper-medium from the same weights: three
    ``make_train_step`` steps on the card and on the CPU, losses within
    1e-4; on the card every attention runs the flash kernels both ways,
    the backward once an attention a step (a third of them at S != T,
    cross-attention), and a second loss-and-gradient pass from the same
    weights gives the same bits."""
    from repro_torch.models import encdec_loss, init_encdec
    from repro_torch.optim import adamw_init
    from repro_torch.runtime.executor import make_train_step
    cfg = _whisper()
    params_cpu = init_encdec(cfg, seed=0, device="cpu")
    params_gpu = copy.deepcopy(params_cpu).to(cuda_device)
    rng = np.random.default_rng(9)
    batches = [{"frames": torch.from_numpy(rng.standard_normal(
                    (2, cfg.encoder_seq, cfg.d_model), np.float32)),
                "tokens": torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (2, 40)).astype(np.int32)),
                "labels": torch.from_numpy(rng.integers(
                    0, cfg.vocab_size, (2, 40)).astype(np.int32))}
               for _ in range(3)]
    b0 = {k: v.to(cuda_device) for k, v in batches[0].items()}
    leaves = list(params_gpu.parameters())
    twice = [torch.autograd.grad(encdec_loss(params_gpu, b0, cfg,
                                             remat=remat), leaves)
             for _ in range(2)]
    assert all(torch.equal(a, b) for a, b in zip(*twice))
    step = make_train_step(cfg, remat_segments=[remat])
    losses = {}
    for dev, params in (("cpu", params_cpu), ("cuda", params_gpu)):
        opt = adamw_init(list(params.parameters()))
        n, cross = (flash_attention_bwd_cuda.launches,
                    flash_attention_bwd_cuda.cross_launches)
        losses[dev] = [float(step(params, opt, {k: v.to(dev) for k, v in
                                                b.items()})["loss"])
                       for b in batches]
        n = flash_attention_bwd_cuda.launches - n
        cross = flash_attention_bwd_cuda.cross_launches - cross
        L, E = cfg.n_layers, cfg.n_enc_layers
        assert (n, cross) == ((3 * (E + 2 * L), 3 * L) if dev == "cuda"
                              else (0, 0))
    for a, b in zip(losses["cuda"], losses["cpu"]):
        assert abs(a - b) <= 1e-4 * abs(b)
