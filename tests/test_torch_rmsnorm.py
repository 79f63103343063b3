"""The RMSNorm backward's partition and fixed-order dw sum, on the CPU, and
the wrappers' argument checks.

On the card the backward of ``csrc/rmsnorm.cu`` runs on a persistent grid
of ``kernels/rmsnorm.py::bwd_grid`` CTAs, each taking ``rows_per_cta`` rows
at once.  Up to d 2560 (the register body) that is its warps: warp k of CTA
b takes row ``b * warps + k`` and every ``CTAs * warps``-th row after it,
keeps dw for its columns across its rows, and the warps of a CTA add theirs
in warp order into partials row b.  Past d 2560 (the cta body) a row lies
across a CTA: CTA b takes rows b, b + CTAs, ... in turn, sums dw for its
columns in row order and writes it as partials row b.  Then
``rmsnorm_bwd_dw_sum_kernel`` sums the partials rows column by column: warp
k of its CTA takes rows k, k + SUM_SPLIT, ... in turn, and the SUM_SPLIT
sums meet in a tree.  ``mirror_bwd`` below repeats that order in float64
(SUM_SPLIT read from the source; each row's own sums, which the kernels
take by shuffles and across warps, are taken whole).  It is not part of
the package.

Held in float64 against ``torch.autograd`` of the plain version's formula
(``kernels/ref.py::rmsnorm_ref`` computes in fp32; the same formula in
float64 here) to 1e-12 of each gradient's largest magnitude, and in fp32
against ``jax.vjp`` of the JAX package's ``kernels/ref.py::rmsnorm_ref`` to
1e-5 (fp32 sums in another order; the JAX package has no RMSNorm backward
kernel).  Also: the wrappers refuse what the kernels do not take before any
ctypes call, and their ctypes argument lists match the C signatures.
"""
import ctypes
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro_torch.kernels import _build
from repro_torch.kernels import rmsnorm

torch.set_num_threads(1)

SOURCE = (_build.CSRC / "rmsnorm.cu").read_text()
SUM_SPLIT = int(re.search(r"constexpr int SUM_SPLIT = (\d+);",
                          SOURCE).group(1))
EPS = 1e-5


def plain64(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """``rmsnorm_ref``'s formula without its cast to fp32."""
    var = x.square().mean(dim=-1, keepdim=True)
    return x * torch.rsqrt(var + eps) * w


def row_chunks(n_rows: int, d: int, size: int, seed: int):
    """(first row, x, dy) in float64, ``size`` rows at a time, each chunk
    from its own seed, so that no full (n_rows, d) pair is held at once."""
    for c, lo in enumerate(range(0, n_rows, size)):
        rng = np.random.default_rng([seed, c])
        n = min(size, n_rows - lo)
        yield lo, rng.standard_normal((n, d)) * 2, rng.standard_normal((n, d))


def mirror_bwd(chunks, w: np.ndarray, n_rows: int, rows_per_cta: int,
               n_ctas: int):
    """(dx by chunk, dw, visits per row) in the kernels' partition and
    order.  ``rows_per_cta``: 8 for the register body's warps, 1 for the
    cta body past d 2560, whose CTA b takes rows b, b + n_ctas, ... (a warp
    of the register body takes rows the same way, on its own).  ``chunks``
    must hold n_ctas * rows_per_cta rows each (the last fewer), so that
    their rows belong to distinct warps or CTAs."""
    d, n_takers = w.shape[0], n_ctas * rows_per_cta
    owner = np.full(n_rows, -1)
    visits = np.zeros(n_rows, dtype=int)
    for b in range(n_ctas):
        for k in range(rows_per_cta):
            t = b * rows_per_cta + k        # warp k of CTA b, or CTA b
            owner[t::n_takers] = t
            visits[t::n_takers] += 1
    acc = np.zeros((n_takers, d))           # each one's dw, in row order
    dxs = []
    for lo, x, dy in chunks:
        rows = np.arange(lo, lo + x.shape[0])
        assert len(np.unique(owner[rows])) == len(rows)
        rstd = 1 / np.sqrt((x * x).mean(-1, keepdims=True) + EPS)
        xhat = x * rstd
        c = (xhat * w * dy).mean(-1, keepdims=True)
        dxs.append((w * dy - xhat * c) * rstd)
        acc[owner[rows]] += dy * xhat
    part = np.zeros((n_ctas, d))            # a CTA's warps, in warp order
    for k in range(rows_per_cta):
        part += acc[k::rows_per_cta]
    sums = np.zeros((SUM_SPLIT, d))         # the column sum's warps
    for p in range(n_ctas):
        sums[p % SUM_SPLIT] += part[p]
    h = SUM_SPLIT // 2
    while h:
        sums[:h] += sums[h:2 * h]
        h //= 2
    return dxs, sums[0], visits


def reference(chunks, w: np.ndarray):
    """(dx by chunk, dw) from torch.autograd of ``plain64``, a chunk at a
    time."""
    wt = torch.from_numpy(w).requires_grad_()
    dxs, dw = [], torch.zeros_like(wt)
    for _, x, dy in chunks:
        xt = torch.from_numpy(x).requires_grad_()
        gx, gw = torch.autograd.grad(plain64(xt, wt, EPS), (xt, wt),
                                     torch.from_numpy(dy))
        dxs.append(gx.numpy())
        dw += gw
    return dxs, dw.detach().numpy()


def _check_mirror(n_rows, d, rows_per_cta, n_ctas, seed):
    w = np.random.default_rng(seed).standard_normal(d)
    size = n_ctas * rows_per_cta
    dxs, dw, visits = mirror_bwd(row_chunks(n_rows, d, size, seed), w,
                                 n_rows, rows_per_cta, n_ctas)
    assert np.all(visits == 1)              # every row, exactly once
    ref_dxs, ref_dw = reference(row_chunks(n_rows, d, size, seed), w)
    top = max(np.abs(ref_dw).max(), 1e-300)
    assert np.abs(dw - ref_dw).max() <= 1e-12 * top
    for got, want in zip(dxs, ref_dxs):
        assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


@pytest.mark.parametrize("d", [100, 128, 1024, 2560])
@pytest.mark.parametrize("n_rows", [1, 5, 777, 16387])
def test_bwd_partition_and_dw_order_match_autograd_float64(n_rows, d):
    """The register body's geometry on the H100 (8 warps a CTA, 132 SMs):
    bwd_grid sizes the grid and the partials buffer."""
    warps = 8
    n_ctas = rmsnorm.bwd_grid(n_rows, warps, ctas_per_sm=2, n_sms=132)
    assert 1 <= n_ctas <= 264 and (n_ctas - 1) * warps < n_rows
    _check_mirror(n_rows, d, warps, n_ctas, seed=n_rows + d)


# the cta body's CTAs an SM on the H100 (occupancy API, bf16, 132 SMs):
# rmsnorm_bwd_config's out[1] at each d
CTA_PER_SM = {3000: 5, 4096: 4, 5120: 3, 6144: 2, 7168: 2, 8192: 2}


@pytest.mark.parametrize("n_rows,d", [
    (777, 3000), (40, 4096), (1000, 4096), (401, 5120), (4352 // 8, 6144),
    (269, 6144), (531, 7168), (3, 8192), (600, 8192)])
def test_bwd_partition_of_the_wide_kernel(n_rows, d):
    """The cta body past d 2560: a row across a CTA, the grid from
    bwd_grid (one row a CTA at once, a few CTAs an SM), so a CTA takes
    ceil or floor of rows / CTAs rows (n_rows > CTAs) or one (fewer)."""
    n_ctas = rmsnorm.bwd_grid(n_rows, 1, CTA_PER_SM[d], n_sms=132)
    assert n_ctas == min(n_rows, CTA_PER_SM[d] * 132)
    _check_mirror(n_rows, d, 1, n_ctas, seed=n_rows + d)


@pytest.mark.parametrize("n_rows,d", [(100, 6144), (5, 8192), (1, 3000)])
def test_wide_mirror_with_idle_ctas(n_rows, d):
    """A grid of the card's capacity over fewer rows (the C entry takes any
    n_ctas): the CTAs past the rows take none and write zero partials
    rows, which leave dw as it is."""
    n_ctas = CTA_PER_SM[d] * 132
    assert n_ctas > n_rows
    _check_mirror(n_rows, d, 1, n_ctas, seed=n_rows + d)


@pytest.mark.parametrize("n_rows,rows_per_cta,per_sm,sms,want", [
    (0, 8, 2, 132, 0), (1, 8, 2, 132, 1), (7, 8, 1, 132, 1),
    (9, 8, 1, 132, 2), (16384, 8, 2, 132, 264), (16384, 8, 1, 132, 132),
    (100, 1, 32, 132, 100),
    # the cta body past d 2560: a row a CTA at once
    (4352, 1, 2, 132, 264), (4096, 1, 3, 132, 396), (4096, 1, 4, 132, 528),
    (8, 1, 2, 132, 8), (264, 1, 2, 132, 264), (265, 1, 2, 132, 264),
    (0, 1, 2, 132, 0)])
def test_bwd_grid_edges(n_rows, rows_per_cta, per_sm, sms, want):
    """No CTA that would take no row; never more than the card holds at
    once; none at all for no rows (the wrapper then launches nothing)."""
    assert rmsnorm.bwd_grid(n_rows, rows_per_cta, per_sm, sms) == want


@pytest.mark.parametrize("n_rows,n_ctas", [(1, 4), (3, 2), (0, 1)])
def test_bwd_mirror_with_idle_ctas(n_rows, n_ctas):
    """More CTAs than rows (idle warps add zeros), and no rows (dw is an
    empty sum: zeros)."""
    d = 64
    w = np.random.default_rng(1).standard_normal(d)
    dxs, dw, visits = mirror_bwd(row_chunks(n_rows, d, n_ctas * 8, 1), w,
                                 n_rows, 8, n_ctas)
    assert np.all(visits == 1)
    if n_rows == 0:
        assert not dw.any() and dxs == []
    else:
        _, ref_dw = reference(row_chunks(n_rows, d, n_ctas * 8, 1), w)
        assert np.abs(dw - ref_dw).max() <= 1e-12 * np.abs(ref_dw).max()


def test_bwd_mirror_matches_jax_vjp_fp32():
    """The mirror's formulas against jax.vjp of the JAX package's plain
    RMSNorm, on the same inputs in fp32."""
    n_rows, d = 37, 256
    (_, x, dy), = row_chunks(n_rows, d, n_rows, seed=5)
    w = np.random.default_rng(5).standard_normal(d)
    dxs, dw, _ = mirror_bwd(iter([(0, x, dy)]), w, n_rows, 8, 5)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    _, vjp = jax.vjp(lambda a, b: jax_rmsnorm_ref(a, b, EPS), f32(x), f32(w))
    jdx, jdw = (np.asarray(g, np.float64) for g in vjp(f32(dy)))
    for got, want in ((dxs[0], jdx), (dw, jdw)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_wide_mirror_matches_jax_vjp_fp32():
    """The cta body's partition at d 6144 (a row across a CTA, two CTAs an
    SM) against jax.vjp of the JAX package's plain RMSNorm in fp32."""
    n_rows, d = 37, 6144
    (_, x, dy), = row_chunks(n_rows, d, n_rows, seed=6)
    w = np.random.default_rng(6).standard_normal(d)
    n_ctas = rmsnorm.bwd_grid(n_rows, 1, CTA_PER_SM[d], 132)
    dxs, dw, visits = mirror_bwd(iter([(0, x, dy)]), w, n_rows, 1, n_ctas)
    assert np.all(visits == 1)
    f32 = lambda a: jnp.asarray(a, jnp.float32)  # noqa: E731
    _, vjp = jax.vjp(lambda a, b: jax_rmsnorm_ref(a, b, EPS), f32(x), f32(w))
    jdx, jdw = (np.asarray(g, np.float64) for g in vjp(f32(dy)))
    for got, want in ((dxs[0], jdx), (dw, jdw)):
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def _refuse_ctypes():
    raise AssertionError("the wrapper reached the CUDA library")


@pytest.mark.parametrize("call,match", [
    (lambda: rmsnorm.rmsnorm_cuda(torch.randn(4, 64), torch.ones(64)),
     "CUDA device"),
    (lambda: rmsnorm.rmsnorm_cuda(torch.randn(4, 64), torch.ones(63)),
     "shapes"),
    (lambda: rmsnorm.rmsnorm_cuda(torch.randn(4, 64).half(),
                                  torch.ones(64).half()),
     "float32 or bfloat16"),
    (lambda: rmsnorm.rmsnorm_bwd_cuda(torch.randn(4, 64), torch.randn(4, 64),
                                      torch.ones(64)), "CUDA device"),
    (lambda: rmsnorm.rmsnorm_bwd_cuda(torch.randn(4, 63), torch.randn(4, 64),
                                      torch.ones(64)), "shapes"),
    (lambda: rmsnorm.rmsnorm_bwd_cuda(torch.randn(4, 64).bfloat16(),
                                      torch.randn(4, 64), torch.ones(64)),
     "float32 or bfloat16"),
    (lambda: rmsnorm.rmsnorm_bwd_cuda(torch.randn(4, 64).half(),
                                      torch.randn(4, 64).half(),
                                      torch.ones(64)),
     "float32 or bfloat16")],
    ids=["fwd-cpu", "fwd-w-shape", "fwd-float16", "bwd-cpu", "bwd-dy-shape",
         "bwd-dy-dtype", "bwd-float16"])
def test_wrappers_refuse_before_any_ctypes_call(monkeypatch, call, match):
    monkeypatch.setattr(rmsnorm, "_lib", _refuse_ctypes)
    monkeypatch.setattr(rmsnorm, "_bwd_config", _refuse_ctypes)
    monkeypatch.setattr(rmsnorm, "_fwd_config", _refuse_ctypes)
    launches = (rmsnorm.rmsnorm_cuda.launches,
                rmsnorm.rmsnorm_bwd_cuda.launches)
    with pytest.raises(ValueError, match=match):
        call()
    assert (rmsnorm.rmsnorm_cuda.launches,
            rmsnorm.rmsnorm_bwd_cuda.launches) == launches


@pytest.mark.parametrize("entry,argtypes", [
    ("rmsnorm_fwd", rmsnorm.FWD_ARGTYPES),
    ("rmsnorm_fwd_config", rmsnorm.CONFIG_ARGTYPES),
    ("rmsnorm_bwd_config", rmsnorm.CONFIG_ARGTYPES),
    ("rmsnorm_bwd", rmsnorm.BWD_ARGTYPES)])
def test_rmsnorm_binding_matches_the_c_signature(entry, argtypes):
    """One ctypes entry per parameter of the C launcher: pointers and the
    stream as c_void_p (a short list shifts every argument), int as c_int,
    float as c_float, int* as a pointer to c_int."""
    sig = re.search(rf'extern "C" int {entry}\((.*?)\)', SOURCE,
                    re.S).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert len(params) == len(argtypes)
    for p, t in zip(params, argtypes):
        if p.startswith("int*"):
            assert t == ctypes.POINTER(ctypes.c_int), p
        elif "*" in p:
            assert t is ctypes.c_void_p, p
        elif p.startswith("float"):
            assert t is ctypes.c_float, p
        else:
            assert p.startswith("int") and t is ctypes.c_int, p
