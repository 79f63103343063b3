"""RMSNorm on Hopper: the ctypes wrappers of ``csrc/rmsnorm.cu`` and the
autograd Function around them.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm``
(``_rmsnorm_kernel``): ``y = x * rsqrt(mean(x^2) + eps) * w`` over the last
dim with fp32 accumulation, cast back to x's dtype, over rows = the product
of the leading dims.  The backward has no TPU counterpart (the JAX package
differentiates the plain version): ``dx = rstd * (w*dy - xhat *
mean(xhat*w*dy))`` and ``dw = sum over rows of dy*xhat``, in fp32, with
``xhat = x*rstd`` and rstd recomputed from x.  x and w are each float32 or
bfloat16; dx takes x's dtype and dw w's.

The backward runs on a persistent grid whose size :func:`bwd_grid` gives:
up to 2560 columns a warp takes a row, past that a row lies across a CTA.
Each CTA writes one row of an fp32 partials buffer and a second kernel sums
the rows in a fixed order, so dw is the same on every run.  The CUDA source
says what bounds each kernel on the H100 and how the design answers that.

:func:`rmsnorm_cuda` and :func:`rmsnorm_bwd_cuda` only launch kernels;
``kernels/ops.py`` routes CUDA tensors through :class:`RMSNorm` and CPU
tensors to ``kernels/ref.py::rmsnorm_ref``.  The forward's wrapper is kept
lean, since the decode step calls it 145 times and is bound by the host.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# rmsnorm_fwd(x, w, y, n_rows, d, x_dtype, w_dtype, eps, device, stream)
FWD_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
# rmsnorm_fwd_config and rmsnorm_bwd_config(d, x_dtype, device, out)
CONFIG_ARGTYPES = [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)]
# rmsnorm_bwd(x, w, dy, dx, part, dw, n_rows, d, x_dtype, w_dtype, eps,
#             n_ctas, device, stream)
BWD_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 4
                + [ctypes.c_float, ctypes.c_int, ctypes.c_int,
                   ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("rmsnorm")
    for fn, argtypes in ((lib.rmsnorm_fwd, FWD_ARGTYPES),
                         (lib.rmsnorm_fwd_config, CONFIG_ARGTYPES),
                         (lib.rmsnorm_bwd_config, CONFIG_ARGTYPES),
                         (lib.rmsnorm_bwd, BWD_ARGTYPES)):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(fn: str, x: torch.Tensor, w: torch.Tensor,
           dy: Optional[torch.Tensor] = None) -> None:
    """Raise ValueError on what the kernels do not take: w not (d,), dy not
    x's shape or dtype, a dtype other than float32 or bfloat16, or tensors
    not on one CUDA device.  One cheap test first: the decode step calls
    this 145 times."""
    i = x.get_device()          # -1 on the CPU
    if (i >= 0 and w.get_device() == i and x.dtype in _DTYPES
            and w.dtype in _DTYPES and w.dim() == 1
            and w.shape[0] == x.shape[-1]
            and (dy is None or (dy.get_device() == i and dy.dtype == x.dtype
                                and dy.shape == x.shape))):
        return
    d = x.shape[-1]
    if w.shape != (d,) or (dy is not None and dy.shape != x.shape):
        raise ValueError(f"{fn}: shapes x={tuple(x.shape)} w="
                         f"{tuple(w.shape)} dy="
                         f"{None if dy is None else tuple(dy.shape)} do not "
                         "fit (..., d), (d,), x's")
    if x.dtype not in _DTYPES or w.dtype not in _DTYPES \
            or (dy is not None and dy.dtype != x.dtype):
        raise ValueError(f"{fn}: x and w must be float32 or bfloat16 and dy "
                         f"x's dtype; got x {x.dtype}, w {w.dtype}, dy "
                         f"{None if dy is None else dy.dtype}")
    raise ValueError(f"{fn} needs its tensors on one CUDA device; got x on "
                     f"{x.device}, w on {w.device}"
                     + ("" if dy is None else f", dy on {dy.device}"))


# PyTorch's raw getter of the current stream (the one Triton's launcher
# uses) takes about 0.1 us a call on an H100 host, where
# torch.cuda.current_stream(device).cuda_stream takes 4-6 us; a build
# without it (the CPU build) gets the public path
_RAW_STREAM = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _stream(device: int) -> int:
    """The current CUDA stream of ``device`` as a raw handle."""
    if _RAW_STREAM is not None:
        return _RAW_STREAM(device)
    return torch.cuda.current_stream(device).cuda_stream


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Launch the forward kernel: x (..., d), w (d,) on one CUDA device.

    Raises ValueError for CPU tensors, mismatched shapes or other dtypes,
    and RuntimeError if the launch fails; never computes on another path."""
    _check("rmsnorm_cuda", x, w)
    x = x.contiguous()
    y = torch.empty_like(x)         # contiguous, x's shape: no reshapes
    n = y.numel()
    if not n:
        return y
    d = x.shape[-1]
    err = _lib().rmsnorm_fwd(
        x.data_ptr(), w.contiguous().data_ptr(), y.data_ptr(), n // d, d,
        _DTYPES[x.dtype], _DTYPES[w.dtype], eps, x.get_device(),
        _stream(x.get_device()))
    if err:
        raise RuntimeError(f"rmsnorm forward launch failed: CUDA error {err}")
    rmsnorm_cuda.launches += 1
    return y


rmsnorm_cuda.launches = 0


def bwd_grid(n_rows: int, rows_per_cta: int, ctas_per_sm: int,
             n_sms: int) -> int:
    """CTAs of the backward's persistent grid, and rows of its (CTAs, d)
    fp32 partials buffer: as many as the card holds at once, but none that
    would take no row.  A CTA takes ``rows_per_cta`` rows at once: up to d
    2560 its warps (warp k of CTA b takes row ``b * warps + k`` and every
    ``CTAs * warps``-th row after it), past that 1 (CTA b takes rows b,
    b + CTAs, ...: a row lies across its threads).  CTA b writes partials
    row b."""
    return min(ctas_per_sm * n_sms, -(-n_rows // rows_per_cta))


@functools.lru_cache(maxsize=None)
def _fwd_config(device: int, d: int, x_dtype: int) -> Tuple[int, int]:
    """(threads a CTA, CTAs an SM) of the forward's cta body for d past
    2560, for aligned rows with w in x's dtype; (0, 0) where it does not
    take d.  The forward finds these itself; this reports them."""
    out = (ctypes.c_int * 2)()
    err = _lib().rmsnorm_fwd_config(d, x_dtype, device, out)
    if err:
        raise RuntimeError(f"rmsnorm forward configuration failed: CUDA "
                           f"error {err}")
    return out[0], out[1]


@functools.lru_cache(maxsize=None)
def _bwd_config(device: int, d: int,
                x_dtype: int) -> Tuple[int, int, int, int]:
    """(rows a CTA takes at once, CTAs an SM, SMs, threads a CTA) of the
    backward kernel for d."""
    out = (ctypes.c_int * 4)()
    err = _lib().rmsnorm_bwd_config(d, x_dtype, device, out)
    if err:
        raise RuntimeError(f"rmsnorm backward configuration failed: CUDA "
                           f"error {err}")
    return out[0], out[1], out[2], out[3]


def rmsnorm_bwd_cuda(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                     eps: float = 1e-6):
    """Launch the backward kernels: the gradients (dx, dw) of
    ``sum(rmsnorm(x, w) * dy)``, dx in x's dtype and dw in w's.  Raises
    like :func:`rmsnorm_cuda`."""
    _check("rmsnorm_bwd_cuda", x, w, dy)
    d = x.shape[-1]
    if not x.numel():       # no rows, or no columns: dw is an empty sum
        return torch.empty_like(x), torch.zeros(d, dtype=w.dtype,
                                                device=w.device)
    x2 = x.reshape(-1, d).contiguous()
    dy2 = dy.reshape(-1, d).contiguous()
    dx = torch.empty_like(x2)
    n_rows = x2.shape[0]
    dw = torch.empty(d, dtype=w.dtype, device=w.device)
    n_ctas = bwd_grid(n_rows, *_bwd_config(x.get_device(), d,
                                           _DTYPES[x.dtype])[:3])
    part = torch.empty(n_ctas, d, dtype=torch.float32, device=x.device)
    err = _lib().rmsnorm_bwd(
        x2.data_ptr(), w.contiguous().data_ptr(), dy2.data_ptr(),
        dx.data_ptr(), part.data_ptr(), dw.data_ptr(), n_rows, d,
        _DTYPES[x.dtype], _DTYPES[w.dtype], eps, n_ctas, x.get_device(),
        _stream(x.get_device()))
    if err:
        raise RuntimeError(f"rmsnorm backward launch failed: CUDA error "
                           f"{err}")
    rmsnorm_bwd_cuda.launches += 1
    return dx.reshape(x.shape), dw


rmsnorm_bwd_cuda.launches = 0


class RMSNorm(torch.autograd.Function):
    """rmsnorm(x, w, eps) with both directions in the CUDA kernels.  Saves
    x and w; the backward recomputes rstd."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm_cuda(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd_cuda(dy, x, w, ctx.eps)
        return dx, dw, None
