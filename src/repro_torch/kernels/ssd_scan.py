"""Mamba2 SSD scan on Hopper: the ctypes wrappers of ``csrc/ssd_scan.cu``
and the autograd Function around them.

Replaces the TPU kernel ``repro/kernels/ssd_scan.py::ssd_scan``
(``_ssd_kernel``): the chunked state-space-dual scan with an fp32 (P, N)
state carried across chunks.  The TPU kernel has only a forward; the JAX
package differentiates its plain version.  Here the backward is a kernel
too, so training on the card never runs the plain version.  The CUDA source
says what bounds each kernel on the H100 and how the design answers that.

``Bm``/``Cm`` hold G groups, G dividing the H heads; head h reads group
``h // (H // G)``.  ``models/ssm.py`` passes one group for all heads, as a
(B,S,1,N) view of its projection: the kernels take strides, so no copy is
made.  The backward writes each head's dB and dC terms in fp32, which
:func:`ssd_scan_bwd_cuda` sums over the heads of a group in a fixed order
and rounds once to x's dtype: no atomics, the same bits on every run.
``S`` need not be a multiple of the chunk; the kernels mask the tail,
which equals the zero padding of the plain version.

:func:`ssd_scan_cuda` and :func:`ssd_scan_bwd_cuda` only launch a kernel;
``kernels/ops.py`` routes CUDA tensors through :class:`SSDScan` and CPU
tensors to ``kernels/ref.py::ssd_scan_ref``.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_CHUNK, MAX_HEAD_DIM, MAX_STATE = 64, 64, 128
_STRIDES = ctypes.c_longlong * 19

# ssd_scan_fwd(x, dt, A, Bm, Cm, y, work, B, S, H, G, P, N, Q, dtype,
#              strides, stream)
FWD_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 8
                + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])
# ssd_scan_bwd(x, dt, A, Bm, Cm, dy, dx, ddt, da_part, dB, dC, states,
#              work, B, S, H, G, P, N, Q, dtype, strides, stream)
BWD_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 8
                + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = _build.load("ssd_scan")
    for fn, argtypes in ((lib.ssd_scan_fwd, FWD_ARGTYPES),
                         (lib.ssd_scan_bwd, BWD_ARGTYPES)):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _check(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
           Bm: torch.Tensor, Cm: torch.Tensor, chunk: int) -> int:
    """Raise on what the kernels do not take; return the chunk length."""
    if x.dim() != 4:
        raise ValueError(f"x must be (B,S,H,P); got {tuple(x.shape)}")
    B, S, H, P = x.shape
    G, N = Bm.shape[-2:]
    tensors = dict(x=x, dt=dt, A=A, Bm=Bm, Cm=Cm)
    if not all(t.is_cuda and t.device == x.device for t in tensors.values()):
        raise ValueError("ssd_scan_cuda needs every input on one CUDA "
                         "device; got " + ", ".join(
                             f"{k} on {t.device}" for k, t in tensors.items()))
    if (dt.shape != (B, S, H) or A.shape != (H,) or G == 0 or H % G
            or Bm.shape != (B, S, G, N) or Cm.shape != Bm.shape):
        raise ValueError(f"shapes x={tuple(x.shape)} dt={tuple(dt.shape)} "
                         f"A={tuple(A.shape)} Bm={tuple(Bm.shape)} "
                         f"Cm={tuple(Cm.shape)} do not fit (B,S,H,P), "
                         "(B,S,H), (H,), (B,S,G,N), (B,S,G,N) with G "
                         "dividing H")
    if x.dtype not in _DTYPES or Bm.dtype != x.dtype or Cm.dtype != x.dtype:
        raise ValueError(f"x, Bm and Cm must share float32 or bfloat16; got "
                         f"{x.dtype}, {Bm.dtype}, {Cm.dtype}")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise ValueError(f"dt and A must be float32; got {dt.dtype}, "
                         f"{A.dtype}")
    Q = min(chunk, S)
    if not (0 < Q <= MAX_CHUNK and 0 < P <= MAX_HEAD_DIM
            and 0 < N <= MAX_STATE):
        raise ValueError(f"unsupported sizes chunk={chunk} P={P} N={N} "
                         f"(the kernels take chunk <= {MAX_CHUNK}, head dim "
                         f"<= {MAX_HEAD_DIM}, state <= {MAX_STATE})")
    return Q


def _strides(x, dt, Bm, Cm, dy=None):
    return _STRIDES(*x.stride(), *dt.stride(), *Bm.stride(), *Cm.stride(),
                    *(dy.stride() if dy is not None else (0, 0, 0, 0)))


def _raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")


def ssd_scan_cuda(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                  Bm: torch.Tensor, Cm: torch.Tensor,
                  chunk: int = 64) -> torch.Tensor:
    """Launch the forward: x (B,S,H,P), dt (B,S,H) fp32, A (H,) fp32,
    Bm/Cm (B,S,G,N) in x's dtype (any strides) -> y (B,S,H,P) in x's
    dtype.  fp32 inputs run one kernel; bf16 inputs run three,
    chunk-parallel on tensor cores, with fp32 scratch for the chunk-start
    states and the chunk decays (B*H*nc*(P*N + 1) floats, freed on return).
    Raises on other inputs or a failed launch."""
    Q = _check(x, dt, A, Bm, Cm, chunk)
    B, S, H, P = x.shape
    G, N = Bm.shape[-2:]
    A = A.contiguous()
    y = torch.empty(x.shape, dtype=x.dtype, device=x.device)
    if y.numel() == 0:
        return y
    nc = -(-S // Q)
    work = (torch.empty(B * H * nc * (P * N + 1), dtype=torch.float32,
                        device=x.device)
            if x.dtype == torch.bfloat16 else None)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = _lib().ssd_scan_fwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), y.data_ptr(),
            None if work is None else work.data_ptr(), B, S, H, G, P, N, Q,
            _DTYPES[x.dtype], _strides(x, dt, Bm, Cm), stream)
    _raise_on(err, "ssd_scan forward")
    ssd_scan_cuda.launches += 1
    return y


ssd_scan_cuda.launches = 0


def ssd_scan_bwd_cuda(dy: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
                      A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor,
                      chunk: int = 64) -> Tuple[torch.Tensor, ...]:
    """Launch the backward kernels: the gradients (dx, ddt, dA, dB, dC) of
    ``sum(y * dy)``.  dB and dC have Bm's shape (B,S,G,N) and x's dtype:
    the kernels write each head's fp32 terms, (B,S,H,N), which are summed
    here over the heads of each group in a fixed order and rounded once.  fp32 inputs run one kernel, whose fp32 dA partials are per
    (batch, head); bf16 inputs run three, chunk-parallel on tensor cores,
    whose partials are per (batch, head, chunk).  dA is their sum over the
    batch (and the chunks) in a fixed order."""
    Q = _check(x, dt, A, Bm, Cm, chunk)
    B, S, H, P = x.shape
    G, N = Bm.shape[-2:]
    if dy.shape != x.shape or dy.dtype != x.dtype or dy.device != x.device:
        raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} on {dy.device} "
                         f"does not match x {tuple(x.shape)} {x.dtype}")
    A = A.contiguous()
    dev = x.device
    nc = -(-S // Q)
    bf16 = x.dtype == torch.bfloat16
    dx = torch.empty(x.shape, dtype=x.dtype, device=dev)
    ddt = torch.empty(B, S, H, dtype=torch.float32, device=dev)
    da_part = torch.empty((B, H, nc) if bf16 else (B, H),
                          dtype=torch.float32, device=dev)
    # every element is written by the kernels
    dB = torch.empty(B, S, H, N, dtype=torch.float32, device=dev)
    dC = torch.empty(B, S, H, N, dtype=torch.float32, device=dev)

    def by_group(t: torch.Tensor) -> torch.Tensor:
        return t.view(B, S, G, H // G, N).sum(3).to(x.dtype)

    if x.numel() == 0:
        return (dx, ddt, torch.zeros_like(A),
                torch.zeros(Bm.shape, dtype=x.dtype, device=dev),
                torch.zeros(Cm.shape, dtype=x.dtype, device=dev))
    # the chunk-start states; for bf16 also the end-state gradients and
    # the chunk decays
    states = torch.empty(B * H * nc * P * N, dtype=torch.float32, device=dev)
    work = (torch.empty(B * H * nc * (P * N + 1), dtype=torch.float32,
                        device=dev) if bf16 else None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _lib().ssd_scan_bwd(
            x.data_ptr(), dt.data_ptr(), A.data_ptr(), Bm.data_ptr(),
            Cm.data_ptr(), dy.data_ptr(), dx.data_ptr(), ddt.data_ptr(),
            da_part.data_ptr(), dB.data_ptr(), dC.data_ptr(),
            states.data_ptr(), None if work is None else work.data_ptr(),
            B, S, H, G, P, N, Q, _DTYPES[x.dtype],
            _strides(x, dt, Bm, Cm, dy), stream)
    _raise_on(err, "ssd_scan backward")
    ssd_scan_bwd_cuda.launches += 1
    dA = da_part.sum(2).sum(0) if bf16 else da_part.sum(0)
    return dx, ddt, dA, by_group(dB), by_group(dC)


ssd_scan_bwd_cuda.launches = 0


class SSDScan(torch.autograd.Function):
    """y = ssd_scan(x, dt, A, Bm, Cm, chunk) with both directions on the
    card.  Saves its inputs (views included, uncopied), not the forward's
    chunk-start states: the backward kernels recompute them."""

    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        ctx.save_for_backward(x, dt, A, Bm, Cm)
        ctx.chunk = chunk
        return ssd_scan_cuda(x, dt, A, Bm, Cm, chunk)

    @staticmethod
    def backward(ctx, dy):
        x, dt, A, Bm, Cm = ctx.saved_tensors
        dx, ddt, dA, dB, dC = ssd_scan_bwd_cuda(dy, x, dt, A, Bm, Cm,
                                                ctx.chunk)
        return dx, ddt, dA, dB, dC, None
