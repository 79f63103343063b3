"""Flash attention on Hopper: the ctypes wrapper of ``csrc/flash_attention.cu``.

Replaces the TPU kernel ``repro/kernels/flash_attention.py::flash_attention``
(``_flash_kernel``): blocked GQA attention with an online softmax, causal and
sliding-window masks, ragged lengths, rows with no admissible key as exact
zeros.  Beyond the TPU kernel it takes per-lane ``q_offset`` and ``kv_len``
(int32, one per lane), so the paged serving path runs chunked prefill and
one-token decode through it.

The source holds two hand-written bodies, chosen by dtype.  bf16 runs on
Hopper's tensor cores: the G query heads of one KV head packed into the
rows of one CTA, K/V tiles by TMA, Q K^T and P V by ``wgmma``, with P split
into two bf16 terms so that P V keeps the reference's fp32 P.  fp32 keeps
the first version's exact FMA loops.  The CUDA source says what bounds each
on the H100 and how the design answers that.

:func:`flash_attention_cuda` only launches the kernel; ``kernels/ops.py``
picks it for CUDA tensors and ``kernels/ref.py::flash_attention_ref`` for
CPU tensors.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import torch

from . import _build

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (64, 128)


def _validate_attn_shapes(S: int, T: int, H: int, KV: int,
                          window: Optional[int]) -> None:
    """Reject genuinely unsupported shapes with descriptive errors (the
    same checks as the TPU kernel's)."""
    if KV <= 0 or H % KV != 0:
        raise ValueError(
            f"GQA requires n_heads divisible by n_kv_heads; got H={H}, "
            f"KV={KV} (H % KV = {H % KV if KV else 'undefined'}) — integer "
            f"grouping would silently mis-route queries to the wrong KV head")
    if window is not None:
        if window <= 0:
            raise ValueError(
                f"sliding window must be a positive span, got window="
                f"{window} (every position would be masked)")
        if window > T:
            raise ValueError(
                f"sliding window {window} exceeds the key length T={T}; "
                f"pass window=None for full attention over this context")


# flash_attention_fwd(q, k, v, out, q_offset, kv_len, B, S, T, H, KV, dh,
#                     dtype, causal, window, scale, stream)
ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p])
# flash_partial_fwd(q, k, v, acc, m, l, delta, B, S, T, H, KV, dh, dtype,
#                   causal, window, scale, stream)
PARTIAL_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                    + [ctypes.c_float, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/flash_attention.cu`` built and loaded, with both entries:
    the full kernel and ring attention's panel visit."""
    lib = _build.load("flash_attention")
    for fn, argtypes in ((lib.flash_attention_fwd, ARGTYPES),
                         (lib.flash_partial_fwd, PARTIAL_ARGTYPES)):
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def _lane_arg(x: Optional[torch.Tensor], B: int, device: torch.device,
              name: str) -> Optional[torch.Tensor]:
    if x is None:
        return None
    if x.shape != (B,) or x.dtype != torch.int32 or x.device != device:
        raise ValueError(f"{name} must be an int32 tensor of shape ({B},) on "
                         f"{device}; got {tuple(x.shape)} {x.dtype} on "
                         f"{x.device}")
    return x.contiguous()


def check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 fn: str) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Raise on what the kernel does not take: q (B,S,H,dh), k/v
    (B,T,KV,dh) on one CUDA device, one dtype (float32 or bfloat16), dh in
    {64, 128}.  Return q, k, v laid out for the kernel.  The caller checks
    the GQA grouping and the window."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    if not (q.is_cuda and k.device == q.device and v.device == q.device):
        raise ValueError(f"{fn} needs q, k and v on one CUDA device; got "
                         f"{q.device}, {k.device}, {v.device}")
    if q.dtype not in _DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"dtypes must all be float32 or bfloat16; got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if dh not in _HEAD_DIMS or k.shape != (B, T, KV, dh) \
            or v.shape != k.shape:
        raise ValueError(f"unsupported shapes q={tuple(q.shape)} "
                         f"k={tuple(k.shape)} v={tuple(v.shape)} "
                         f"(head dim must be one of {_HEAD_DIMS})")
    # contiguous, 16-byte-aligned bases: the kernels read rows with 16-byte
    # loads, and the bf16 kernel's tensor maps need aligned bases
    return tuple(x.contiguous() if x.data_ptr() % 16 == 0
                 else x.clone(memory_format=torch.contiguous_format)
                 for x in (q, k, v))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         q_offset: Optional[torch.Tensor] = None,
                         kv_len: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Launch the CUDA kernel: q (B,S,H,dh); k/v (B,T,KV,dh) -> (B,S,H,dh).

    Tensors must lie on one CUDA device, share a dtype (float32 or
    bfloat16) and have dh in {64, 128}.  Raises otherwise, and raises if the
    launch fails; it never computes on another path."""
    _validate_attn_shapes(q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                          window)
    q, k, v = check_inputs(q, k, v, "flash_attention_cuda")
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    q_offset = _lane_arg(q_offset, B, q.device, "q_offset")
    kv_len = _lane_arg(kv_len, B, q.device, "kv_len")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if q_offset is None else q_offset.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(),
            B, S, T, H, KV, dh, _DTYPES[q.dtype], int(causal),
            0 if window is None else int(window), 1.0 / dh ** 0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_cuda.launches += 1
    return out


flash_attention_cuda.launches = 0
