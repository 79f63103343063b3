"""Flash attention on Hopper: the ctypes wrappers of
``csrc/flash_attention.cu`` and the autograd Function around them.

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

The backward has no TPU counterpart (the JAX package differentiates plain
attention): :func:`flash_attention_bwd_cuda` launches the source's three
kernels (D, then dK/dV and dQ, no atomics; in bf16 warp-specialised
kernels whose products run on ``wgmma`` with operands by TMA, in fp32 FMA
loops) for the training path's masks
only, from the forward's row log-sum-exp, which the forward writes when
asked (``with_lse=True``).  :class:`FlashAttention` saves q, k, v, the
output and the log-sum-exp and runs both.

:func:`flash_attention_cuda` and :func:`flash_attention_bwd_cuda` only
launch kernels; ``kernels/ops.py`` sends CUDA tensors that need gradients
through :class:`FlashAttention`, other CUDA tensors to the forward alone,
and CPU tensors to ``kernels/ref.py::flash_attention_ref``.
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


# flash_attention_fwd(q, k, v, out, lse, q_offset, kv_len, B, S, T, H, KV,
#                     dh, dtype, causal, window, scale, stream)
ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
            + [ctypes.c_float, ctypes.c_void_p])
# flash_attention_bwd(q, k, v, o, dout, lse, dq, dk, dv, delta, B, S, T, H,
#                     KV, dh, dtype, causal, window, scale, stream)
BWD_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 9
                + [ctypes.c_float, ctypes.c_void_p])
# flash_partial_fwd(q, k, v, acc, m, l, delta, B, S, T, H, KV, dh, dtype,
#                   causal, window, scale, stream)
PARTIAL_ARGTYPES = ([ctypes.c_void_p] * 7 + [ctypes.c_int] * 9
                    + [ctypes.c_float, ctypes.c_void_p])


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """``csrc/flash_attention.cu`` built and loaded, with its three
    entries: the full kernel, its backward and ring attention's panel
    visit."""
    lib = _build.load("flash_attention")
    for fn, argtypes in ((lib.flash_attention_fwd, ARGTYPES),
                         (lib.flash_attention_bwd, BWD_ARGTYPES),
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
                         f"(head dim must be one of {_HEAD_DIMS}; another, "
                         f"such as kimi-k2-1t-a32b's 112, is not built yet: "
                         f"ROADMAP.md queue 2, K13)")
    return tuple(_aligned(x) for x in (q, k, v))


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous with a 16-byte-aligned base: the kernels read rows with
    16-byte loads, and the bf16 kernel's tensor maps need aligned bases."""
    return (x.contiguous() if x.data_ptr() % 16 == 0
            else x.clone(memory_format=torch.contiguous_format))


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         *, causal: bool = True, window: Optional[int] = None,
                         q_offset: Optional[torch.Tensor] = None,
                         kv_len: Optional[torch.Tensor] = None,
                         with_lse: bool = False):
    """Launch the CUDA kernel: q (B,S,H,dh); k/v (B,T,KV,dh) -> (B,S,H,dh),
    and with ``with_lse`` also the (B,S,H) fp32 row log-sum-exp of the
    scaled scores (+inf on a row with no admissible key): ``(out, lse)``.

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
    lse = (torch.empty(B, S, H, dtype=torch.float32, device=q.device)
           if with_lse else None)
    if out.numel() == 0:
        return (out, lse) if with_lse else out
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(),
            None if q_offset is None else q_offset.data_ptr(),
            None if kv_len is None else kv_len.data_ptr(),
            B, S, T, H, KV, dh, _DTYPES[q.dtype], int(causal),
            0 if window is None else int(window), 1.0 / dh ** 0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_cuda.launches += 1
    return (out, lse) if with_lse else out


flash_attention_cuda.launches = 0


def check_bwd_scope(S: int, T: int, *,
                    q_offset: Optional[torch.Tensor] = None,
                    kv_len: Optional[torch.Tensor] = None) -> None:
    """Raise ValueError, naming the argument, for what the backward does not
    take: it covers the training path's self-attention (S == T, no
    ``q_offset`` or ``kv_len``); the JAX package never differentiates its
    paged or offset paths."""
    for name, arg in (("q_offset", q_offset), ("kv_len", kv_len)):
        if arg is not None:
            raise ValueError(f"the flash-attention backward takes no {name}: "
                             "it covers the training path's self-attention "
                             f"only; got {name}={arg}")
    if S != T:
        raise ValueError(f"the flash-attention backward needs as many keys "
                         f"as queries (self-attention); got S={S}, T={T}")


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             dout: torch.Tensor, lse: torch.Tensor, *,
                             causal: bool = True,
                             window: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor,
                                        torch.Tensor]:
    """Launch the backward kernels: the gradients (dq, dk, dv) of
    ``sum(flash_attention(q, k, v) * dout)`` from the forward's output
    ``o`` and row log-sum-exp ``lse`` (B,S,H) fp32, in the inputs' dtype.

    Takes what the forward takes with S == T and no offsets or lengths
    (:func:`check_bwd_scope`); raises ValueError otherwise and RuntimeError
    if a launch fails.  Never computes on another path."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    _validate_attn_shapes(S, T, H, KV, window)
    check_bwd_scope(S, T)
    q, k, v = check_inputs(q, k, v, "flash_attention_bwd_cuda")
    for name, x in (("o", o), ("dout", dout)):
        if x.shape != q.shape or x.dtype != q.dtype or x.device != q.device:
            raise ValueError(f"{name} must match q: {tuple(q.shape)} "
                             f"{q.dtype} on {q.device}; got {tuple(x.shape)} "
                             f"{x.dtype} on {x.device}")
    if lse.shape != (B, S, H) or lse.dtype != torch.float32 \
            or lse.device != q.device:
        raise ValueError(f"lse must be float32 ({B}, {S}, {H}) on "
                         f"{q.device}; got {lse.dtype} {tuple(lse.shape)} on "
                         f"{lse.device}")
    o, dout, lse = _aligned(o), _aligned(dout), lse.contiguous()
    dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
    if dq.numel() == 0:             # S == T == 0: nothing to launch
        return dq, dk, dv
    delta = torch.empty(B, S, H, dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = _lib().flash_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), delta.data_ptr(), B, S, T, H, KV, dh,
            _DTYPES[q.dtype], int(causal), 0 if window is None else int(window),
            1.0 / dh ** 0.5, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention backward launch failed: CUDA "
                           f"error {err}")
    flash_attention_bwd_cuda.launches += 1
    return dq, dk, dv


flash_attention_bwd_cuda.launches = 0


class FlashAttention(torch.autograd.Function):
    """flash_attention(q, k, v, causal, window) on the training path, both
    directions in the CUDA kernels.  Saves q, k, v, the output and its row
    log-sum-exp; under activation checkpointing the recomputed forward
    saves its own."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        out, lse = flash_attention_cuda(q, k, v, causal=causal,
                                        window=window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, dout, lse,
                                              causal=ctx.causal,
                                              window=ctx.window)
        return dq, dk, dv, None, None
