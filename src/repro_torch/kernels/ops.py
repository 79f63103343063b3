"""Public kernel entry points, dispatched on the tensors' device.

A CUDA tensor goes to the hand-written Hopper kernel, which either launches
or raises; a CPU tensor goes to the kernel's plain version in
``kernels/ref.py``; a ``meta`` tensor, which holds no numbers, gets its
outputs' shapes and the kernel's work charged (``kernels/meta.py``, the dry
run's).  There is no other route and no fallback: a kernel that fails to
build or launch is an error, never a silent detour through the plain
version.
"""
from __future__ import annotations

from typing import Optional

import torch

from . import meta
from .flash_attention import (FlashAttention, _validate_attn_shapes,
                              check_bwd_scope, check_shapes,
                              flash_attention_cuda)
from .ref import (State, flash_attention_lse_ref, flash_attention_ref,
                  flash_partial_ref, rmsnorm_ref, ssd_scan_ref)
from .ring_attention import (check_no_grad, check_panel,
                             flash_partial_cuda, ring_flash_attention)
from .rmsnorm import RMSNorm
from .ssd_scan import SSDScan

__all__ = ["flash_attention", "flash_partial", "ring_flash_attention",
           "rmsnorm", "ssd_scan"]


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type not in ("cuda", "cpu"):
        raise ValueError(f"no kernel route for device {x.device}")
    return x.device.type == "cuda"


def _on_meta(x: torch.Tensor) -> bool:
    return x.device.type == "meta"


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: Optional[int] = None,
                    q_offset: Optional[torch.Tensor] = None,
                    kv_len: Optional[torch.Tensor] = None,
                    return_lse: bool = False):
    """q (B,S,H,dh); k/v (B,T,KV,dh) -> (B,S,H,dh).  See
    :func:`~repro_torch.kernels.ref.flash_attention_ref` for the masks.

    On CUDA, inputs that need gradients go through :class:`FlashAttention`
    (the forward writes the row log-sum-exp, the backward kernels run in
    ``backward``), which takes the training path's masks only and raises on
    ``q_offset``, ``kv_len``, or a causal mask or window at S != T
    (cross-attention takes none); otherwise the forward kernel alone runs,
    writing nothing more (the serving path's lean launch).

    ``return_lse`` returns ``(out, lse)`` with the (B,S,H) fp32 row
    log-sum-exp of the scaled scores over the admissible keys, ``+inf`` on
    a row with none (the context merge of sharded decode reads it): the
    forward kernel writes it on every mask, the plain version
    (:func:`~repro_torch.kernels.ref.flash_attention_lse_ref`) computes
    it.  It takes inputs that need no gradient; raises ValueError
    otherwise."""
    needs_grad = torch.is_grad_enabled() and (
        q.requires_grad or k.requires_grad or v.requires_grad)
    if return_lse and needs_grad:
        raise ValueError("flash_attention(return_lse=True) takes inputs "
                         "that need no gradient (the serving path's)")
    if _on_meta(q):
        if needs_grad:
            check_bwd_scope(q.shape[1], k.shape[1], causal=causal,
                            window=window, q_offset=q_offset, kv_len=kv_len)
        _validate_attn_shapes(q.shape[1], k.shape[1], q.shape[2],
                              k.shape[2], window)
        check_shapes(q, k, v)       # the head dims the kernel takes
        return meta.flash_attention(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, kv_len=kv_len,
                                    return_lse=return_lse,
                                    needs_grad=needs_grad)
    if _on_cuda(q):
        if needs_grad:
            check_bwd_scope(q.shape[1], k.shape[1], causal=causal,
                            window=window, q_offset=q_offset, kv_len=kv_len)
            return FlashAttention.apply(q, k, v, causal, window)
        return flash_attention_cuda(q, k, v, causal=causal, window=window,
                                    q_offset=q_offset, kv_len=kv_len,
                                    with_lse=return_lse)
    _validate_attn_shapes(q.shape[1], k.shape[1], q.shape[2], k.shape[2],
                          window)
    out = flash_attention_ref(q, k, v, causal=causal, window=window,
                              q_offset=q_offset, kv_len=kv_len)
    if not return_lse:
        return out
    return out, flash_attention_lse_ref(q, k, v, causal=causal,
                                        window=window, q_offset=q_offset,
                                        kv_len=kv_len)


def flash_partial(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  delta: int, *, causal: bool = True,
                  window: Optional[int] = None) -> State:
    """One K/V panel visit of ring attention -> (acc, m, l) in fp32.  See
    :func:`~repro_torch.kernels.ref.flash_partial_ref`.  It has no backward:
    on either device, inputs that need gradients raise ValueError while
    grad is enabled (:func:`~.ring_attention.check_no_grad`)."""
    check_no_grad(q, k, v, "flash_partial")
    if _on_meta(q):
        check_panel(q.shape[2], k.shape[2], window)
        return meta.flash_partial(q, k, v, delta, causal=causal,
                                  window=window)
    if _on_cuda(q):
        return flash_partial_cuda(q, k, v, delta, causal=causal,
                                  window=window)
    check_panel(q.shape[2], k.shape[2], window)
    return flash_partial_ref(q, k, v, delta, causal=causal, window=window)


def rmsnorm(x: torch.Tensor, w: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """x (..., d), w (d,) -> RMS-normalised x, in x's dtype.  On CUDA both
    directions run in the CUDA kernels."""
    if _on_meta(x):
        return meta.rmsnorm(x, w, eps)
    if _on_cuda(x):
        return RMSNorm.apply(x, w, eps)
    return rmsnorm_ref(x, w, eps)


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             Bm: torch.Tensor, Cm: torch.Tensor,
             chunk: int = 64) -> torch.Tensor:
    """Mamba2 SSD scan: x (B,S,H,P), dt (B,S,H), A (H,), Bm/Cm (B,S,G,N)
    in G groups, G dividing H (views are read in place) -> y (B,S,H,P).  See
    :func:`~repro_torch.kernels.ref.ssd_scan_ref`.  On CUDA both directions
    run in the CUDA kernels."""
    if _on_meta(x):
        return meta.ssd_scan(x, dt, A, Bm, Cm, chunk)
    if _on_cuda(x):
        return SSDScan.apply(x, dt, A, Bm, Cm, chunk)
    return ssd_scan_ref(x, dt, A, Bm, Cm, chunk)
