"""The hand kernels on the ``meta`` device: shapes, and the work charged.

A ``meta`` tensor holds no numbers, so no kernel runs on one: the dry run
(``launch/dryrun.py``) drives one rank's step on ``meta`` to count what it
would do.  ``kernels/ops.py`` sends a ``meta`` tensor here, where each
entry gives its outputs' shapes (under autograd its gradients' too) and
charges the kernel's operations and bytes to every :class:`KernelCharges`
open in :func:`charge_kernels`, by the formulas of the bounds that
``chip_smoke.py`` prints for the kernels on the card (``PERF.md`` §6):

  * flash forward: 4 x admitted (query, key) pairs x H x dh operations;
    q, k, v read, the output (and the row log-sum-exp, when written)
    written once;
  * flash backward: 10 x pairs x H x dh; q, k, v, o, dO and the
    log-sum-exp read, dq, dk, dv written;
  * the ring's panel visit: the forward's count at its ``delta``, the fp32
    (acc, m, l) written;
  * RMSNorm: 4 operations an element forward, 10 backward; x (and dy) read,
    y (dx) written, the weight read (and dw written);
  * the SSD scan: the chunked products the kernels compute
    (:func:`ssd_ops`); x, dt, B, C read and y written (backward: each read
    twice with dy, and the gradients written).

The plain versions' arithmetic is not run: it would charge the whole
S x T score matrix and the step-by-step scan, which no kernel does.  On
``meta`` a ``kv_len`` or ``q_offset`` tensor holds no numbers either, so
such a call is charged as the full cache's: every key admitted, the query
rows at its end.
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional

import numpy as np
import torch


class KernelCharges:
    """Launches, operations and bytes of the hand kernels, by kernel
    (``flash_attention``, ``flash_attention_bwd``, ``flash_partial``,
    ``rmsnorm``, ``rmsnorm_bwd``, ``ssd_scan``, ``ssd_scan_bwd``)."""

    def __init__(self):
        self.by_kernel: Dict[str, Dict[str, float]] = {}

    def add(self, name: str, ops: float, nbytes: float) -> None:
        row = self.by_kernel.setdefault(
            name, {"launches": 0, "ops": 0.0, "bytes": 0.0})
        row["launches"] += 1
        row["ops"] += float(ops)
        row["bytes"] += float(nbytes)

    @property
    def ops(self) -> float:
        return sum(r["ops"] for r in self.by_kernel.values())

    @property
    def bytes(self) -> float:
        return sum(r["bytes"] for r in self.by_kernel.values())


_OPEN: List[KernelCharges] = []


@contextlib.contextmanager
def charge_kernels(charges: KernelCharges) -> Iterator[KernelCharges]:
    """Charge every meta kernel call in the block to ``charges``."""
    _OPEN.append(charges)
    try:
        yield charges
    finally:
        _OPEN.remove(charges)


def _charge(name: str, ops: float, nbytes: float) -> None:
    for c in _OPEN:
        c.add(name, ops, nbytes)


def admitted_pairs(S: int, T: int, *, causal: bool, window: Optional[int],
                   offset: int) -> int:
    """Admitted (query, key) pairs of one lane and head: query row ``s`` at
    position ``offset + s`` against keys ``0..T-1``, with the masks of
    ``kernels/ref.py::attn_mask`` (no ``kv_len``)."""
    pos = offset + np.arange(S, dtype=np.int64)
    hi = np.minimum(pos, T - 1) if causal else np.full(S, T - 1)
    lo = (np.maximum(pos - window + 1, 0) if window is not None
          else np.zeros(S, dtype=np.int64))
    return int(np.maximum(hi - lo + 1, 0).sum())


def _attn_pairs(S: int, T: int, causal: bool, window: Optional[int],
                q_offset, delta: int = 0) -> int:
    # a q_offset tensor holds no numbers here: the rows at the cache's end
    offset = T - S if q_offset is not None else delta
    return admitted_pairs(S, T, causal=causal, window=window, offset=offset)


def _nbytes(*ts: torch.Tensor) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


class _MetaFlash(torch.autograd.Function):
    """The training path's flash attention on ``meta``: the forward's
    output, the backward's dq, dk, dv, each charged."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window):
        B, S, H, dh = q.shape
        pairs = _attn_pairs(S, k.shape[1], causal, window, None)
        ctx.shapes = (q, k, v)
        ctx.pairs = pairs
        out = q.new_empty(q.shape)
        # the forward writes the row log-sum-exp for the backward
        _charge("flash_attention", 4 * B * pairs * H * dh,
                2 * _nbytes(q) + _nbytes(k, v) + 4 * B * S * H)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.shapes
        B, S, H, dh = q.shape
        _charge("flash_attention_bwd", 10 * B * ctx.pairs * H * dh,
                4 * _nbytes(q) + 2 * _nbytes(k, v) + 4 * B * S * H)
        return (q.new_empty(q.shape), k.new_empty(k.shape),
                v.new_empty(v.shape), None, None)


def flash_attention(q, k, v, *, causal, window, q_offset, kv_len,
                    return_lse, needs_grad):
    """``ops.flash_attention`` on ``meta``."""
    if needs_grad:
        return _MetaFlash.apply(q, k, v, causal, window)
    B, S, H, dh = q.shape
    pairs = _attn_pairs(S, k.shape[1], causal, window, q_offset)
    lens = 4 * B * ((q_offset is not None) + (kv_len is not None))
    _charge("flash_attention", 4 * B * pairs * H * dh,
            2 * _nbytes(q) + _nbytes(k, v) + lens
            + (4 * B * S * H if return_lse else 0))
    out = q.new_empty(q.shape)
    if not return_lse:
        return out
    return out, q.new_empty((B, S, H), dtype=torch.float32)


def flash_partial(q, k, v, delta: int, *, causal: bool,
                  window: Optional[int]):
    """``ops.flash_partial`` on ``meta``: (acc, m, l) in fp32."""
    B, S, H, dh = q.shape
    pairs = _attn_pairs(S, k.shape[1], causal, window, None, delta)
    acc = q.new_empty(q.shape, dtype=torch.float32)
    m = q.new_empty((B, S, H, 1), dtype=torch.float32)
    _charge("flash_partial", 4 * B * pairs * H * dh,
            _nbytes(q, k, v) + _nbytes(acc) + 2 * _nbytes(m))
    return acc, m, q.new_empty(m.shape)


class _MetaRMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.shapes = (x, w)
        _charge("rmsnorm", 4 * x.numel(), 2 * _nbytes(x) + _nbytes(w))
        return x.new_empty(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.shapes
        _charge("rmsnorm_bwd", 10 * x.numel(), 3 * _nbytes(x) + 2 * _nbytes(w))
        return x.new_empty(x.shape), w.new_empty(w.shape), None


def rmsnorm(x, w, eps):
    """``ops.rmsnorm`` on ``meta``."""
    return _MetaRMSNorm.apply(x, w, eps)


def ssd_ops(B: int, S: int, H: int, P: int, N: int, Q: int):
    """Operations of the chunked SSD scan (forward, backward) as the
    kernels compute it: per chunk the products C B^T, M x, C S^T and the
    state update forward; C B^T, dy x^T, the two products each of dx, dB
    and dC, the dS update and the recomputed state update backward."""
    per_chunk_fwd = 2 * (Q * Q * N + Q * Q * P + 2 * Q * N * P)
    per_chunk_bwd = 2 * (3 * Q * Q * N + 2 * Q * Q * P + 5 * Q * N * P)
    chunks = B * H * -(-S // Q)
    return per_chunk_fwd * chunks, per_chunk_bwd * chunks


class _MetaSSD(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, dt, A, Bm, Cm, chunk):
        B, S, H, P = x.shape
        ctx.shapes = (x, dt, A, Bm, Cm)
        ctx.ops = ssd_ops(B, S, H, P, Bm.shape[-1], chunk)
        ctx.seq = _nbytes(x, dt, A, Bm, Cm)
        _charge("ssd_scan", ctx.ops[0], ctx.seq + _nbytes(x))
        return x.new_empty(x.shape)

    @staticmethod
    def backward(ctx, dy):
        _charge("ssd_scan_bwd", ctx.ops[1], 2 * ctx.seq + _nbytes(dy))
        return (*(t.new_empty(t.shape) for t in ctx.shapes), None)


def ssd_scan(x, dt, A, Bm, Cm, chunk):
    """``ops.ssd_scan`` on ``meta``."""
    return _MetaSSD.apply(x, dt, A, Bm, Cm, chunk)
