"""Operations and bytes of one call of causal (or full) attention, from its
shapes.  Frozen: a later kernel is held to the same count.

Admitted pairs are exact: with S queries over T keys, query ``i`` at
position ``T - S + i`` sees the keys at or before it (within ``window``
when one is given); without a causal mask it sees all T.  Operations are
the products' multiply-adds (two operations each): q.k and p.v make 4 x
pairs x heads x dh forward; the backward recomputes q.k and forms dv, dp,
dq and dk, 10 x pairs x heads x dh.  Bytes: each input read once and each
output written once, in the dtypes the training path uses (q, k, v, the
output and its gradients in the call's dtype, the row log-sum-exp fp32).
The forward's bound at B 2, S 4096, H 32, KV 8, dh 128 is 0.27800 ms and
the backward's 0.69501 ms, both by operations, as the port's kernel table
has them.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple


def admitted_pairs(S: int, T: int, causal: bool, window=None) -> int:
    """Pairs (query, key) one batch row admits."""
    total = 0
    if not causal and window is None:
        return S * T
    for i in range(S):
        pos = T - S + i
        lo = 0 if window is None else max(0, pos - window + 1)
        hi = pos if causal else T - 1
        total += max(0, hi - lo + 1)
    return total


def _pairs(S: int, T: int, causal: bool, window) -> int:
    if causal and window is None and S <= T:
        # rows T-S..T-1 of a full lower triangle, in closed form
        return S * (T - S) + S * (S + 1) // 2
    return admitted_pairs(S, T, causal, window)


def call_cost(call: Dict[str, Any]) -> Tuple[float, float, float, float]:
    """(forward ops, forward bytes, backward ops, backward bytes) of one
    recorded call: ``shapes`` of q (B,S,H,dh), k and v (B,T,KV,dh),
    ``itemsize`` of q, ``kwargs`` with ``causal`` and ``window``."""
    (B, S, H, dh), (_, T, KV, _) = call["shapes"][0], call["shapes"][1]
    kw = call["kwargs"]
    pairs = B * _pairs(S, T, kw.get("causal", True), kw.get("window"))
    e = call["itemsize"]
    q, kv, lse = B * S * H * dh * e, 2 * B * T * KV * dh * e, B * S * H * 4
    fwd_ops = 4.0 * pairs * H * dh
    fwd_bytes = q + kv + q + lse                 # q, k, v in; out, lse out
    bwd_ops = 10.0 * pairs * H * dh
    # in: q, k, v, out, dout, lse; out: dq, dk, dv
    bwd_bytes = (q + kv + q + q + lse) + (q + kv)
    return fwd_ops, fwd_bytes, bwd_ops, bwd_bytes


def training_pairs(batch: int, seq: int) -> int:
    """Causal pairs of a training batch of ``batch`` rows of ``seq``."""
    return batch * seq * (seq + 1) // 2
