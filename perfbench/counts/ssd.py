"""Operations and bytes of one call of the Mamba2 SSD scan, from its
shapes.  Frozen: a later kernel is held to the same count.

Operations are those of the recurrence itself, whatever chunk size a
kernel splits it into: for each token and head the state update
h += (dt x) B^T and the read-out y = h C, each P x N multiply-adds, so
4 x P x N operations forward; the backward forms the gradients of both
products, 8 x P x N.  (The port's kernel table bounds the chunked
kernels by the operations of their chunked algebra, 0.07817 ms for the
backward at B 8, S 2048, H 32, P 64, N 128; by this count that call is
bound by its bytes, 0.0663 ms.  The forward is bound by its bytes either
way, 0.0433 ms here against the table's 0.04320.)  The decay of the
state and the skip D x are not counted.

Bytes: each input read once and each output written once: x, y, dx, dy
in the call's dtype; dt, ddt, A and dA in fp32; B and C (one group) and
their gradients in the call's dtype.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple


def token_head_ops(P: int, N: int) -> Tuple[float, float]:
    """(forward, backward) operations of one token of one head."""
    return 4.0 * P * N, 8.0 * P * N


def call_cost(call: Dict[str, Any]) -> Tuple[float, float, float, float]:
    """(forward ops, forward bytes, backward ops, backward bytes) of one
    recorded call: ``shapes`` of x (B,S,H,P), dt (B,S,H), A (H,), Bm and
    Cm (B,S,G,N); ``itemsize`` of x."""
    (B, S, H, P), _, _, (_, _, G, N) = call["shapes"][:4]
    e = call["itemsize"]
    f_ops, b_ops = token_head_ops(P, N)
    x = B * S * H * P * e
    dt, A, bc = B * S * H * 4, H * 4, 2 * B * S * G * N * e
    fwd_bytes = (x + dt + A + bc) + x
    bwd_bytes = (x + x + dt + A + bc) + (x + dt + A + bc)
    return f_ops * B * S * H, fwd_bytes, b_ops * B * S * H, bwd_bytes
