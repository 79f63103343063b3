# The port's copy of repro/core/decision_tree.py: the same names and arithmetic.
"""Decision-tree based search-space construction (paper §III-B).

Takeaway #1: PP is applied first, across the slowest links; the remaining
paradigms (DP/SDP/TP) form decision trees over each stage's device group.
Takeaway #2: devices split into equal-size groups ⇒ group size = N / pp.
Takeaway #3: prune trees mixing DP and SDP.

For 8 devices this produces 68 leaves without T#3 and 44 with it (unit
tested against the paper's reported counts).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Sequence

from .strategy import PARADIGMS, Strategy, enumerate_strategies


def pp_degree_candidates(n_devices: int, max_pp: int | None = None) -> List[int]:
    """Powers of two dividing the device count (paper assumes 2^k devices)."""
    out = []
    p = 1
    while p <= n_devices:
        if n_devices % p == 0:
            if max_pp is None or p <= max_pp:
                out.append(p)
        p *= 2
    return out


@dataclasses.dataclass(frozen=True)
class SearchSpace:
    """All candidate per-layer strategies, grouped by PP degree."""

    n_devices: int
    per_pp: Dict[int, List[Strategy]]

    def strategies(self, pp: int) -> List[Strategy]:
        return self.per_pp[pp]

    def total_leaves(self) -> int:
        return sum(len(v) for v in self.per_pp.values())


def construct_search_space(
    n_devices: int,
    *,
    paradigms: Sequence[str] = PARADIGMS,
    allow_ckpt: bool = True,
    prune_dp_sdp: bool = True,
    max_pp: int | None = None,
    max_tp: int | None = None,
    max_sp: int | None = None,
    max_ep: int | None = None,
) -> SearchSpace:
    per_pp: Dict[int, List[Strategy]] = {}
    for pp in pp_degree_candidates(n_devices, max_pp):
        group = n_devices // pp
        strategies = enumerate_strategies(
            group,
            paradigms=paradigms,
            allow_ckpt=allow_ckpt,
            prune_dp_sdp=prune_dp_sdp,
        )
        if max_tp is not None:
            strategies = [s for s in strategies if s.tp <= max_tp]
        if max_sp is not None:
            strategies = [s for s in strategies if s.sp <= max_sp]
        if max_ep is not None:
            strategies = [s for s in strategies if s.ep <= max_ep]
        per_pp[pp] = strategies
    return SearchSpace(n_devices=n_devices, per_pp=per_pp)
