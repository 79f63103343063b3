# The port's copy of repro/core/strategy.py: the same names and arithmetic.
"""Per-layer hybrid parallelism strategies (decision-tree leaves).

A strategy for one layer, given a device group of size ``n`` (the devices of
one pipeline stage), is an *ordered* sequence of ``(paradigm, degree)`` levels
— the path of one decision tree in Fig. 3 — plus the CKPT bit.  Order matters
because outer levels communicate over slower/wider device groupings (the tree
captures the bandwidth hierarchy); e.g. 2-way DP over 2-way TP places TP on
the innermost (fastest) links.

Paradigms: ``dp`` (data parallel), ``sdp`` (sharded data parallel / ZeRO-3),
``tp`` (tensor parallel), ``sp`` (sequence parallel — ring attention over a
sequence-sharded axis; opt-in, see ``SP_PARADIGMS``), ``ep`` (expert
parallel — MoE experts sharded over an expert axis with all-to-all
dispatch/combine; opt-in, see ``EP_PARADIGMS``).  PP is handled one level up
(it partitions the model into stages before per-layer search — Takeaway #1).
"""
from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Sequence, Tuple

DP = "dp"
SDP = "sdp"
TP = "tp"
SP = "sp"
PARADIGMS = (DP, SDP, TP)
# SP widens the tree with a sequence-parallel branch.  It is opt-in (the
# paper's 8-device leaf counts that tests pin are defined over DP/SDP/TP);
# ``OptimizerConfig(use_sp=True)`` passes this tuple through instead.
SP_PARADIGMS = (DP, SDP, TP, SP)
EP = "ep"
# EP widens the tree further with an expert-parallel branch for MoE layers.
# Also opt-in: ``OptimizerConfig(use_ep=True)`` appends EP to whatever
# paradigm tuple is otherwise in effect (so EP composes with use_sp).
EP_PARADIGMS = (DP, SDP, TP, SP, EP)


@dataclasses.dataclass(frozen=True)
class Strategy:
    """One decision-tree leaf: ordered parallelism levels + ckpt flag."""

    levels: Tuple[Tuple[str, int], ...]   # ((paradigm, degree), ...) outer→inner
    ckpt: bool = False

    # ---- derived degrees -------------------------------------------------
    def degree(self, paradigm: str) -> int:
        d = 1
        for p, k in self.levels:
            if p == paradigm:
                d *= k
        return d

    @property
    def dp(self) -> int:
        return self.degree(DP)

    @property
    def sdp(self) -> int:
        return self.degree(SDP)

    @property
    def tp(self) -> int:
        return self.degree(TP)

    @property
    def sp(self) -> int:
        return self.degree(SP)

    @property
    def ep(self) -> int:
        return self.degree(EP)

    @property
    def total(self) -> int:
        d = 1
        for _, k in self.levels:
            d *= k
        return d

    @property
    def data_degree(self) -> int:
        """Replication factor of the batch dimension (DP and SDP both split data)."""
        return self.dp * self.sdp

    def with_ckpt(self, ckpt: bool = True) -> "Strategy":
        return dataclasses.replace(self, ckpt=ckpt)

    def name(self) -> str:
        parts = [f"{p}{k}" for p, k in self.levels] or ["serial"]
        if self.ckpt:
            parts.append("ckpt")
        return "-".join(parts)

    def __str__(self) -> str:  # pragma: no cover - cosmetic
        return self.name()

    def to_json(self) -> Dict:
        return {"levels": [list(l) for l in self.levels], "ckpt": self.ckpt}

    @staticmethod
    def from_json(d: Dict) -> "Strategy":
        return Strategy(tuple((p, int(k)) for p, k in d["levels"]), bool(d["ckpt"]))


# --------------------------------------------------------------------------
# strategy-set identity (memo-cache keys)
# --------------------------------------------------------------------------

_SET_IDS: Dict[Tuple[Strategy, ...], int] = {}


def strategy_set_id(strategies: Sequence[Strategy]) -> int:
    """Small interned token identifying an ordered strategy list.

    Equal lists (same strategies, same order) always map to the same token,
    so search caches can key on one int instead of re-hashing the whole
    list on every lookup.  The intern table is tiny: one entry per distinct
    search space actually constructed in the process.
    """
    key = tuple(strategies)
    sid = _SET_IDS.get(key)
    if sid is None:
        sid = len(_SET_IDS)
        _SET_IDS[key] = sid
    return sid


def _factorizations(n: int, max_parts: int) -> Iterable[Tuple[int, ...]]:
    """Ordered compositions of ``n`` into ≤ max_parts factors, each ≥ 2.

    Degrees are powers of two by the decision-tree rule (non-leaf node degree
    ∈ {2,4,8,...}); since ``n`` itself is a power of two, any factorization
    into integers ≥2 automatically uses powers of two.
    """
    if n == 1:
        yield ()
        return

    def rec(rem: int, parts: Tuple[int, ...]):
        if rem == 1:
            yield parts
            return
        if len(parts) == max_parts:
            return
        f = 2
        while f <= rem:
            if rem % f == 0:
                yield from rec(rem // f, parts + (f,))
            f *= 2

    yield from rec(n, ())


def enumerate_strategies(
    group_size: int,
    *,
    paradigms: Sequence[str] = PARADIGMS,
    allow_ckpt: bool = True,
    prune_dp_sdp: bool = True,
) -> List[Strategy]:
    """All decision-tree leaves for one stage's device group.

    Implements the construction rules of §III-B:
      * tree height = number of distinct paradigms used (each used once),
      * node degrees are powers of two multiplying to ``group_size``,
      * order matters (bandwidth hierarchy),
      * each tree optionally applies CKPT (S_i vs S_i'),
      * Takeaway #3 prunes any tree containing both DP and SDP.
    """
    out: List[Strategy] = []
    seen = set()
    for factors in _factorizations(group_size, max_parts=len(paradigms)):
        for assign in itertools.permutations(paradigms, len(factors)):
            if prune_dp_sdp and DP in assign and SDP in assign:
                continue
            levels = tuple(zip(assign, factors))
            if levels in seen:
                continue
            seen.add(levels)
            out.append(Strategy(levels, ckpt=False))
            if allow_ckpt:
                out.append(Strategy(levels, ckpt=True))
    # Deterministic ordering: by (#levels, name) for reproducible DP search.
    out.sort(key=lambda s: (len(s.levels), s.name()))
    return out
