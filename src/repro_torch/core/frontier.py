# The port's copy of repro/core/frontier.py: the same names and arithmetic.
"""Throughput-vs-memory plan frontier (DESIGN.md §6).

The paper's headline evaluation presents throughput as a *function of the
per-device memory budget*.  ``GalvatronOptimizer.sweep_budgets`` produces a
:class:`PlanFrontier`: one (budget, plan, predicted throughput) point per
swept budget, all searched in ~one pass by running the stage DP with a
budget axis.  The frontier serializes to JSON (consumed by
``launch/search.py`` and ``benchmarks/bench_frontier.py``) and exposes the
knee points — the budgets where predicted throughput actually improves,
i.e. where buying more memory buys speed.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from .plan import ParallelPlan

GB = 1024 ** 3


@dataclasses.dataclass
class FrontierPoint:
    """One swept budget: the best plan found under it (None if everything
    OOMs) and its predicted throughput (samples/s; 0.0 when infeasible)."""

    budget_bytes: float
    plan: Optional[ParallelPlan]
    predicted_throughput: float = 0.0

    @property
    def feasible(self) -> bool:
        return self.plan is not None

    def to_json(self) -> Dict:
        return {
            "budget_bytes": self.budget_bytes,
            "budget_gb": self.budget_bytes / GB,
            "predicted_throughput": self.predicted_throughput,
            "plan": self.plan.to_json() if self.plan is not None else None,
        }

    @staticmethod
    def from_json(d: Dict) -> "FrontierPoint":
        plan = (ParallelPlan.from_json(d["plan"])
                if d.get("plan") is not None else None)
        return FrontierPoint(
            budget_bytes=d["budget_bytes"],
            plan=plan,
            predicted_throughput=d.get("predicted_throughput", 0.0),
        )


@dataclasses.dataclass
class PlanFrontier:
    """The whole budget sweep, sorted by budget ascending.

    ``quant_bytes`` records the DP quantization grid the sweep ran on —
    a serial ``optimize()`` reproduces a point byte-for-byte only on the
    same grid.  ``search_stats`` is the aggregated engine telemetry
    (cache hits/misses summed across parallel workers); like
    ``ParallelPlan.search_stats`` it is excluded from equality.
    """

    points: List[FrontierPoint]
    quant_bytes: float = 0.0
    search_stats: Optional[Dict[str, float]] = dataclasses.field(
        default=None, compare=False)

    def __post_init__(self):
        self.points = sorted(self.points, key=lambda p: p.budget_bytes)

    # ---- queries --------------------------------------------------------
    def budgets(self) -> List[float]:
        return [p.budget_bytes for p in self.points]

    def throughputs(self) -> List[float]:
        return [p.predicted_throughput for p in self.points]

    def feasible_points(self) -> List[FrontierPoint]:
        return [p for p in self.points if p.feasible]

    def plan_at(self, budget_bytes: float) -> Optional[ParallelPlan]:
        """Best known plan fitting under ``budget_bytes``: the highest-
        throughput feasible point whose swept budget is <= the query (plans
        found under a smaller budget remain valid under a larger one).
        This is the incremental answer for budgets between swept points —
        no re-search needed."""
        best: Optional[FrontierPoint] = None
        for p in self.points:
            if p.budget_bytes <= budget_bytes and p.feasible:
                if (best is None
                        or p.predicted_throughput > best.predicted_throughput):
                    best = p
        return best.plan if best is not None else None

    def knee_points(self) -> List[FrontierPoint]:
        """Pareto knees: feasible points whose predicted throughput strictly
        exceeds every smaller budget's — the budgets where extra memory
        actually converts into speed."""
        out: List[FrontierPoint] = []
        seen_best = 0.0
        for p in self.points:
            if p.feasible and p.predicted_throughput > seen_best:
                out.append(p)
                seen_best = p.predicted_throughput
        return out

    def summary(self) -> str:
        rows = []
        for p in self.points:
            if p.feasible:
                rows.append(f"{p.budget_bytes / GB:7.1f} GB  "
                            f"{p.predicted_throughput:10.2f} samples/s  "
                            f"{p.plan.summary()}")
            else:
                rows.append(f"{p.budget_bytes / GB:7.1f} GB        OOM")
        return "\n".join(rows)

    # ---- (de)serialization ----------------------------------------------
    def to_json(self) -> Dict:
        knees = {id(p) for p in self.knee_points()}
        return {
            "quant_bytes": self.quant_bytes,
            "points": [dict(p.to_json(), knee=(id(p) in knees))
                       for p in self.points],
            "search_stats": self.search_stats,
        }

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=2)

    @staticmethod
    def from_json(d: Dict) -> "PlanFrontier":
        return PlanFrontier(
            points=[FrontierPoint.from_json(p) for p in d["points"]],
            quant_bytes=d.get("quant_bytes", 0.0),
            search_stats=d.get("search_stats"),
        )

    @staticmethod
    def loads(s: str) -> "PlanFrontier":
        return PlanFrontier.from_json(json.loads(s))


# --------------------------------------------------------------------------
# batch-axis dominance frontier (search-time pruning)
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CandidateBound:
    """Certified optimistic bounds for one unexplored (B, P) candidate.

    ``tpt_upper`` over-estimates the best throughput any plan of the
    candidate can reach (an ideal-balance cost lower bound turned into a
    samples/s upper bound); ``mem_lower`` under-estimates the peak stage
    memory of its *cheapest* strategy assignment.  Both must be sound —
    the pruner's byte-identity guarantee leans on them — so they are built
    from per-layer minima of the exact cost tables (see
    ``GalvatronOptimizer._candidate_bound`` for the derivation)."""

    tpt_upper: float              # samples/s, >= any achievable throughput
    mem_lower: float              # bytes, <= any achievable peak stage memory


class DominanceFrontier:
    """Running per-budget dominance frontier over the batch axis.

    Mirrors the budget-axis machinery one level up: as the B × P sweep
    explores candidates in grid order it records the best throughput
    achieved so far *under each budget* (:meth:`observe`); an unexplored
    candidate whose optimistic :class:`CandidateBound` cannot beat that
    incumbent (:meth:`dominated`) — or cannot even fit
    (:meth:`infeasible`) — is skipped without running its inner DP.

    Soundness of skipping, per budget ``k``:

    * *infeasible*: ``mem_lower > budgets[k]`` means every strategy chain
      of the candidate exceeds the budget, so the serial search would have
      returned no plan for ``k`` — skipping changes nothing.
    * *dominated*: the serial sweep replaces its incumbent only on a
      *strictly* better throughput, and incumbents only improve over time,
      so a candidate with ``tpt_upper <= best[k]`` at skip time can never
      displace the final answer.

    The interaction with the two-consecutive-OOM batch stop is handled by
    the optimizer (a dominated-but-feasible candidate may still need a
    *forced* run to decide OOM bookkeeping — see ``_sweep_axis``).
    """

    def __init__(self, budgets):
        self.budgets = tuple(float(b) for b in budgets)
        self.best = [0.0] * len(self.budgets)

    def observe(self, k: int, throughput: float) -> None:
        """Record a plan actually found under budget ``k``."""
        if throughput > self.best[k]:
            self.best[k] = throughput

    def infeasible(self, k: int, bound: CandidateBound) -> bool:
        return bound.mem_lower > self.budgets[k]

    def dominated(self, k: int, bound: CandidateBound) -> bool:
        return self.best[k] > 0.0 and bound.tpt_upper <= self.best[k]

    def classify(self, k: int, bound: CandidateBound) -> str:
        """``"infeasible"`` / ``"dominated"`` / ``"live"`` for budget k."""
        if self.infeasible(k, bound):
            return "infeasible"
        if self.dominated(k, bound):
            return "dominated"
        return "live"
