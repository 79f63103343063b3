# The port's copy of repro/core/optimizer.py: the same names and arithmetic.
"""Parallelism optimization framework (paper §IV, Algorithms 1 & 2).

``GalvatronOptimizer`` implements:
  * Galvatron-Base (Alg. 1): batch-size sweep x PP-degree sweep x
    micro-batch choice x per-stage DP search, with an ideally (memory-)
    balanced pipeline partition;
  * Galvatron-BMW (Alg. 2): the bi-objective workload-balance refinement —
    queue of partitions seeded with the memory-balanced plan p_m, greedy
    boundary-layer adjustment, 3-criterion validation (Eq. 7/8 invariants).

Baseline modes (pure DP/SDP/TP/PP, DP+TP, DP+PP, DeepSpeed-3D-style fixed
strategies, no-CKPT variants) are expressed through the constructor knobs so
every row of the paper's tables is produced by this one class.
"""
from __future__ import annotations

import copy
import dataclasses
import os
import time as _time
from concurrent.futures import (ProcessPoolExecutor, ThreadPoolExecutor,
                                as_completed)
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cost_model import (CostModel, CostModelConfig, CostTables,
                         _SP_INVALID_TIME, _drain_divisor,
                         pipeline_iter_time)
from .decision_tree import SearchSpace, construct_search_space
from .dp_search import (StageSearchResult, dp_search_stage_budgets,
                        dp_search_stage_budgets_batch)
from .frontier import (CandidateBound, DominanceFrontier, FrontierPoint,
                       PlanFrontier)
from .hardware import ClusterSpec
from .layerspec import LayerSpec
from .pipeline_balance import (PartitionEval, adjust_partition,
                               balance_degrees, inflight_microbatches,
                               memory_balanced_partition, stage_bounds,
                               time_balanced_partition,
                               validate_adjustment)
from .plan import ParallelPlan
from .strategy import EP, PARADIGMS, SP, Strategy, strategy_set_id

INF = float("inf")

#: legal values of ``OptimizerConfig.search_backend`` / ``--backend``
SEARCH_BACKENDS = ("serial", "threads", "processes", "vectorized")


def normalize_batch_grid(grid: Optional[Sequence[int]]
                         ) -> Optional[List[int]]:
    """Canonicalize a user-supplied batch grid: dedupe, sort ascending,
    validate entries.

    The Alg. 1 sweep's two-consecutive-OOM early stop assumes batch sizes
    arrive in ascending order — an unsorted grid would silently stop the
    sweep after two OOMs that are *not* adjacent on the size axis (or never
    stop at all), so the grid is canonicalized everywhere it enters the
    engine, not just in ``OptimizerConfig.__post_init__`` (callers mutate
    ``cfg.batch_grid`` after construction).

    Raises:
      ValueError: an entry is not a positive integer, or the grid is empty.
    """
    if grid is None:
        return None
    out = set()
    for b in grid:
        if (isinstance(b, (bool, str)) or not float(b).is_integer()):
            raise ValueError(
                f"batch_grid entries must be positive integers, got {b!r}")
        b = int(b)
        if b < 1:
            raise ValueError(
                f"batch_grid entries must be positive integers, got {b}")
        out.add(b)
    if not out:
        raise ValueError("batch_grid must not be empty (pass None for the "
                         "default geometric+linear grid)")
    return sorted(out)


@dataclasses.dataclass
class OptimizerConfig:
    paradigms: Sequence[str] = PARADIGMS      # which of DP/SDP/TP to search
    allow_ckpt: bool = True
    use_pp: bool = True                        # False => PP degree fixed to 1
    # sequence parallelism (ring attention) as a fourth searched paradigm;
    # opt-in: appends "sp" to ``paradigms`` so the decision tree grows the
    # SP branch (the paper-count leaf sets stay untouched by default)
    use_sp: bool = False
    max_sp: Optional[int] = None
    # expert parallelism (sharded MoE experts + all-to-all dispatch) as a
    # fifth searched paradigm; opt-in exactly like ``use_sp`` — appends
    # "ep" to ``paradigms``, so default searches stay bit-identical
    use_ep: bool = False
    max_ep: Optional[int] = None
    bi_objective: bool = True                  # BMW partition refinement
    schedule: str = "1f1b"          # or "gpipe" / "1f1b-interleaved" / "zb-h1"
    # pipeline-schedule search axis: candidate schedule names swept per
    # (B, P); None => just (schedule,), the pre-schedule-subsystem behaviour
    schedules: Optional[Sequence[str]] = None
    # virtual-chunk degrees V tried for "1f1b-interleaved" candidates
    vpp_candidates: Sequence[int] = (2, 4)
    max_pp: Optional[int] = None
    max_tp: Optional[int] = None
    # batch-size exploration grid (Alg. 1 line 2 increments B; we use a
    # geometric+linear grid and stop after everything OOMs)
    batch_grid: Optional[Sequence[int]] = None
    max_batch: int = 4096
    micro_candidates: int = 8                  # how many micro-batch counts to try
    n_bins: int = 256                          # DP memory quantization
    fixed_strategy: Optional[Strategy] = None  # pure-baseline mode
    fixed_pp: Optional[int] = None
    max_adjust_iters: int = 32                 # BMW queue budget per (B, P)
    # search-engine speed knobs (both default on; turning them off recovers
    # the original per-candidate / per-pair behaviour for benchmarking)
    enable_stage_cache: bool = True            # memoize dp_search_stage results
    vectorized_cost: bool = True               # batched (L,S) cost tables
    # memory-budget constraint in bytes; None => cluster.budget().  Distinct
    # from the DP quantization grid: two searches are comparable
    # bin-for-bin only when their ``quant_bytes`` coincide (DESIGN.md §6)
    budget_bytes: Optional[float] = None
    # quantization-grid anchor; None => max of the active budget axis
    # (single-budget searches then quantize on their own budget — the
    # pre-frontier behaviour)
    quant_bytes: Optional[float] = None
    # -- cluster-scale engine knobs ------------------------------------
    # how the outer (B, P) candidates execute: "serial" (the oracle),
    # "threads" / "processes" (pooled fan-out), or "vectorized" (all of a
    # partition's stage DPs batched into one stacked NumPy evaluation).
    # Every backend returns plans byte-identical to "serial".
    search_backend: str = "serial"
    # pool size for threads/processes (None => one worker per core)
    jobs: Optional[int] = None
    # frontier-guided batch-axis pruning: skip (B, P) candidates whose
    # certified optimistic bound is dominated or provably over-budget
    # (needs vectorized_cost for the bound tables; plans stay identical)
    prune_batch_axis: bool = False

    def __post_init__(self):
        if self.search_backend not in SEARCH_BACKENDS:
            raise ValueError(
                f"search_backend must be one of {SEARCH_BACKENDS}, "
                f"got {self.search_backend!r}")
        if self.search_backend == "vectorized" and not self.vectorized_cost:
            raise ValueError(
                "search_backend='vectorized' batches the stage DP over the "
                "(L, S) cost tables and therefore needs vectorized_cost=True")
        if self.jobs is not None and int(self.jobs) < 1:
            raise ValueError(f"jobs must be a positive integer, got {self.jobs}")
        self.batch_grid = normalize_batch_grid(self.batch_grid)


def default_batch_grid(max_batch: int) -> List[int]:
    grid, b = [], 8
    while b <= max_batch:
        grid.append(b)
        b = b + max(8, b // 2)
    return grid


_MISS = object()


class _ShardCache(dict):
    """Worker-local memo shard (parallel sweep, DESIGN.md §6).

    Reads fall through to the shared base cache (filled before the pool
    fanned out, never mutated while workers run); writes stay local and are
    merged back into the base once the worker's (B, P) candidate is done.
    Iteration / ``update()`` expose only the local writes, which is exactly
    what the merge wants.
    """

    def __init__(self, base: dict):
        super().__init__()
        self._base = base

    def get(self, key, default=None):
        v = super().get(key, _MISS)
        if v is not _MISS:
            return v
        return self._base.get(key, default)


class GalvatronOptimizer:
    def __init__(self, specs: Sequence[LayerSpec], cluster: ClusterSpec,
                 config: Optional[OptimizerConfig] = None,
                 cost_config: Optional[CostModelConfig] = None,
                 profiled_times: Optional[Dict[str, float]] = None):
        self.specs = list(specs)
        self.cluster = cluster
        self.cfg = config or OptimizerConfig()
        self._cost_config = cost_config      # kept for process-pool workers
        self.cost = CostModel(cluster, cost_config,
                              profiled_times=profiled_times)
        paradigms = tuple(self.cfg.paradigms)
        if self.cfg.use_sp and SP not in paradigms:
            paradigms = paradigms + (SP,)
        if self.cfg.use_ep and EP not in paradigms:
            paradigms = paradigms + (EP,)
        self.search_space = construct_search_space(
            cluster.n_devices,
            paradigms=paradigms,
            allow_ckpt=self.cfg.allow_ckpt,
            max_pp=(1 if not self.cfg.use_pp else self.cfg.max_pp),
            max_tp=self.cfg.max_tp,
            max_sp=self.cfg.max_sp,
            max_ep=self.cfg.max_ep,
        )
        self.stats: Dict[str, float] = {
            "stage_searches": 0,        # dp_search_stage requests
            "stage_cache_hits": 0,
            "stage_cache_misses": 0,
            "table_builds": 0,          # full-model (L,S) cost-table builds
            "table_hits": 0,
            "bound_evals": 0,           # (B, P) optimistic-bound builds
            "bp_candidates": 0,         # (B, P) outer candidates considered
            "bp_pruned_infeasible": 0,  # skipped: cannot fit any live budget
            "bp_pruned_dominated": 0,   # deferred: cannot beat incumbent
            "bp_forced": 0,             # deferred candidates run anyway (OOM
                                        # bookkeeping; see _sweep_axis)
            "search_seconds": 0.0,
        }
        # memo caches: stage-search results keyed on (layer-range, B_m,
        # inflight, n_micro, strategy-set id) and full-model cost tables
        # keyed on (strategy-set id, B_m, inflight).  budget / n_bins are
        # fixed per optimizer instance, so they are deliberately not part
        # of the keys; the schedule/vpp axis enters stage costs only via
        # ``inflight``, which IS in the key — so the schedule sweep shares
        # entries wherever in-flight counts coincide (e.g. m <= P - i).
        # The caches deliberately persist across optimize() calls on one
        # instance (re-searches after a batch-grid or schedule-axis tweak
        # are mostly hits); ``clear_cache()`` is the escape hatch.
        self._stage_cache: Dict[Tuple, Tuple[StageSearchResult, ...]] = {}
        self._table_cache: Dict[Tuple, CostTables] = {}
        self._ref_cache: Dict[Tuple, Tuple[np.ndarray, np.ndarray]] = {}
        self._part_cache: Dict[Tuple, Tuple[List[int], List[int]]] = {}
        # (B, P) -> CandidateBound for the pruning frontier; budget-
        # independent (bounds compare against the axis at classify time)
        self._bound_cache: Dict[Tuple[int, int], CandidateBound] = {}
        # True only while _sweep_axis runs the "vectorized" backend:
        # _eval_partition then routes stage searches through the stacked DP
        self._batch_eval = False
        # active budget axis: every stage search returns one result per
        # budget (optimize() runs a 1-point axis; sweep_budgets() the full
        # frontier).  The quantization grid is pinned per axis so results
        # are comparable bin-for-bin across its budgets.
        self._budget_axis: Tuple[float, ...] = (self._single_budget(),)
        self._quant: float = (float(self.cfg.quant_bytes)
                              if self.cfg.quant_bytes is not None
                              else max(self._budget_axis))
        # both speed knobs off = seed-faithful baseline (used by
        # benchmarks/bench_search.py): no memoization anywhere
        self._seed_mode = (not self.cfg.enable_stage_cache
                           and not self.cfg.vectorized_cost)
        # layer-content signatures: stage-search results depend on the layer
        # *workloads* in a range, not their positions, so ranges covering
        # identical layer runs (ubiquitous in homogeneous transformer
        # stacks) share one cache entry.  The name enters costs only via the
        # profiled-time lookup, so it is replaced by that lookup's value.
        sig_of: Dict[Tuple, int] = {}
        self._layer_sig = tuple(
            sig_of.setdefault(
                (dataclasses.replace(sp, name=""),
                 self.cost.profiled_times.get(sp.name)),
                len(sig_of))
            for sp in self.specs)

    # ------------------------------------------------------------------
    # budget axis
    # ------------------------------------------------------------------
    def _single_budget(self) -> float:
        return (float(self.cfg.budget_bytes)
                if self.cfg.budget_bytes is not None
                else float(self.cluster.budget()))

    def _set_budget_axis(self, axis: Tuple[float, ...]) -> None:
        """Point the engine at a (sorted) budget axis.

        Stage-search memo entries are axis-shaped (one result per budget),
        so changing the axis drops only ``_stage_cache``; the budget-
        independent caches (cost tables, reference costs, seed partitions)
        survive — that is the incremental-re-search path when only the
        budget changes.
        """
        quant = (float(self.cfg.quant_bytes)
                 if self.cfg.quant_bytes is not None else max(axis))
        if (axis, quant) != (self._budget_axis, self._quant):
            self._stage_cache.clear()
            self._budget_axis, self._quant = axis, quant

    # ------------------------------------------------------------------
    # layer-level reference costs (used for initial partitions)
    # ------------------------------------------------------------------
    def _reference_layer_costs(self, micro_batch: float,
                               group: int) -> Tuple[np.ndarray, np.ndarray]:
        """Per-layer (time, act-memory) under a cheap reference strategy —
        pure data parallel over the stage group (paper's load-balancing
        guideline: #layers/params/exec-time)."""
        key = (micro_batch, group)
        cached = None if self._seed_mode else self._ref_cache.get(key)
        if cached is not None:
            return cached
        ref = Strategy((("dp", group),)) if group > 1 else Strategy(())
        if self.cfg.vectorized_cost:
            tb = self.cost.layer_cost_tables(self.specs, [ref], micro_batch)
            t = tb.time_nosync[:, 0].copy()
            m = (tb.mem_f + tb.mem_ms)[:, 0]
        else:
            t = np.zeros(len(self.specs))
            m = np.zeros(len(self.specs))
            for i, s in enumerate(self.specs):
                c = self.cost.layer_costs(s, ref, micro_batch)
                t[i] = c.time_nosync
                m[i] = c.mem_f + c.mem_ms
        self._ref_cache[key] = (t, m)
        return t, m

    # ------------------------------------------------------------------
    # memoized single-stage search
    # ------------------------------------------------------------------
    def _full_tables(self, strategies: List[Strategy], sid: int,
                     B_m: float, inflight: int) -> Optional[CostTables]:
        """Whole-model (L, S) cost tables, cached per (B_m, inflight) — every
        stage search over any layer range row-slices the same arrays."""
        if not self.cfg.vectorized_cost:
            return None
        key = (sid, B_m, inflight)
        tb = self._table_cache.get(key)
        if tb is None:
            # inflight multiplies exactly one table entry — the forward
            # activation stash mem_f is linear in it (the cost model keeps
            # everything else inflight-independent) — so only the inflight=1
            # base is ever built and others are derived by scaling
            base = self._table_cache.get((sid, B_m, 1))
            if base is None:
                base = self.cost.layer_cost_tables(self.specs, strategies,
                                                   B_m, inflight=1)
                self._table_cache[(sid, B_m, 1)] = base
                self.stats["table_builds"] += 1
            else:
                self.stats["table_hits"] += 1
            tb = (base if inflight == 1 else
                  dataclasses.replace(base, mem_f=base.mem_f * inflight))
            self._table_cache[key] = tb
        else:
            self.stats["table_hits"] += 1
        return tb

    def _stage_search(self, a: int, b: int, strategies: List[Strategy],
                      sid: int, B_m: float, inflight: int,
                      n_micro: int) -> Tuple[StageSearchResult, ...]:
        """Budget-axis stage search over specs[a:b], memoized — one result
        per budget on the active axis from a single forward DP.

        The BMW adjustment queue mostly re-evaluates identical layer ranges
        (a one-layer boundary shift changes only the two adjacent stages),
        the p_t / p_m seed partitions overlap heavily, and every budget on
        the axis shares one memo entry — so the cache turns most of the
        O(P·K) work per candidate into dict lookups.
        """
        self.stats["stage_searches"] += 1
        key = (self._layer_sig[a:b], B_m, inflight, n_micro, sid)
        if self.cfg.enable_stage_cache:
            res = self._stage_cache.get(key)
            if res is not None:
                self.stats["stage_cache_hits"] += 1
                return res
            self.stats["stage_cache_misses"] += 1
        tables = self._full_tables(strategies, sid, B_m, inflight)
        res = tuple(dp_search_stage_budgets(
            self.specs[a:b], strategies, self.cost, B_m,
            self._budget_axis, quant_bytes=self._quant, inflight=inflight,
            n_bins=self.cfg.n_bins, n_micro=n_micro,
            tables=tables.rows(a, b) if tables is not None else None,
            use_tables=self.cfg.vectorized_cost))
        if self.cfg.enable_stage_cache:
            self._stage_cache[key] = res
        return res

    def _stage_search_batch(self, reqs: Sequence[Tuple[int, int, int]],
                            strategies: List[Strategy], sid: int, B_m: float,
                            n_micro: int
                            ) -> List[Tuple[StageSearchResult, ...]]:
        """All of a partition's stage searches as ONE stacked DP.

        ``reqs`` is ``[(a, b, inflight)]`` — one entry per pipeline stage.
        Cache lookups, hit/miss telemetry and writes mirror the serial
        per-stage loop exactly: the first in-batch occurrence of a key is
        the miss, later duplicates are the hits the serial loop would have
        scored against the first occurrence's fresh memo write.  Results
        are byte-identical to per-request :meth:`_stage_search` calls
        (``dp_search_stage_budgets_batch``'s front-padding proof).
        """
        out: List[Optional[Tuple[StageSearchResult, ...]]] = [None] * len(reqs)
        pending: Dict[Tuple, List[int]] = {}   # key -> out indices wanting it
        job_keys: List[Tuple] = []
        job_reqs: List[Tuple[int, int, int]] = []
        for i, (a, b, infl) in enumerate(reqs):
            self.stats["stage_searches"] += 1
            key = (self._layer_sig[a:b], B_m, infl, n_micro, sid)
            if self.cfg.enable_stage_cache:
                res = self._stage_cache.get(key)
                if res is not None:
                    self.stats["stage_cache_hits"] += 1
                    out[i] = res
                    continue
                if key in pending:
                    self.stats["stage_cache_hits"] += 1
                    pending[key].append(i)
                    continue
                self.stats["stage_cache_misses"] += 1
            want = pending.get(key)
            if want is not None:     # cache-disabled duplicate: share the job
                want.append(i)
                continue
            pending[key] = [i]
            job_keys.append(key)
            job_reqs.append((a, b, infl))
        if job_keys:
            jobs = []
            for a, b, infl in job_reqs:
                tb = self._full_tables(strategies, sid, B_m, infl)
                jobs.append((tb.rows(a, b), n_micro))
            batch = dp_search_stage_budgets_batch(
                jobs, strategies, self._budget_axis,
                quant_bytes=self._quant, n_bins=self.cfg.n_bins)
            for key, res_list in zip(job_keys, batch):
                res = tuple(res_list)
                if self.cfg.enable_stage_cache:
                    self._stage_cache[key] = res
                for i in pending[key]:
                    out[i] = res
        return out

    def _strategies_for(self, P: int) -> Tuple[List[Strategy], int]:
        strategies = self.search_space.strategies(P)
        if self.cfg.fixed_strategy is not None:
            strategies = [self.cfg.fixed_strategy]
        return strategies, strategy_set_id(strategies)

    def clear_cache(self) -> None:
        """Drop every memo cache (stage searches, cost tables, reference
        costs, seed partitions, pruning bounds, and the cost model's
        collective-coefficient memo) and zero the telemetry counters.  The caches
        persist across ``optimize()`` calls by design; call this when the
        instance's cost inputs change under it (e.g. mutated
        ``profiled_times``).  A cleared optimizer behaves exactly like a
        freshly constructed one: same plan, same cold-start stats."""
        self._stage_cache.clear()
        self._table_cache.clear()
        self._ref_cache.clear()
        self._part_cache.clear()
        self._bound_cache.clear()
        self.cost.clear_cache()
        for k in self.stats:
            self.stats[k] = 0.0 if k == "search_seconds" else 0

    # ------------------------------------------------------------------
    # pipeline-schedule search axis
    # ------------------------------------------------------------------
    def _schedule_candidates(self, P: int, m: int) -> List[Tuple[str, int]]:
        """(schedule, vpp_degree) candidates swept per (B, P, m).

        ``1f1b-interleaved`` expands over ``cfg.vpp_candidates`` and is
        dropped where it degenerates (P == 1), cannot be laid out
        (P·V > L), or has a ragged last micro-batch group (m % P != 0 —
        the compiled program's bubble then exceeds the analytic
        ``(P-1)/(m·V)`` term, so the model would oversell it);
        ``zb-h1`` is dropped at P == 1 (no bubble to fill — it would
        only add the deferred-W memory term over plain 1f1b) and when
        m < P (the compiled program's bubble exceeds the analytic
        ``(P-1)/(3m)``); single-chunk schedules carry V = 1.
        """
        names = (tuple(self.cfg.schedules) if self.cfg.schedules
                 else (self.cfg.schedule,))
        out: List[Tuple[str, int]] = []
        for name in names:
            if name == "1f1b-interleaved":
                if P <= 1 or m % P:
                    continue
                for v in self.cfg.vpp_candidates:
                    v = int(v)
                    if v > 1 and P * v <= len(self.specs):
                        out.append((name, v))
            elif name == "zb-h1":
                if P > 1 and m >= P:
                    out.append((name, 1))
            else:
                out.append((name, 1))
        if not out:     # zb/interleaved-only request on a degenerate (B, P, m)
            out.append(("1f1b", 1))
        return out

    # ------------------------------------------------------------------
    # per-(B, P, m, partition) evaluation == Galvatron_Search (Alg. 1 l.17)
    # ------------------------------------------------------------------
    def _eval_partition(self, partition: Sequence[int], B: int, m: int,
                        P: int, strategies: Optional[List[Strategy]] = None,
                        sid: Optional[int] = None, schedule: Optional[str] = None,
                        vpp: int = 1,
                        ) -> List[Tuple[float, PartitionEval, List[Strategy]]]:
        """Evaluate one partition on every budget of the active axis.

        Returns one ``(iter_time, PartitionEval, strategies)`` triple per
        budget; the per-stage DP runs once (budget axis inside
        ``_stage_search``), the per-budget assembly here is pure Python.
        """
        B_m = B / m
        schedule = schedule or self.cfg.schedule
        if strategies is None or sid is None:
            strategies, sid = self._strategies_for(P)
        K = len(self._budget_axis)
        if vpp > 1 and min(partition) < vpp:
            # a stage needs >= V layers to be cut into V virtual chunks
            ev = PartitionEval(list(partition), [INF] * P, [INF] * P,
                               [INF] * P, False)
            bad = (INF, ev, [Strategy(())] * sum(partition))
            return [bad] * K
        bounds = stage_bounds(partition)
        infls = [inflight_microbatches(i, P, m, schedule, vpp)
                 for i in range(P)]
        if self._batch_eval:
            per_stage = self._stage_search_batch(
                [(a, b, infl) for (a, b), infl in zip(bounds, infls)],
                strategies, sid, B_m, m)
        else:
            per_stage = [self._stage_search(a, b, strategies, sid, B_m,
                                            infl, m)
                         for (a, b), infl in zip(bounds, infls)]
        out: List[Tuple[float, PartitionEval, List[Strategy]]] = []
        for k in range(K):
            stage_times, stage_ns, stage_mems, all_strats = [], [], [], []
            feasible = True
            for i, (a, b) in enumerate(bounds):
                res = per_stage[i][k]
                if not res.feasible:
                    feasible = False
                    stage_times.append(INF)
                    stage_ns.append(INF)
                    stage_mems.append(INF)
                    all_strats.extend([Strategy(())] * (b - a))
                    continue
                p2p = 0.0
                if P > 1 and b < len(self.specs):
                    dd = res.strategies[-1].data_degree if res.strategies else 1
                    # interleaved: each micro-batch crosses every device
                    # boundary V times (once per virtual chunk)
                    p2p = vpp * self.cost.p2p_cost(self.specs[b - 1], B_m, dd)
                stage_times.append(res.time + p2p)
                stage_ns.append(res.time_nosync + p2p)
                stage_mems.append(res.e_all)
                all_strats.extend(res.strategies)
            ev = PartitionEval(list(partition), stage_times, stage_ns,
                               stage_mems, feasible)
            if not feasible:
                out.append((INF, ev, all_strats))
                continue
            # Eq. 9 (generalized over V and the ZB backward split): steady
            # state paced by the slowest no-sync stage; the drain's bubble
            # term shrinks by 1/V (interleaved) or 1/3 (zb-h1 W refill)
            out.append((pipeline_iter_time(stage_times, stage_ns, m, vpp,
                                           schedule=schedule),
                        ev, all_strats))
        return out

    # ------------------------------------------------------------------
    def _micro_candidates(self, B: int, P: int) -> List[int]:
        cands = []
        m = max(1, P)  # at least P micro-batches to fill a pipeline
        while m <= B and len(cands) < self.cfg.micro_candidates:
            if B % m == 0:
                cands.append(m)
            m *= 2
        if not cands:
            cands = [B]
        return cands

    # ------------------------------------------------------------------
    # frontier-guided batch-axis pruning (optimistic candidate bounds)
    # ------------------------------------------------------------------
    def _max_drain_divisor(self) -> float:
        """Largest bubble-shrink factor any configured schedule can reach —
        the sound (most optimistic) divisor for the pruning bound's drain
        term (``_drain_divisor``: 3 for zb-h1, V for interleaved)."""
        names = (tuple(self.cfg.schedules) if self.cfg.schedules
                 else (self.cfg.schedule,))
        div = 1.0
        for name in names:
            if name == "1f1b-interleaved":
                vs = [int(v) for v in self.cfg.vpp_candidates if int(v) > 1]
                if vs:
                    div = max(div, _drain_divisor(max(vs), name))
            else:
                div = max(div, _drain_divisor(1, name))
        return div

    def _candidate_bound(self, B: int, P: int) -> CandidateBound:
        """Certified optimistic bounds for the (B, P) outer candidate,
        cached per pair (budget-independent).

        Throughput upper bound: for any partition, schedule (divisor
        ``div <= div_max``) and micro-batch count ``m``, the iteration time
        satisfies ``T >= (m-1)·max(Cns) + max(Cns) + (ΣCns - max(Cns))/div
        >= m·ΣCns/P + (P-1)·t_min/div_max`` — sync/p2p/reshard terms only
        add, ``max >= mean``, and each of the other ``P-1`` stages holds at
        least one layer costing at least ``t_min`` (the cheapest layer's
        cheapest strategy's no-sync time).  With ``ΣCns >= Tns_min`` (sum
        of per-layer minima) and maximizing ``B / lb`` over the candidate
        micro-batch counts, no plan of this candidate can beat the result.

        Memory lower bound: every stage's exact DP memory ``e_all`` is the
        sum of its layers' ``mem_f·inflight + mem_ms`` for the chosen
        strategies, and ``inflight >= 1``, so the peak stage memory is at
        least ``max(Σ_l min_s mem_ls / P, max_l min_s mem_ls)``; minimized
        over ``m`` (``mem`` depends on ``B/m``).  The DP's acceptance
        conditions each imply an exact fit (``e_all <= budget``), so
        ``mem_lower > budget`` proves the serial search returns no plan.
        """
        bd = self._bound_cache.get((B, P))
        if bd is not None:
            return bd
        self.stats["bound_evals"] += 1
        strategies, sid = self._strategies_for(P)
        div_max = self._max_drain_divisor()
        tpt_ub, mem_lb = 0.0, INF
        for m in self._micro_candidates(B, P):
            tb = self._full_tables(strategies, sid, B / m, 1)
            tmin = tb.time_nosync.min(axis=1)              # (L,)
            iter_lb = m * float(tmin.sum()) / P
            if P > 1:
                iter_lb += (P - 1) * float(tmin.min()) / div_max
            tpt_ub = max(tpt_ub, B / iter_lb if iter_lb > 0.0 else INF)
            mem_vec = (tb.mem_f + tb.mem_ms).min(axis=1)   # (L,)
            mem_lb = min(mem_lb,
                         max(float(mem_vec.sum()) / P, float(mem_vec.max())))
        bd = CandidateBound(tpt_upper=tpt_ub, mem_lower=mem_lb)
        self._bound_cache[(B, P)] = bd
        return bd

    # ------------------------------------------------------------------
    def _search_pp(self, B: int, P: int) -> Optional[List[Optional[ParallelPlan]]]:
        """Best plan per budget for one (batch, PP degree): Alg. 1 inner
        body crossed with the schedule × vpp axis, plus the Alg. 2
        partition-adjustment queue when bi_objective is on.

        The Alg. 2 queue trajectory depends on the budget (criterion (2) of
        the validation, and which strategies the DP picked), so each budget
        runs its *own* cheap control-flow queue — but all of them draw from
        the same memoized budget-axis stage searches, so the expensive work
        is shared.  A 1-point axis reproduces the pre-frontier serial
        search move for move.
        """
        L = len(self.specs)
        if P > L:
            return None
        K = len(self._budget_axis)
        best: List[Optional[ParallelPlan]] = [None] * K
        strategies, sid = self._strategies_for(P)
        for m in self._micro_candidates(B, P):
          for sched, vpp in self._schedule_candidates(P, m):
            B_m = B / m
            group = self.cluster.n_devices // P
            # per-(m, sched, vpp) eval memo: the per-budget queues revisit
            # mostly the same partitions; the underlying stage searches are
            # already cached, this just skips the per-budget re-assembly
            evals: Dict[Tuple[int, ...],
                        List[Tuple[float, PartitionEval, List[Strategy]]]] = {}

            def ev_of(part):
                pk = tuple(part)
                r = evals.get(pk)
                if r is None:
                    r = self._eval_partition(part, B, m, P, strategies,
                                             sid, sched, vpp)
                    evals[pk] = r
                return r

            if P == 1:
                partitions = [[L]]
                pt_max_mems = [INF] * K
            else:
                pkey = (B_m, group, P, m, sched, vpp)
                seeds = None if self._seed_mode else self._part_cache.get(pkey)
                if seeds is None:
                    t_ref, m_ref = self._reference_layer_costs(B_m, group)
                    seeds = (
                        memory_balanced_partition(m_ref, P, m, sched, vpp),
                        time_balanced_partition(t_ref, P),
                    )
                    self._part_cache[pkey] = seeds
                p_m, p_t = seeds
                # pt_max_mem: criterion (3) reference — max stage memory
                # under the time-balanced partition (per budget)
                ev_ts = ev_of(p_t)
                pt_max_mems = [max(ev_t.stage_mems) if ev_t.feasible else INF
                               for _, ev_t, _ in ev_ts]
                # Alg. 2 seeds the queue with p_m and adjusts toward p_t;
                # p_t itself is also evaluated (the optimum lies between the
                # two extremes, Eq. 7).
                partitions = [p_m, p_t]
            for k, budget in enumerate(self._budget_axis):
                queue = [list(p) for p in partitions]
                seen = {tuple(p) for p in queue}
                iters = 0
                while queue and iters <= self.cfg.max_adjust_iters:
                    part = queue.pop(0)
                    iters += 1
                    t, ev, strats = ev_of(part)[k]
                    # a plan priced at the invalid-strategy poison time is
                    # one the runtime cannot execute (SP-inapplicable layer
                    # or sub-physical per-device batch) — not feasible
                    if ev.feasible and t < _SP_INVALID_TIME:
                        if best[k] is None or B / t > best[k].est_throughput:
                            a_t, a_m = balance_degrees(ev.stage_times,
                                                       ev.stage_mems)
                            best[k] = ParallelPlan(
                                n_devices=self.cluster.n_devices,
                                pp_degree=P, partition=list(part),
                                strategies=strats, global_batch=B, n_micro=m,
                                schedule=sched, vpp_degree=vpp,
                                sp_degree=max((s.sp for s in strats),
                                              default=1),
                                seq_len=max((sp.seq_len
                                             for sp in self.specs),
                                            default=0),
                                ep_degree=max((s.ep for s in strats),
                                              default=1),
                                est_iter_time=t, est_throughput=B / t,
                                est_stage_mem=ev.stage_mems,
                                alpha_t=a_t, alpha_m=a_m)
                        if self.cfg.bi_objective and P > 1:
                            for cand in adjust_partition(part, ev.stage_times):
                                key = tuple(cand)
                                if key in seen:
                                    continue
                                t2, ev2, _ = ev_of(cand)[k]
                                if validate_adjustment(
                                        ev2, max(ev.stage_times),
                                        budget, pt_max_mems[k]):
                                    seen.add(key)
                                    queue.append(cand)
        return best

    # ------------------------------------------------------------------
    def optimize(self, verbose: bool = False) -> Optional[ParallelPlan]:
        """Alg. 1 / Alg. 2 top level: sweep batch sizes, keep best Tpt.

        Repeated calls on one instance reuse the memo caches (hit/miss
        telemetry keeps accumulating in ``self.stats`` and is snapshotted
        into the returned plan's ``search_stats``); ``clear_cache()``
        resets them.

        Args:
          verbose: print every improving (B, P) candidate as it is found.

        Returns:
          The highest-predicted-throughput :class:`ParallelPlan` under
          the configured memory budget (``OptimizerConfig.budget_bytes``,
          default the cluster's), or ``None`` when every candidate OOMs.
        """
        return self._sweep_axis((self._single_budget(),),
                                verbose=verbose)[0]

    def sweep_budgets(self, budgets: Sequence[float], *,
                      parallel: bool = False,
                      max_workers: Optional[int] = None,
                      backend: Optional[str] = None,
                      verbose: bool = False) -> PlanFrontier:
        """Compute the throughput-vs-memory frontier over ``budgets`` in
        ~one search (DESIGN.md §6).

        The stage DP runs once per memo key with a budget *axis* and the
        budget-independent caches (cost tables, reference costs, seed
        partitions) are shared, so a K-point sweep costs close to a single
        ``optimize()`` instead of K of them.  Each budget's plan is
        byte-identical to a serial ``optimize()`` at that budget on the
        same quantization grid (``quant_bytes = max(budgets)`` unless
        pinned in the config).

        Grid-resolution tradeoff: the DP resolves memory in
        ``quant_bytes / n_bins`` steps, so on a wide sweep the small
        budgets are quantized more coarsely than a dedicated search at
        that budget would be (slightly worse plans, possibly a spurious
        OOM right at the feasibility edge).  Pin
        ``cfg.quant_bytes = min(budgets)`` to give every point
        dedicated-search resolution — the larger budgets' scans then span
        proportionally more bins, costing more DP time.

        ``backend`` selects how the independent (B, P) outer candidates
        execute — ``"threads"`` / ``"processes"`` fan them over a pool
        (workers write to private cache shards merged back with their
        hit/miss telemetry), ``"vectorized"`` batches each partition's
        stage DPs into one stacked NumPy evaluation.  Every backend's
        plans are byte-identical to the ``"serial"`` oracle, in any
        interleaving.  ``parallel=True`` is the older spelling of
        ``backend="threads"``.

        Args:
          budgets: memory budgets in bytes (deduplicated and sorted).
          parallel: fan (B, P) candidates over a thread pool.
          max_workers: pool size for pooled backends (default:
            ``cfg.jobs``, else one per core).
          backend: execution backend override (default:
            ``cfg.search_backend``, or ``"threads"`` when ``parallel``).
          verbose: print every improving (B, P, budget) candidate.

        Returns:
          A :class:`~repro_torch.core.frontier.PlanFrontier` with one
          (budget, plan, predicted throughput) point per budget —
          ``plan`` is ``None`` where everything OOMs — plus the
          quantization grid and aggregated search telemetry.

        Raises:
          ValueError: ``budgets`` is empty.
        """
        axis = tuple(sorted({float(b) for b in budgets}))
        if not axis:
            raise ValueError("sweep_budgets needs at least one budget")
        plans = self._sweep_axis(axis, verbose=verbose, parallel=parallel,
                                 max_workers=max_workers, backend=backend)
        points = [FrontierPoint(budget_bytes=b, plan=p,
                                predicted_throughput=(p.est_throughput
                                                      if p else 0.0))
                  for b, p in zip(axis, plans)]
        return PlanFrontier(points=points, quant_bytes=self._quant,
                            search_stats=dict(self.stats))

    def _sweep_axis(self, axis: Tuple[float, ...], *, verbose: bool = False,
                    parallel: bool = False,
                    max_workers: Optional[int] = None,
                    backend: Optional[str] = None,
                    ) -> List[Optional[ParallelPlan]]:
        """Shared Alg. 1 outer loop over a budget axis: per-budget best
        plans, with the per-budget OOM early-stop of the serial search (a
        budget that OOMed at two consecutive batch sizes stops growing B —
        exactly when its serial counterpart would have).

        The candidate execution backend (serial / threads / processes /
        vectorized) and the dominance-frontier pruning are both plan-
        preserving: every path below returns plans byte-identical to the
        serial oracle.  Pruning soundness rests on three pillars:

        * *infeasible* skips are final — ``CandidateBound.mem_lower``
          exceeding a budget proves the serial search would have found no
          plan there, so skipping contributes exactly nothing;
        * *dominated* candidates cannot displace the incumbent (the bound
          certifies their best throughput cannot beat a best that only
          grows, and the sweep improves on strict ``>`` only), but their
          *feasibility* still feeds the two-consecutive-OOM stop — so they
          are deferred, and **forced** to run whenever a budget they were
          deferred for found nothing else this round;
        * forced candidates merge after the live ones, which is safe
          because their plans provably never update ``best`` (order only
          matters for ``best``; ``found`` is an order-free OR).
        """
        t0 = _time.time()
        backend = backend or ("threads" if parallel
                              else self.cfg.search_backend)
        if backend not in SEARCH_BACKENDS:
            raise ValueError(f"unknown search backend {backend!r}; "
                             f"expected one of {SEARCH_BACKENDS}")
        self._set_budget_axis(axis)
        K = len(axis)
        grid = list(normalize_batch_grid(self.cfg.batch_grid)
                    or default_batch_grid(self.cfg.max_batch))
        pp_degrees = [P for P in ([self.cfg.fixed_pp] if self.cfg.fixed_pp
                                  else sorted(self.search_space.per_pp))
                      if P is not None and self.cluster.n_devices % P == 0]
        prune = bool(self.cfg.prune_batch_axis and self.cfg.vectorized_cost)
        frontier = DominanceFrontier(axis) if prune else None
        pool = (_CandidatePool(self, backend, max_workers or self.cfg.jobs)
                if backend in ("threads", "processes") else None)
        self._batch_eval = (backend == "vectorized")
        best: List[Optional[ParallelPlan]] = [None] * K
        active = [True] * K
        try:
            eager: Dict[Tuple[int, int],
                        Optional[List[Optional[ParallelPlan]]]] = {}
            if pool is not None and not prune:
                # eager full fan-out: every (B, P) computed up front (even
                # past a budget's OOM stopping point — the merge below
                # re-applies the serial stopping rule, so nothing changes)
                eager = pool.run_many([(B, P) for B in grid
                                       for P in pp_degrees])
            consecutive_oom = [0] * K
            L = len(self.specs)
            for B in grid:
                if not any(active):
                    break
                found = [False] * K

                def merge(P, plans, B=B, found=found):
                    if plans is None:
                        return
                    for k in range(K):
                        if not active[k] or plans[k] is None:
                            continue
                        found[k] = True
                        if frontier is not None:
                            frontier.observe(k, plans[k].est_throughput)
                        if (best[k] is None or plans[k].est_throughput
                                > best[k].est_throughput):
                            best[k] = plans[k]
                            if verbose:
                                print(
                                    f"[B={B} P={P} "
                                    f"budget={axis[k]/2**30:.1f}G] "
                                    f"tpt={plans[k].est_throughput:.2f} "
                                    f"{plans[k].summary()}")

                if not prune:
                    for P in pp_degrees:
                        self.stats["bp_candidates"] += 1
                        merge(P, eager[(B, P)] if pool is not None
                              else self._search_pp(B, P))
                else:
                    # classify this B's candidates against the frontier
                    # built from all previous batch sizes
                    run_list: List[int] = []
                    deferred: List[Tuple[int, List[int]]] = []
                    for P in pp_degrees:
                        self.stats["bp_candidates"] += 1
                        if P > L:        # _search_pp would return None
                            continue
                        bound = self._candidate_bound(B, P)
                        classes = {k: frontier.classify(k, bound)
                                   for k in range(K) if active[k]}
                        if any(c == "live" for c in classes.values()):
                            run_list.append(P)
                        elif all(c == "infeasible"
                                 for c in classes.values()):
                            self.stats["bp_pruned_infeasible"] += 1
                        else:
                            self.stats["bp_pruned_dominated"] += 1
                            deferred.append(
                                (P, [k for k, c in classes.items()
                                     if c == "dominated"]))
                    if pool is not None:
                        wave = pool.run_many([(B, P) for P in run_list])
                        for P in run_list:
                            merge(P, wave[(B, P)])
                    else:
                        for P in run_list:
                            merge(P, self._search_pp(B, P))
                    # forced pass: a deferred candidate's feasibility may
                    # be all that keeps a budget's OOM counter at zero
                    for P, ks in deferred:
                        if any(not found[k] for k in ks):
                            self.stats["bp_forced"] += 1
                            merge(P, self._search_pp(B, P))
                for k in range(K):
                    if not active[k]:
                        continue
                    consecutive_oom[k] = (0 if found[k]
                                          else consecutive_oom[k] + 1)
                    if consecutive_oom[k] >= 2:  # everything OOMs: stop
                        active[k] = False        # growing B
        finally:
            self._batch_eval = False
            if pool is not None:
                pool.close()
        self.stats["search_seconds"] = _time.time() - t0
        for plan in best:
            if plan is not None:
                plan.search_stats = dict(self.stats)
        return best

    # ------------------------------------------------------------------
    # parallel (B, P) fan-out (DESIGN.md §6)
    # ------------------------------------------------------------------
    def _make_shard(self) -> "GalvatronOptimizer":
        """A worker-view of this optimizer: shares the immutable inputs
        (specs, cost model, search space, budget axis) but writes stage-
        search memo entries and telemetry into private shards, leaving the
        parent's stage cache untouched until merge.

        The table / reference / partition caches are shared *directly*:
        their entries are deterministic, they are never iterated, and
        CPython's GIL makes individual dict get/set atomic — so publishing
        a freshly built cost table immediately spares every other worker
        the same (expensive, budget-independent) build.  A lost race
        merely rebuilds an identical value.
        """
        shard = copy.copy(self)
        shard.stats = {k: (0.0 if k == "search_seconds" else 0)
                       for k in self.stats}
        shard._stage_cache = _ShardCache(self._stage_cache)
        return shard

    def _merge_shard(self, shard: "GalvatronOptimizer") -> None:
        """Fold a worker shard back into the shared memo + telemetry.
        ``update()`` on a shard only sees its local writes; counters are
        summed so hits + misses == lookups holds across the merged stats."""
        for k, v in shard.stats.items():
            if k != "search_seconds":
                self.stats[k] += v
        self._stage_cache.update(shard._stage_cache)

    def _merge_process_result(self, P: int, writes: Dict, stats: Dict) -> None:
        """Fold one process-worker task back into the parent.

        ``writes`` are the worker's stage-cache entries with the worker-
        local strategy-set id *stripped* — ``strategy_set_id`` is an
        insertion-order intern counter, so the worker's ids need not match
        the parent's numbering; the parent re-keys every entry under its
        own id for ``P`` (all writes of one (B, P) task share that one
        strategy set).  Counters are summed, so hits + misses == lookups
        holds across the merged stats."""
        for k, v in stats.items():
            if k in self.stats and k != "search_seconds":
                self.stats[k] += v
        if writes and self.cfg.enable_stage_cache:
            _, sid = self._strategies_for(P)
            for k, v in writes.items():
                self._stage_cache[k + (sid,)] = v


class _CandidatePool:
    """Fan independent (B, P) outer candidates over an executor.

    ``"threads"``: workers are shard views of the parent (shared memo
    caches, private stage-cache shard + telemetry, merged as each task
    completes — DESIGN.md §6).  ``"processes"``: each worker process
    builds its own :class:`GalvatronOptimizer` from the parent's picklable
    constructor arguments (with the serial backend pinned); tasks return
    plans, stage-cache writes and a telemetry delta, which the parent
    merges via ``_merge_process_result``.  Stage-search results are
    deterministic functions of their inputs, so any completion
    interleaving yields the same plans as the serial sweep.
    """

    def __init__(self, opt: GalvatronOptimizer, backend: str,
                 max_workers: Optional[int]):
        self._opt = opt
        self._procs = backend == "processes"
        # one worker per core: the DP is a stream of small NumPy calls, so
        # oversubscription (the executor's cpu+4 default) turns GIL
        # hand-offs into a convoy and *slows the thread sweep several-fold*
        n = max_workers or os.cpu_count() or 2
        if self._procs:
            worker_cfg = dataclasses.replace(
                opt.cfg, search_backend="serial", prune_batch_axis=False,
                jobs=None)
            self._pool = ProcessPoolExecutor(
                max_workers=n, initializer=_process_worker_init,
                initargs=(opt.specs, opt.cluster, worker_cfg,
                          opt._cost_config, dict(opt.cost.profiled_times),
                          opt._budget_axis))
        else:
            self._pool = ThreadPoolExecutor(max_workers=n)

    def run_many(self, bps: Sequence[Tuple[int, int]]
                 ) -> Dict[Tuple[int, int],
                           Optional[List[Optional[ParallelPlan]]]]:
        """Run candidates, merging caches/telemetry into the parent as
        each completes (later tasks then reuse earlier finishers' work)."""
        out: Dict[Tuple[int, int],
                  Optional[List[Optional[ParallelPlan]]]] = {}
        if not bps:
            return out
        opt = self._opt
        if self._procs:
            futures = [self._pool.submit(_process_worker_run, bp)
                       for bp in bps]
            for fut in as_completed(futures):
                bp, plans, writes, stats = fut.result()
                out[bp] = plans
                opt._merge_process_result(bp[1], writes, stats)
            return out

        def run(bp: Tuple[int, int]):
            shard = opt._make_shard()
            return bp, shard._search_pp(*bp), shard

        futures = [self._pool.submit(run, bp) for bp in bps]
        for fut in as_completed(futures):
            bp, plans, shard = fut.result()
            out[bp] = plans
            opt._merge_shard(shard)
        return out

    def close(self) -> None:
        self._pool.shutdown()


# ---- process-pool worker side (module-level for picklability) ------------

_WORKER: Optional[GalvatronOptimizer] = None


def _process_worker_init(specs, cluster, config, cost_config,
                         profiled_times, axis) -> None:
    """Build the worker-resident optimizer once per process; tasks then
    share its memo caches for the worker's lifetime."""
    global _WORKER
    _WORKER = GalvatronOptimizer(specs, cluster, config, cost_config,
                                 profiled_times or None)
    _WORKER._set_budget_axis(tuple(axis))


def _process_worker_run(bp: Tuple[int, int]):
    """One (B, P) candidate in a worker process.

    Runs on a shard (exactly like a thread worker) so the task's fresh
    stage-cache writes and telemetry delta are cleanly separated, then
    folds the shard into the worker-resident optimizer for intra-worker
    reuse.  Returned cache keys have the worker-local strategy-set id
    stripped (see ``_merge_process_result``); every write of the task
    carries the same id — ``_search_pp`` resolves the strategy set once.
    """
    shard = _WORKER._make_shard()
    plans = shard._search_pp(*bp)
    writes = {k[:-1]: v for k, v in shard._stage_cache.items()}
    stats = {k: v for k, v in shard.stats.items() if k != "search_seconds"}
    _WORKER._merge_shard(shard)
    return bp, plans, writes, stats


# --------------------------------------------------------------------------
# convenience constructors for the paper's baselines
# --------------------------------------------------------------------------

def pure_baseline(kind: str, n_devices: int) -> OptimizerConfig:
    """PyTorch-DDP / Megatron-TP / GPipe-PP / FSDP-SDP single-paradigm rows."""
    if kind == "dp":
        return OptimizerConfig(fixed_strategy=Strategy((("dp", n_devices),)),
                               fixed_pp=1, allow_ckpt=False, use_pp=False,
                               bi_objective=False)
    if kind == "sdp":
        return OptimizerConfig(fixed_strategy=Strategy((("sdp", n_devices),)),
                               fixed_pp=1, allow_ckpt=False, use_pp=False,
                               bi_objective=False)
    if kind == "tp":
        return OptimizerConfig(fixed_strategy=Strategy((("tp", n_devices),)),
                               fixed_pp=1, allow_ckpt=False, use_pp=False,
                               bi_objective=False)
    if kind == "pp":
        return OptimizerConfig(fixed_strategy=Strategy(()),
                               fixed_pp=n_devices, allow_ckpt=False,
                               bi_objective=False, schedule="gpipe")
    raise ValueError(kind)


def deepspeed_3d(n_devices: int) -> OptimizerConfig:
    """Expert-designed fixed 3D strategy: 2-way DP x 2-way TP x 2-way PP
    scaled to the device count (officially suggested global combination)."""
    pp = 2
    rest = n_devices // pp
    tp = 2
    dp = rest // tp
    levels = []
    if dp > 1:
        levels.append(("dp", dp))
    if tp > 1:
        levels.append(("tp", tp))
    return OptimizerConfig(fixed_strategy=Strategy(tuple(levels)),
                           fixed_pp=pp, allow_ckpt=False, bi_objective=False)


def galvatron_variant(kind: str) -> OptimizerConfig:
    """'dp+tp' / 'dp+pp' / 'galvatron' (4-dim, no CKPT) / 'base' (5-dim) /
    '1f1b-biobj' (4-dim + balance) / 'bmw' (everything)."""
    if kind == "dp+tp":
        return OptimizerConfig(paradigms=("dp", "tp"), allow_ckpt=False,
                               use_pp=False, bi_objective=False)
    if kind == "dp+pp":
        return OptimizerConfig(paradigms=("dp",), allow_ckpt=False,
                               use_pp=True, bi_objective=False)
    if kind == "galvatron":
        return OptimizerConfig(allow_ckpt=False, bi_objective=False)
    if kind == "base":
        return OptimizerConfig(allow_ckpt=True, bi_objective=False)
    if kind == "1f1b-biobj":
        return OptimizerConfig(allow_ckpt=False, bi_objective=True)
    if kind == "bmw":
        return OptimizerConfig(allow_ckpt=True, bi_objective=True)
    raise ValueError(kind)


def alpa_like() -> "OptimizerConfig":
    """Alpa-style baseline (paper Table VI): automatic inter-op (PP) +
    intra-op parallelism, but SDP is a global either/or choice (no per-layer
    DP/SDP mixing) and activation checkpointing is not searched."""
    return OptimizerConfig(paradigms=("dp", "tp"), allow_ckpt=False,
                           bi_objective=False)


def alpa_like_sdp() -> "OptimizerConfig":
    return OptimizerConfig(paradigms=("sdp", "tp"), allow_ckpt=False,
                           bi_objective=False)
