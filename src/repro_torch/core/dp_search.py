# The port's copy of repro/core/dp_search.py: the same names and arithmetic.
"""Dynamic-programming strategy search (paper §IV-A2, Appendix A).

Optimizes the per-layer strategy assignment of one pipeline stage under a
device memory budget.  Follows the paper's decomposition:

  1. sweep a *forward* memory budget ``E_fwd <= E`` — the DP table is
     computed over all quantized budgets at once (knapsack style),
  2. for each candidate ``E_fwd`` (descending) backtrack the strategy chain
     and verify the exact peak memory ``E_all <= E`` (Eq. 2),
  3. the largest valid ``E_fwd`` wins; ``E_fwd <= E - b_up`` is always valid
     (b_up = max backward peak), which bounds the scan.

The transformation cost R(l, S_i, S_j) is instantiated as
``0 if levels(S_i) == levels(S_j) else r(l, S_j)`` (resharding into layout
S_j); this keeps the paper's claimed O(L·E·|S|) complexity (a general
R(i,j) matrix would cost O(L·E·|S|^2)).

**Budget axis** (DESIGN.md §6): the forward DP table is independent of the
memory budget once the quantization grid is fixed — the budget only selects
where the descending E_fwd scan starts and when a backtracked chain is
accepted.  ``dp_search_stage_budgets`` exploits this: one forward pass,
then a per-budget argmax scan, so a whole budget sweep costs ~one search.
``quant_bytes`` pins the grid (``bin_bytes = quant_bytes / n_bins``);
results for budget ``b`` are bit-identical to a single-budget search at
``b`` run on the same grid.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .cost_model import CostModel, CostTables
from .layerspec import LayerSpec
from .strategy import Strategy, strategy_set_id

INF = float("inf")

# cached per strategy set: levels-group structure of the transformation cost
_GROUP_INFO_CACHE = {}


def _group_info(strategies: Sequence[Strategy]):
    """Group strategies by identical levels (R == 0 within a group).

    enumerate_strategies lists each levels-group contiguously (ckpt pairs);
    when that holds, per-group minima collapse to one reduceat call — and
    when every group additionally has the same size (the common all-ckpt /
    no-ckpt spaces) to an even cheaper reshape + min over the last axis.
    The structure only depends on the strategy list, so it is computed once
    per set.
    """
    sid = strategy_set_id(strategies)
    info = _GROUP_INFO_CACHE.get(sid)
    if info is None:
        S = len(strategies)
        level_key = {}
        group_of = np.zeros(S, dtype=np.int64)
        for j, s in enumerate(strategies):
            group_of[j] = level_key.setdefault(s.levels, len(level_key))
        G = len(level_key)
        group_members = [np.where(group_of == g)[0] for g in range(G)]
        contiguous = bool(np.all(np.diff(group_of) >= 0))
        group_starts = (np.searchsorted(group_of, np.arange(G))
                        if contiguous else None)
        uniform = contiguous and S % G == 0 and bool(
            np.all(np.diff(group_starts) == S // G)) if G else False
        info = (group_of, G, group_members, contiguous, group_starts, uniform)
        _GROUP_INFO_CACHE[sid] = info
    return info


@dataclasses.dataclass
class StageSearchResult:
    feasible: bool
    time: float                     # stage time, last micro-batch (grad sync)
    time_nosync: float              # stage time, earlier micro-batches
    strategies: List[Strategy]
    e_all: float                    # exact peak memory (Eq. 2), bytes
    e_fwd: float                    # forward memory used (Eq. 3), bytes
    mem_states: float               # total model-state bytes per device


def _exact_e_all(mem_f: np.ndarray, mem_b: np.ndarray, mem_ms: np.ndarray,
                 choice: Sequence[int]) -> float:
    """Eq. 2 with a concrete strategy chain."""
    idx = np.arange(len(choice))
    f = mem_f[idx, choice]
    b = mem_b[idx, choice]
    ms_total = mem_ms[idx, choice].sum()
    cum_f = np.cumsum(f)
    return float((cum_f + b).max() + ms_total) if len(choice) else 0.0


def _bin_cap(budget_bytes: float, quant_bytes: float, bin_bytes: float,
             n_bins: int) -> int:
    """Number of quantized bins usable under ``budget_bytes`` on the grid
    anchored at ``quant_bytes`` (budget == quant recovers exactly
    ``n_bins``, including the degenerate ``bin_bytes == 1.0`` clamp)."""
    if budget_bytes >= quant_bytes:
        return max(n_bins, int(budget_bytes / bin_bytes + 1e-9))
    return int(budget_bytes / bin_bytes + 1e-9)


def dp_search_stage(
    specs: Sequence[LayerSpec],
    strategies: Sequence[Strategy],
    cost_model: CostModel,
    micro_batch_size: float,
    budget_bytes: float,
    *,
    quant_bytes: Optional[float] = None,
    inflight: float = 1,
    n_bins: int = 256,
    n_micro: int = 1,
    tables: Optional[CostTables] = None,
    use_tables: bool = True,
) -> StageSearchResult:
    """Search the optimal per-layer strategies for one pipeline stage.

    The DP objective is the m-amortized per-micro-batch time
    ``t_nosync + (t_sync - t_nosync)/m`` — Eq. 9 charges the grad-sync cost
    only on the last of ``n_micro`` micro-batches, so optimizing raw sync
    time would mis-rank strategies with expensive gradient synchronization
    but cheap steady-state micro-batches.

    ``quant_bytes`` anchors the memory quantization grid (default: the
    budget itself, the pre-frontier behaviour); pinning it across calls
    with different budgets makes their results comparable bin-for-bin.

    ``tables`` takes precomputed (L, S) cost arrays (e.g. a row-slice of the
    full-model tables the optimizer caches per (B_m, inflight));
    ``use_tables=False`` dispatches to the seed reference implementation
    (per-pair scalar cost calls + per-strategy Python DP loops), kept as the
    benchmark baseline and differential-test oracle.
    """
    return dp_search_stage_budgets(
        specs, strategies, cost_model, micro_batch_size, [budget_bytes],
        quant_bytes=quant_bytes, inflight=inflight, n_bins=n_bins,
        n_micro=n_micro, tables=tables, use_tables=use_tables)[0]


def dp_search_stage_budgets(
    specs: Sequence[LayerSpec],
    strategies: Sequence[Strategy],
    cost_model: CostModel,
    micro_batch_size: float,
    budgets: Sequence[float],
    *,
    quant_bytes: Optional[float] = None,
    inflight: float = 1,
    n_bins: int = 256,
    n_micro: int = 1,
    tables: Optional[CostTables] = None,
    use_tables: bool = True,
) -> List[StageSearchResult]:
    """Budget-axis stage search: one forward DP, one result per budget.

    The DP table C depends on the budgets only through the shared
    quantization grid (``bin_bytes = quant_bytes / n_bins``), so a whole
    budget sweep runs the O(L·E·|S|) forward pass once; each budget then
    pays only its descending E_fwd scan (backtracked chains are memoized
    per bin and shared across budgets).  Every returned result is
    bit-identical to ``dp_search_stage(..., budget, quant_bytes=quant)``.
    """
    budgets = [float(b) for b in budgets]
    if not budgets:
        return []
    quant = float(quant_bytes) if quant_bytes is not None else max(budgets)

    if tables is None and not use_tables:
        return [dp_search_stage_reference(
                    specs, strategies, cost_model, micro_batch_size, b,
                    quant_bytes=quant, inflight=inflight, n_bins=n_bins,
                    n_micro=n_micro)
                for b in budgets]

    L, S = len(specs), len(strategies)
    if L == 0:
        return [StageSearchResult(True, 0.0, 0.0, [], 0.0, 0.0, 0.0)
                for _ in budgets]

    # ---- per (layer, strategy) cost tables -----------------------------
    if tables is None:
        tables = cost_model.layer_cost_tables(
            specs, strategies, micro_batch_size, inflight=inflight)
    time_sync, time_ns = tables.time_sync, tables.time_nosync
    mem_f, mem_b, mem_ms = tables.mem_f, tables.mem_b, tables.mem_ms
    reshard = tables.reshard
    # DP objective (m-amortized)
    time = time_ns + (time_sync - time_ns) / max(1, n_micro)

    # quantized forward-memory weight of each (layer, strategy)
    bin_bytes = max(quant / n_bins, 1.0)
    caps = [_bin_cap(b, quant, bin_bytes, n_bins) for b in budgets]
    nb_max = max(caps)
    w = np.ceil((mem_f + mem_ms) / bin_bytes).astype(np.int64)   # bins
    # No chain can weigh more than the sum of per-layer maxima (counting
    # only strategies that fit at all), so budget bins above that cap hold
    # exactly the same DP column as the cap bin — shrink the budget axis to
    # it.  The descending E_fwd scan then starts at the cap, which returns
    # the same chain the full-height scan would (identical C columns above).
    w_valid = np.where(w <= nb_max, w, -1)
    per_layer_max = w_valid.max(axis=1)
    if (per_layer_max < 0).any():       # some layer fits under no strategy
        return [StageSearchResult(False, INF, INF, [], INF, INF, 0.0)
                for _ in budgets]
    E = int(min(nb_max, per_layer_max.sum()))

    (group_of, G, group_members, contiguous, group_starts,
     uniform) = _group_info(strategies)

    # ---- DP over (budget_bin, strategy) ---------------------------------
    # C[e, j]: min time of layers processed so far using total fwd-mem <= e
    # bins, with the last layer using strategy j.  The per-layer transition
    # is fully vectorized over (budget_bin, strategy): candidate values are
    # computed at every unshifted budget e', then each strategy column is
    # shifted down by its own weight w[l, j] with one fancy-index gather.
    # No parent pointers are materialized — backtracking re-derives each
    # predecessor from the kept per-layer C tables (cheaper than building
    # (L, E+1, S) argmin tables that are read at most once per chain link).
    ebins = np.arange(E + 1)
    cols = np.arange(S)
    # layers with identical strategy weights (homogeneous stacks) share the
    # same shifted-gather indices — build them once per distinct w row
    shift_cache = {}

    def shift_for(l: int):
        key = w[l].tobytes()
        cached = shift_cache.get(key)
        if cached is None:
            idx = ebins[:, None] - w[l][None, :]    # source bin per (e, j)
            invalid = (idx < 0).ravel()             # also when w[l,j] > E
            np.clip(idx, 0, E, out=idx)
            flat = (idx * S + cols[None, :]).ravel()
            cached = shift_cache[key] = (flat, invalid)
        return cached

    states = []                                  # C after each layer
    C = None
    for l in range(L):
        flat, invalid = shift_for(l)
        if l == 0:
            Cn = np.broadcast_to(time[0][None, :], (E + 1, S)).copy()
        else:
            if uniform and S == 2 * G:          # ckpt pairs: one binary ufunc
                red = np.minimum(C[:, ::2], C[:, 1::2])
            elif uniform:
                red = C.reshape(E + 1, G, S // G).min(axis=2)
            elif contiguous:
                red = np.minimum.reduceat(C, group_starts, axis=1)
            else:
                red = np.empty((E + 1, G))
                for g, members in enumerate(group_members):
                    red[:, g] = C[:, members].min(axis=1)
            best_all = red.min(axis=1)                       # == C.min(axis=1)
            best_grp = red[:, group_of]                      # (E+1, S)
            cross = best_all[:, None] + reshard[l][None, :]  # (E+1, S)
            val = np.minimum(best_grp, cross) + time[l][None, :]
            Cn = val.ravel().take(flat).reshape(E + 1, S)
        Cn.ravel()[invalid] = INF
        states.append(Cn)
        C = Cn

    # ---- per-budget E_fwd sweep with exact E_all validation (Alg. 3) ----
    return _finish_budget_scan(
        states, w, strategies, group_of, group_members,
        time_sync, time_ns, mem_f, mem_b, mem_ms, reshard,
        budgets, caps, bin_bytes, E)


def _finish_budget_scan(
    states: Sequence[np.ndarray],
    w: np.ndarray,
    strategies: Sequence[Strategy],
    group_of: np.ndarray,
    group_members: Sequence[np.ndarray],
    time_sync: np.ndarray,
    time_ns: np.ndarray,
    mem_f: np.ndarray,
    mem_b: np.ndarray,
    mem_ms: np.ndarray,
    reshard: np.ndarray,
    budgets: Sequence[float],
    caps: Sequence[int],
    bin_bytes: float,
    E: int,
) -> List[StageSearchResult]:
    """Backtracking + per-budget descending E_fwd scan over finished DP
    tables (the tail of ``dp_search_stage_budgets``, shared verbatim with
    the batched entry so both produce identical results by construction).

    ``states`` holds the per-layer C tables for the *real* layers only;
    their budget-bin height may exceed ``E + 1`` (the batched path stacks
    jobs to a shared height) — rows above ``E`` are simply never read, and
    rows ``<= E`` are independent of table height because every transition
    reads only equal-or-lower bins (weights are non-negative).
    """
    L = len(states)
    C = states[-1]

    b_up = float(np.max(mem_b)) if L else 0.0    # paper's b_up (max over l, S)

    final_best = C.min(axis=1)                   # per budget bin
    final_arg = C.argmin(axis=1)
    feasible_bins = np.isfinite(final_best)

    def backtrack(e_bin: int) -> np.ndarray:
        """Re-derive the optimal chain ending at budget bin ``e_bin``.

        The predecessor of (l, e, j) is recomputed from C_{l-1}[e - w[l,j]]
        with the same same-group-vs-reshard comparison (and the same argmin
        tie-breaking) the forward pass used, so the recovered chain is
        identical to one backtracked through stored parent pointers.
        """
        chain = np.empty(L, dtype=np.int64)
        j = int(final_arg[e_bin])
        e = e_bin
        chain[L - 1] = j
        for l in range(L - 1, 0, -1):
            e -= int(w[l, j])
            v = states[l - 1][e]
            members = group_members[group_of[j]]
            sub = v[members]
            kg = int(sub.argmin())
            ka = int(v.argmin())
            if sub[kg] <= v[ka] + reshard[l, j]:
                j = int(members[kg])
            else:
                j = ka
            chain[l - 1] = j
        return chain

    # chains (and the expensive per-chain stats) depend on the bin, not the
    # budget — memoize per bin so overlapping budget scans share the work
    chain_cache: Dict[int, Tuple[np.ndarray, float]] = {}
    result_cache: Dict[int, StageSearchResult] = {}

    def chain_at(e_bin: int) -> Tuple[np.ndarray, float]:
        got = chain_cache.get(e_bin)
        if got is None:
            chain = backtrack(e_bin)
            got = (chain, _exact_e_all(mem_f, mem_b, mem_ms, chain))
            chain_cache[e_bin] = got
        return got

    def result_at(e_bin: int) -> StageSearchResult:
        res = result_cache.get(e_bin)
        if res is None:
            chain, e_all = chain_at(e_bin)
            idx = np.arange(L)
            e_fwd_exact = float(sum(mem_f[l, chain[l]] + mem_ms[l, chain[l]]
                                    for l in range(L)))
            t_sync = float(time_sync[idx, chain].sum())
            t_nosync = float(time_ns[idx, chain].sum())
            # add reshard costs along the chain (levels change ⇔ group changes)
            extra = 0.0
            for l in range(1, L):
                if group_of[chain[l]] != group_of[chain[l - 1]]:
                    extra += reshard[l, chain[l]]
            ms_total = float(mem_ms[idx, chain].sum())
            res = StageSearchResult(
                feasible=True,
                time=t_sync + extra,
                time_nosync=t_nosync + extra,
                strategies=[strategies[j] for j in chain],
                e_all=e_all,
                e_fwd=e_fwd_exact,
                mem_states=ms_total,
            )
            result_cache[e_bin] = res
        return res

    out: List[StageSearchResult] = []
    infeasible = StageSearchResult(False, INF, INF, [], INF, INF, 0.0)
    for b, cap in zip(budgets, caps):
        found = infeasible
        for e_bin in range(min(E, cap), -1, -1):
            if not feasible_bins[e_bin]:
                continue
            chain, e_all = chain_at(e_bin)
            if e_all <= b or e_bin * bin_bytes <= b - b_up:
                found = result_at(e_bin)
                break
        out.append(found)
    return out


# --------------------------------------------------------------------------
# batched entry — many stage searches, one stacked forward pass
# --------------------------------------------------------------------------

def dp_search_stage_budgets_batch(
    jobs: Sequence[Tuple[CostTables, int]],
    strategies: Sequence[Strategy],
    budgets: Sequence[float],
    *,
    quant_bytes: float,
    n_bins: int = 256,
) -> List[List[StageSearchResult]]:
    """Run many independent stage searches as ONE stacked NumPy DP.

    ``jobs`` is a sequence of ``(tables, n_micro)`` pairs — each ``tables``
    holds the (L_j, S) cost arrays of one stage (already sliced at the
    right ``B_m`` / inflight), all over the *same* strategy set and the
    same budget axis.  The per-layer DP transition is evaluated for every
    job at once on ``(N, E+1, S)`` arrays instead of N separate Python
    loops — the ``backend="vectorized"`` hot path of the optimizer.

    Byte-identity with N separate ``dp_search_stage_budgets`` calls:

    * jobs are stacked by *front*-padding shorter stages with zero layers
      (zero time/weight/reshard).  A zero prefix leaves the DP table
      identically zero, and the transition into the first real layer
      reproduces the unpadded initialization exactly (the cross term is
      ``0 + reshard >= 0 = same-group``, so ``min`` keeps 0, and the shift
      by ``w`` marks ``e < w`` infeasible — the serial ``l == 0`` case);
    * the stacked tables use the tallest job's bin count, but each job's
      scan/backtrack runs at its own ``E_j``; rows ``<= E_j`` never read
      higher rows (non-negative weights), so extra height is inert;
    * the finisher is literally the serial one (``_finish_budget_scan``)
      on per-job views of the stacked states.
    """
    budgets = [float(b) for b in budgets]
    if not jobs or not budgets:
        return [[] for _ in jobs]
    quant = float(quant_bytes)
    S = len(strategies)
    bin_bytes = max(quant / n_bins, 1.0)
    caps = [_bin_cap(b, quant, bin_bytes, n_bins) for b in budgets]
    nb_max = max(caps)

    (group_of, G, group_members, contiguous, group_starts,
     uniform) = _group_info(strategies)

    empty = [StageSearchResult(True, 0.0, 0.0, [], 0.0, 0.0, 0.0)
             for _ in budgets]
    infeasible = [StageSearchResult(False, INF, INF, [], INF, INF, 0.0)
                  for _ in budgets]

    # ---- per-job prep: amortized time, weights, own scan height ---------
    prepped = []          # (job_index, tables, time, w, E_j)
    out: List[Optional[List[StageSearchResult]]] = [None] * len(jobs)
    for i, (tb, n_micro) in enumerate(jobs):
        L = tb.time_sync.shape[0]
        if L == 0:
            out[i] = list(empty)
            continue
        time = tb.time_nosync + (tb.time_sync - tb.time_nosync) / max(1, n_micro)
        w = np.ceil((tb.mem_f + tb.mem_ms) / bin_bytes).astype(np.int64)
        w_valid = np.where(w <= nb_max, w, -1)
        per_layer_max = w_valid.max(axis=1)
        if (per_layer_max < 0).any():   # some layer fits under no strategy
            out[i] = list(infeasible)
            continue
        E_j = int(min(nb_max, per_layer_max.sum()))
        prepped.append((i, tb, time, w, E_j))
    if not prepped:
        return out  # type: ignore[return-value]

    # ---- stack with zero front-padding to a shared (Lmax, N*S) ----------
    # jobs live side by side as column blocks so every transition below is
    # literally the serial one on a wider table — including its cached
    # shifted-gather flat indices (homogeneous stacks repeat weight rows
    # across both layers and jobs, so the cache hits constantly)
    N = len(prepped)
    Lmax = max(tb.time_sync.shape[0] for _, tb, _, _, _ in prepped)
    E = max(E_j for *_, E_j in prepped)
    W = N * S
    t_stk = np.zeros((Lmax, W))
    w_stk = np.zeros((Lmax, W), dtype=np.int64)
    r_stk = np.zeros((Lmax, W))
    pads = []
    for k, (_, tb, time, w, _) in enumerate(prepped):
        pad = Lmax - time.shape[0]
        pads.append(pad)
        t_stk[pad:, k * S:(k + 1) * S] = time
        w_stk[pad:, k * S:(k + 1) * S] = w
        r_stk[pad:, k * S:(k + 1) * S] = tb.reshard

    # ---- stacked forward DP (the serial transition on N*S columns) ------
    ebins = np.arange(E + 1)
    cols = np.arange(W)
    shift_cache: Dict[bytes, Tuple[np.ndarray, np.ndarray]] = {}

    def shift_for(l: int):
        key = w_stk[l].tobytes()
        cached = shift_cache.get(key)
        if cached is None:
            idx = ebins[:, None] - w_stk[l][None, :]    # source bin per (e, c)
            invalid = (idx < 0).ravel()                 # also when w > E
            np.clip(idx, 0, E, out=idx)
            flat = (idx * W + cols[None, :]).ravel()
            cached = shift_cache[key] = (flat, invalid)
        return cached

    states: List[np.ndarray] = []
    C = None
    for l in range(Lmax):
        flat, invalid = shift_for(l)
        if l == 0:
            Cn = np.broadcast_to(t_stk[0][None, :], (E + 1, W)).copy()
        else:
            C3 = C.reshape(E + 1, N, S)
            if uniform and S == 2 * G:          # ckpt pairs: one binary ufunc
                red = np.minimum(C3[:, :, ::2], C3[:, :, 1::2])
            elif uniform:
                red = C3.reshape(E + 1, N, G, S // G).min(axis=3)
            elif contiguous:
                red = np.minimum.reduceat(C3, group_starts, axis=2)
            else:
                red = np.empty((E + 1, N, G))
                for g, members in enumerate(group_members):
                    red[:, :, g] = C3[:, :, members].min(axis=2)
            best_all = red.min(axis=2)                          # (E+1, N)
            best_grp = red[:, :, group_of]                      # (E+1, N, S)
            cross = (best_all[:, :, None]
                     + r_stk[l].reshape(N, S)[None, :, :])
            val = (np.minimum(best_grp, cross).reshape(E + 1, W)
                   + t_stk[l][None, :])
            Cn = val.ravel().take(flat).reshape(E + 1, W)
        Cn.ravel()[invalid] = INF
        states.append(Cn)
        C = Cn

    # ---- per-job serial finisher on views of the stacked states ---------
    for k, (i, tb, _, w, E_j) in enumerate(prepped):
        pad = pads[k]
        out[i] = _finish_budget_scan(
            [states[l][:, k * S:(k + 1) * S] for l in range(pad, Lmax)],
            w, strategies, group_of, group_members,
            tb.time_sync, tb.time_nosync, tb.mem_f, tb.mem_b, tb.mem_ms,
            tb.reshard, budgets, caps, bin_bytes, E_j)
    return out  # type: ignore[return-value]


# --------------------------------------------------------------------------
# Seed reference implementation (pre-vectorization), verbatim.
#
# Kept for two reasons: it is the baseline `benchmarks/bench_search.py`
# measures the tentpole speedup against, and the differential-test oracle
# the vectorized path must match bit-for-bit (tests/test_search_cache.py).
# --------------------------------------------------------------------------
def dp_search_stage_reference(
    specs: Sequence[LayerSpec],
    strategies: Sequence[Strategy],
    cost_model: CostModel,
    micro_batch_size: float,
    budget_bytes: float,
    *,
    quant_bytes: Optional[float] = None,
    inflight: float = 1,
    n_bins: int = 256,
    n_micro: int = 1,
) -> StageSearchResult:
    """Search the optimal per-layer strategies for one pipeline stage.

    The DP objective is the m-amortized per-micro-batch time
    ``t_nosync + (t_sync - t_nosync)/m`` — Eq. 9 charges the grad-sync cost
    only on the last of ``n_micro`` micro-batches, so optimizing raw sync
    time would mis-rank strategies with expensive gradient synchronization
    but cheap steady-state micro-batches.

    ``quant_bytes`` anchors the bin grid exactly as in ``dp_search_stage``
    (default: the budget itself — the seed behaviour).
    """
    L, S = len(specs), len(strategies)
    if L == 0:
        return StageSearchResult(True, 0.0, 0.0, [], 0.0, 0.0, 0.0)
    quant = float(quant_bytes) if quant_bytes is not None else budget_bytes

    # ---- per (layer, strategy) cost tables -----------------------------
    time = np.full((L, S), INF)       # DP objective (m-amortized)
    time_sync = np.full((L, S), INF)  # raw last-micro-batch time
    time_ns = np.full((L, S), INF)
    mem_f = np.zeros((L, S))
    mem_b = np.zeros((L, S))
    mem_ms = np.zeros((L, S))
    reshard = np.zeros((L, S))
    for l, spec in enumerate(specs):
        for j, s in enumerate(strategies):
            c = cost_model.layer_costs(spec, s, micro_batch_size, inflight=inflight)
            time[l, j] = c.time_nosync + (c.time - c.time_nosync) / max(1, n_micro)
            time_sync[l, j] = c.time
            time_ns[l, j] = c.time_nosync
            mem_f[l, j] = c.mem_f
            mem_b[l, j] = c.mem_b
            mem_ms[l, j] = c.mem_ms
            reshard[l, j] = cost_model.reshard_cost(spec, s, micro_batch_size)

    # quantized forward-memory weight of each (layer, strategy)
    bin_bytes = max(quant / n_bins, 1.0)
    w = np.ceil((mem_f + mem_ms) / bin_bytes).astype(np.int64)   # bins
    E = _bin_cap(budget_bytes, quant, bin_bytes, n_bins)

    # strategies grouped by identical levels (R == 0 within a group)
    level_key = {}
    group_of = np.zeros(S, dtype=np.int64)
    for j, s in enumerate(strategies):
        group_of[j] = level_key.setdefault(s.levels, len(level_key))
    G = len(level_key)
    group_members = [np.where(group_of == g)[0] for g in range(G)]

    # ---- DP over (budget_bin, strategy) ---------------------------------
    # C[e, j]: min time of layers processed so far using total fwd-mem <= e
    # bins, with the last layer using strategy j.
    C = np.full((E + 1, S), INF)
    parents = np.zeros((L, E + 1, S), dtype=np.int16)

    for l in range(L):
        Cn = np.full((E + 1, S), INF)
        if l == 0:
            for j in range(S):
                if w[0, j] <= E:
                    Cn[w[0, j]:, j] = time[0, j]
                    parents[0, :, j] = -1
        else:
            best_all = C.min(axis=1)                        # (E+1,)
            arg_all = C.argmin(axis=1)                      # (E+1,)
            best_grp = np.full((E + 1, G), INF)
            arg_grp = np.zeros((E + 1, G), dtype=np.int64)
            for g, members in enumerate(group_members):
                sub = C[:, members]
                k = sub.argmin(axis=1)
                best_grp[:, g] = sub[np.arange(E + 1), k]
                arg_grp[:, g] = members[k]
            for j in range(S):
                wj = w[l, j]
                if wj > E:
                    continue
                n_src = E + 1 - wj
                src = np.arange(0, n_src)
                same = best_grp[src, group_of[j]]
                cross = best_all[src] + reshard[l, j]
                take_same = same <= cross
                val = np.where(take_same, same, cross) + time[l, j]
                par = np.where(take_same, arg_grp[src, group_of[j]], arg_all[src])
                Cn[wj:, j] = val
                parents[l, wj:, j] = par
        C = Cn

    # ---- E_fwd sweep with exact E_all validation (Alg. 3) ---------------
    b_up = float(np.max(mem_b)) if L else 0.0    # paper's b_up (max over l, S)

    final_best = C.min(axis=1)                   # per budget bin
    final_arg = C.argmin(axis=1)

    def backtrack(e_bin: int) -> Optional[List[int]]:
        j = int(final_arg[e_bin])
        if not np.isfinite(final_best[e_bin]):
            return None
        chain = [0] * L
        e = e_bin
        for l in range(L - 1, -1, -1):
            chain[l] = j
            pj = int(parents[l, e, j])
            e = e - int(w[l, j])
            j = pj
        return chain

    for e_bin in range(E, -1, -1):
        if not np.isfinite(final_best[e_bin]):
            continue
        chain = backtrack(e_bin)
        if chain is None:
            continue
        e_all = _exact_e_all(mem_f, mem_b, mem_ms, chain)
        e_fwd_exact = float(sum(mem_f[l, chain[l]] + mem_ms[l, chain[l]]
                                for l in range(L)))
        if e_all <= budget_bytes or e_bin * bin_bytes <= budget_bytes - b_up:
            idx = np.arange(L)
            t_sync = float(time_sync[idx, chain].sum())
            t_nosync = float(time_ns[idx, chain].sum())
            # add reshard costs along the chain
            extra = 0.0
            for l in range(1, L):
                if strategies[chain[l]].levels != strategies[chain[l - 1]].levels:
                    extra += reshard[l, chain[l]]
            ms_total = float(mem_ms[idx, chain].sum())
            return StageSearchResult(
                feasible=True,
                time=t_sync + extra,
                time_nosync=t_nosync + extra,
                strategies=[strategies[j] for j in chain],
                e_all=e_all,
                e_fwd=e_fwd_exact,
                mem_states=ms_total,
            )

    return StageSearchResult(False, INF, INF, [], INF, INF, 0.0)
