# The port's copy of repro/core/pipeline_balance.py: the same names and arithmetic.
"""Pipeline workload balance (paper §IV-B).

1F1B-Flush keeps ``P - i`` micro-batches in flight on (0-indexed) stage
``i``, so shallower stages hold more activation memory — the memory workload
is imbalanced even when the time workload is perfect.  This module provides:

  * balance degrees α_t / α_m (Eq. 6),
  * extreme partitions p_t (time-balanced) and p_m (memory-balanced),
  * the greedy boundary-layer adjustment + the 3-criterion validation of
    §IV-B2 (every accepted partition satisfies Eq. 7/8).
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import numpy as np

INF = float("inf")


# fraction of a full per-micro-batch activation set a deferred W tick
# retains: the weight gradient needs each layer's *input* activation (and
# the incoming cotangent), but the activation-gradient chain through the
# intermediates is already consumed by the B tick — charge half a set
ZB_W_ACT_FRAC = 0.5


def zb_w_pending_max(stage: int, n_stages: int, n_micro: int) -> int:
    """Deepest completed-B-but-pending-W pile the compiled ZB-H1 program
    accumulates on (0-indexed) ``stage``: ``max(1, m - P + 1 + i)``.

    W ticks are deferred until a stage has nothing on the critical path
    (no ready B, no F under the in-flight cap), so deep stages — which run
    out of F work last — bank the most weight-gradient state.  This is
    the memory side of the zero-bubble trade: the greedy compiler
    (``runtime/schedules.py::_compile_zb_h1``) realizes exactly this
    depth (asserted by ``tests/test_pipeline_schedules.py``), and
    :func:`inflight_microbatches` charges :data:`ZB_W_ACT_FRAC` of an
    activation set per pending W using the same formula — one definition,
    priced and executed."""
    return max(1, n_micro - n_stages + 1 + stage)


def inflight_microbatches(stage: int, n_stages: int, n_micro: int,
                          schedule: str = "1f1b", vpp: int = 1) -> float:
    """In-flight micro-batch activation sets on one stage, in units of the
    stage's *full* forward activation footprint (the cost model multiplies
    a stage's per-micro-batch activation bytes by this).

    * ``gpipe``: every micro-batch is stashed — ``m``.
    * ``1f1b`` (flush): stage ``i`` (0-indexed) warms up ``P - i``
      micro-batches before its first backward.
    * ``1f1b-interleaved`` with ``V = vpp`` chunks: the depth-first
      Megatron schedule warms up ``2·(P-1-i) + (V-1)·P`` forward *chunks*
      on device ``i``, plus one in steady state, capped at the ``m·V``
      chunks that exist.  Each chunk's activations are ``1/V`` of the
      stage's, so the per-chunk count divides by ``V`` — fractional
      full-stage units (the per-chunk accounting of DESIGN.md §5).
    * ``zb-h1``: the forward stash keeps the 1F1B profile
      (``min(P - i, m)`` — the compiler enforces the same in-flight cap),
      but every deferred weight-gradient tick banks
      :data:`ZB_W_ACT_FRAC` of a set until it runs; the compiled
      deferral depth is :func:`zb_w_pending_max`.  This is the memory
      price of the near-zero bubble — strictly above 1F1B on every
      stage, approaching it as ``m`` shrinks toward ``P``.
    """
    if schedule == "gpipe":
        return n_micro
    if schedule == "zb-h1":
        return (min(n_stages - stage, n_micro)
                + ZB_W_ACT_FRAC * zb_w_pending_max(stage, n_stages, n_micro))
    if schedule == "1f1b-interleaved" and vpp > 1:
        chunks = min(2 * (n_stages - stage - 1) + (vpp - 1) * n_stages + 1,
                     n_micro * vpp)
        return chunks / vpp
    # 1F1B-flush: stage i (0-indexed) warms up P - i micro-batches
    return min(n_stages - stage, n_micro)


def stage_bounds(partition: Sequence[int]) -> List[Tuple[int, int]]:
    """[(start, end)) layer index ranges of each stage."""
    out, s = [], 0
    for p in partition:
        out.append((s, s + p))
        s += p
    return out


def balance_degrees(stage_times: Sequence[float],
                    stage_mems: Sequence[float]) -> Tuple[float, float]:
    """α_t, α_m of Eq. 6."""
    t, m = np.asarray(stage_times, float), np.asarray(stage_mems, float)
    a_t = 1.0 - t.max() / t.sum() if t.sum() > 0 else 0.0
    a_m = 1.0 - m.max() / m.sum() if m.sum() > 0 else 0.0
    return float(a_t), float(a_m)


def _partition_minimize_max(loads: np.ndarray, P: int,
                            stage_weight=None) -> List[int]:
    """Contiguous partition of ``loads`` into P parts minimizing the maximum
    (optionally stage-weighted) part sum.  O(P * L^2) DP — exact.

    ``stage_weight(i)`` multiplies the load of stage i (used for 1F1B
    in-flight activation weighting when balancing memory).
    """
    L = len(loads)
    prefix = np.concatenate([[0.0], np.cumsum(loads)])
    weight = [stage_weight(i) if stage_weight else 1.0 for i in range(P)]

    # dp[i][l] = min over partitions of first l layers into i+1 stages of max load
    dp = np.full((P, L + 1), INF)
    cut = np.zeros((P, L + 1), dtype=np.int64)
    dp[0, 1:] = (prefix[1:] - prefix[0]) * weight[0]
    for i in range(1, P):
        # vectorized over the cut point k: stage i spans (k, l]
        for l in range(i + 1, L + 1):
            ks = np.arange(i, l)
            v = np.maximum(dp[i - 1, ks], (prefix[l] - prefix[ks]) * weight[i])
            bk = int(v.argmin())
            dp[i, l] = v[bk]
            cut[i, l] = i + bk
    # backtrack
    parts = []
    l = L
    for i in range(P - 1, 0, -1):
        k = int(cut[i, l])
        parts.append(l - k)
        l = k
    parts.append(l)
    parts.reverse()
    return parts


def time_balanced_partition(layer_times: Sequence[float], P: int) -> List[int]:
    return _partition_minimize_max(np.asarray(layer_times, float), P)


def memory_balanced_partition(layer_mems: Sequence[float], P: int,
                              n_micro: int, schedule: str = "1f1b",
                              vpp: int = 1) -> List[int]:
    """Balance act-memory × 1F1B in-flight weight across stages."""
    return _partition_minimize_max(
        np.asarray(layer_mems, float), P,
        stage_weight=lambda i: inflight_microbatches(i, P, n_micro, schedule,
                                                     vpp))


def adjust_partition(partition: Sequence[int],
                     stage_times: Sequence[float]) -> List[List[int]]:
    """Greedy adjustment (§IV-B2): shed a boundary layer from the slowest
    stage to its adjacent stage(s).  Returns candidate new partitions."""
    p = list(partition)
    P = len(p)
    slow = int(np.argmax(stage_times))
    candidates = []
    if p[slow] > 1:
        if slow > 0:
            q = list(p)
            q[slow] -= 1
            q[slow - 1] += 1
            candidates.append(q)
        if slow < P - 1:
            q = list(p)
            q[slow] -= 1
            q[slow + 1] += 1
            candidates.append(q)
    return candidates


@dataclasses.dataclass
class PartitionEval:
    partition: List[int]
    stage_times: List[float]        # per-stage C(M_i, B_m) (sync variant)
    stage_times_nosync: List[float]
    stage_mems: List[float]
    feasible: bool


def validate_adjustment(new: PartitionEval, prev_max_time: float,
                        budget: float, pt_max_mem: float) -> bool:
    """The three §IV-B2 criteria: (1) no stage slower than the previous
    maximum, (2) all stages within budget, (3) no stage above the
    time-balanced partition's maximum memory."""
    if not new.feasible:
        return False
    if max(new.stage_times) > prev_max_time + 1e-12:
        return False
    if max(new.stage_mems) > budget:
        return False
    if max(new.stage_mems) > pt_max_mem + 1e-6:
        return False
    return True
