# The port's copy of repro/core/cost_model.py: the same names and arithmetic.
"""Cost estimator (paper §V + Appendix C/D).

Estimates, for one layer under one hybrid strategy:
  * ``O_f``  — forward activation memory per device,
  * ``O_b``  — extra backward peak memory per device (CKPT recompute),
  * ``O_ms`` — model-state memory per device (params + grads + optimizer),
  * ``c``    — execution time (fwd + bwd, incl. communication, the CKPT
               recompute forward, and the computation/communication
               *overlap slowdown* the paper emphasizes).

Two time variants are produced: ``time`` (last micro-batch — includes DP/SDP
gradient synchronization) and ``time_nosync`` (earlier micro-batches), used
by the 1F1B pipeline cost Eq. 9.

Communication volume factors follow §III-A2:
  DP   all-reduce(grads)            : 2 (N-1)/N * bytes
  SDP  2x all-gather + reduce-scatter: 3 (N-1)/N * bytes  (1.5x DP)
  TP   all-reduce(activations) fwd+bwd
  MoE  all-to-all dispatch/combine when experts are sharded over TP level
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .hardware import ClusterSpec
from .layerspec import LayerSpec
from .strategy import DP, EP, SDP, SP, TP, Strategy

# which profiled collective prices which paradigm's traffic
_PARADIGM_COLLECTIVE = {
    TP: "all_reduce",        # activation all-reduce (fwd + bwd)
    DP: "all_reduce",        # gradient all-reduce
    SDP: "all_gather",       # param all-gather (reduce-scatter priced apart)
    SP: "ppermute",          # ring-attention K/V panel hand-off
    EP: "all_to_all",        # MoE token dispatch/combine (no profile kind is
                             # recorded for it, so collective_coeffs always
                             # returns the analytic (0.0, bandwidth) pair)
}

# finite poison for (layer, strategy) pairs SP cannot execute (sequence not
# divisible, recurrent kind, no sequence axis).  Kept finite — a true inf
# would turn the DP objective's ``t_ns + (t_s - t_ns)/m`` into NaN — but
# large enough that any plan containing one loses to every real plan.
_SP_INVALID_TIME = 1e30


def _sp_applicable(spec: LayerSpec, sp: int) -> bool:
    """Can this layer run sequence-sharded at degree ``sp``?

    SSM layers carry a sequential state scan that the ring hand-off does
    not implement, and a layer without a sequence axis (or one ``sp``
    does not divide) cannot shard tokens evenly."""
    if sp <= 1:
        return True
    return (spec.seq_len > 0 and spec.seq_len % sp == 0
            and spec.kind != "ssm")


def _ep_applicable(spec: LayerSpec, ep: int) -> bool:
    """Can this layer run expert-sharded at degree ``ep``?

    Only MoE layers carry experts, and the expert axis must divide the
    expert count evenly (ragged expert placement is not modeled)."""
    if ep <= 1:
        return True
    return spec.n_experts > 1 and spec.n_experts % ep == 0


# --------------------------------------------------------------------------
# pipeline-schedule time terms (paper Eq. 5/9, generalized with interleaved
# virtual stages — DESIGN.md §5)
# --------------------------------------------------------------------------

def _drain_divisor(vpp: int, schedule: str) -> float:
    """By how much a schedule shrinks the non-critical drain/bubble term.

    Interleaving splits the drain into ``V×`` smaller chunks; ZB-H1 fills
    two thirds of the flush bubble with deferred W ticks under the
    unit-tick assumption ``T_F = T_B = T_W`` (forward : activation-grad :
    weight-grad = 1 : 1 : 1 — the compiled program's bubble is exactly
    ``P - 1`` of ``3(P-1)`` 1F1B-equivalent unit ticks, see
    ``runtime/schedules.py::_compile_zb_h1``)."""
    return 3.0 * vpp if schedule == "zb-h1" else float(vpp)


def bubble_fraction(n_stages: int, n_micro: int, vpp: int = 1,
                    schedule: str = "1f1b") -> float:
    """Pipeline fill/drain overhead relative to the ideal per-stage work.

    ``(P - 1) / (m · V)`` for the flush family — ``vpp = 1`` recovers the
    classic ``(P - 1) / m`` of GPipe / 1F1B; interleaving V virtual
    chunks per device shrinks the bubble by ``V×``.  ``zb-h1`` fills the
    remaining bubble with deferred weight-gradient ticks, leaving
    ``(P - 1) / (3·m)`` — one third of 1F1B's (near zero as ``m`` grows).

    Args:
      n_stages: pipeline depth ``P``.
      n_micro: micro-batches per iteration ``m``.
      vpp: virtual chunks per stage ``V`` (only > 1 for interleaved).
      schedule: schedule name; only ``"zb-h1"`` changes the formula.
    """
    return (n_stages - 1) / (n_micro * _drain_divisor(vpp, schedule))


def pipeline_iter_time(stage_times: Sequence[float],
                       stage_times_nosync: Sequence[float],
                       n_micro: int, vpp: int = 1,
                       schedule: str = "1f1b") -> float:
    """Eq. 9 generalized over virtual-chunk degree ``V = vpp`` and the
    zero-bubble backward split.

    ``V = 1``: ``(m-1) · max(C_nosync) + Σ C_sync`` — the slowest stage
    paces the ``m-1`` steady-state micro-batches and the last micro-batch
    drains through every stage.

    ``V > 1``: the drain traverses ``P·V`` *chunks* of ``1/V`` a stage's
    work each, so the non-critical stages' drain contribution divides by
    ``V`` (the critical stage still runs its full per-micro-batch work):
    ``(m-1) · max(C_nosync) + max(C_sync) + (Σ C_sync - max(C_sync)) / V``.
    For homogeneous stages of cost ``t`` this is ``m·t + (P-1)·t/V`` —
    exactly the ``(P-1)/(m·V)`` bubble of :func:`bubble_fraction`.

    ``schedule="zb-h1"``: deferred W ticks refill two thirds of the
    flush drain (unit-tick model), so the non-critical term divides by 3
    instead — homogeneous stages cost ``m·t + (P-1)·t/3``.

    Args:
      stage_times: per-stage cost incl. gradient sync (last micro-batch).
      stage_times_nosync: per-stage cost without DP/SDP gradient sync.
      n_micro: micro-batches ``m``.
      vpp: virtual-chunk degree ``V``.
      schedule: schedule name; only ``"zb-h1"`` changes the formula.

    Returns:
      Modeled seconds per training iteration.
    """
    mx = max(stage_times)
    return ((n_micro - 1) * max(stage_times_nosync)
            + mx + (sum(stage_times) - mx) / _drain_divisor(vpp, schedule))


@dataclasses.dataclass(frozen=True)
class LayerCosts:
    time: float           # seconds, fwd+bwd incl. grad sync (last micro-batch)
    time_nosync: float    # seconds, fwd+bwd without DP/SDP grad sync
    mem_f: float          # O_f bytes per device
    mem_b: float          # O_b bytes per device
    mem_ms: float         # O_ms bytes per device
    time_fwd: float = 0.0


@dataclasses.dataclass(frozen=True)
class CostTables:
    """Batched per-(layer, strategy) cost arrays, all shaped (L, S).

    Produced by :meth:`CostModel.layer_cost_tables` with NumPy broadcasting —
    numerically identical to calling :meth:`CostModel.layer_costs` /
    :meth:`CostModel.reshard_cost` for every pair, but one vectorized pass
    instead of ``L x S`` Python calls (the strategy-search hot path).
    """

    time_sync: np.ndarray     # LayerCosts.time
    time_nosync: np.ndarray   # LayerCosts.time_nosync
    time_fwd: np.ndarray      # LayerCosts.time_fwd
    mem_f: np.ndarray
    mem_b: np.ndarray
    mem_ms: np.ndarray
    reshard: np.ndarray       # CostModel.reshard_cost per (layer, strategy)

    def rows(self, a: int, b: int) -> "CostTables":
        """Zero-copy view of the layer range [a, b) — per-layer costs do not
        depend on neighbouring layers, so full-model tables slice freely."""
        return CostTables(*(getattr(self, f.name)[a:b]
                            for f in dataclasses.fields(self)))


@dataclasses.dataclass(frozen=True)
class CostModelConfig:
    bytes_per_param_states: float = 16.0  # fp16 p + fp16 g + fp32 (p, m, v)
    bytes_per_param: float = 2.0          # live copy used in compute
    act_bytes: float = 2.0
    mfu: float = 0.45                     # achieved fraction of peak compute
    # TP-replicated activation bytes per layer = this many boundary-sized
    # tensors (Megatron keeps LN inputs + residuals replicated — a fixed
    # ~2 x (seq x hidden), NOT a fraction of the intermediate, which would
    # wildly overcharge attention-matrix-heavy layers)
    tp_act_replicated_bnd: float = 2.0
    # when True expert weights are sharded along the TP level (expert
    # parallelism) and token dispatch uses all-to-all
    moe_expert_parallel_tp: bool = True
    # physical per-device batch floor: strategies whose DP/SDP span leaves
    # fewer than this many samples per device are marked infeasible (poison
    # time, finite memory).  The paper's linear model admits fractional
    # b_dev — 8 devices "sharing" one sequence — which data parallelism
    # cannot execute; with the floor at 1.0, sequence parallelism becomes
    # the only axis that splits a single long sequence (the long-context
    # regime, docs/architecture.md §SP).  0.0 (default) keeps the
    # unconstrained paper model, bit-identical to prior searches.
    min_samples_per_device: float = 0.0
    # expert-imbalance slowdown fed into the workload-balance objective:
    # the hot EP rank is modeled as carrying (1 + ep_imbalance * (ep-1)/ep)x
    # its fair token share (routing skew grows with the expert-group size),
    # inflating both the expert compute and the all-to-all payload of
    # ep > 1 strategies.  0.0 (default) models perfectly balanced routing —
    # bit-identical to searches that never price EP.
    ep_imbalance: float = 0.0


class CostModel:
    def __init__(self, cluster: ClusterSpec,
                 config: Optional[CostModelConfig] = None,
                 profiled_times: Optional[dict] = None):
        self.cluster = cluster
        self.cfg = config or CostModelConfig()
        # {layer name: measured forward seconds/sample} — paper §V profiling
        self.profiled_times = profiled_times or {}
        # (kind, group_size) -> (latency_s, bandwidth); tiny, but sits on
        # the per-(layer, strategy) hot path.  Part of the clear_cache()
        # contract: GalvatronOptimizer.clear_cache() calls clear_cache()
        # here too so swapping cluster profiles under a live instance
        # cannot serve stale coefficients.
        self._coeff_cache: Dict[Tuple[str, int], Tuple[float, float]] = {}

    def clear_cache(self) -> None:
        """Drop the collective-coefficient memo (profiled-constants cache)."""
        self._coeff_cache.clear()

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _group_coeffs(self, kind: str, group_size: int) -> Tuple[float, float]:
        """Memoized ``ClusterSpec.collective_coeffs`` (``group_size == -1``
        selects the pipeline hand-off pair, ``ClusterSpec.p2p_coeffs``)."""
        key = (kind, group_size)
        out = self._coeff_cache.get(key)
        if out is None:
            if group_size == -1:
                out = self.cluster.p2p_coeffs()
            else:
                out = self.cluster.collective_coeffs(kind, group_size)
            self._coeff_cache[key] = out
        return out

    def _level_span(self, strat: Strategy, paradigm: str) -> int:
        """Device-group size a paradigm's collective spans (1 if absent).

        Levels are ordered outer→inner; a level's collective runs between
        device blocks of size = product of inner degrees, so its *span* is
        its degree times everything inside it.  Outer levels straddle slower
        boundaries on hierarchical clusters.
        """
        span = 1
        for p, k in reversed(strat.levels):
            span *= k
            if p == paradigm:
                return span
        return 1

    def _level_coeffs(self, strat: Strategy, paradigm: str,
                      kind: Optional[str] = None) -> Tuple[float, float]:
        """(latency_s, bandwidth) for a paradigm's collective under this
        strategy — profiled when the cluster carries measurements for
        ``kind`` and the group fits in an island, analytic otherwise."""
        return self._group_coeffs(kind or _PARADIGM_COLLECTIVE[paradigm],
                                  self._level_span(strat, paradigm))

    def _level_bandwidth(self, strat: Strategy, paradigm: str) -> float:
        """Bandwidth of the device group a paradigm's collective spans."""
        return self._level_coeffs(strat, paradigm)[1]

    @staticmethod
    def _ring_factor(n: int) -> float:
        return (n - 1) / n if n > 1 else 0.0

    def _overlap(self, comp: float, comm: float) -> float:
        """Overlapped comp & comm with the paper's contention slowdown."""
        if comp <= 0.0:
            return comm
        if comm <= 0.0:
            return comp
        sd = self.cluster.device.overlap_slowdown
        return max(comp * sd, comm * sd)

    # ------------------------------------------------------------------
    # main entry
    # ------------------------------------------------------------------
    def layer_costs(self, spec: LayerSpec, strat: Strategy,
                    micro_batch_size: float, *,
                    inflight: float = 1) -> LayerCosts:
        cfg = self.cfg
        dev = self.cluster.device
        dp, sdp, tp, sp = strat.dp, strat.sdp, strat.tp, strat.sp
        ep = strat.ep
        data_deg = dp * sdp
        b_dev = micro_batch_size / data_deg
        # hot-rank routing skew (1.0 when ep == 1 or imbalance not modeled)
        ep_imb = 1.0 + cfg.ep_imbalance * self._ring_factor(ep)

        # ---- memory: model states -------------------------------------
        p_tp = spec.param_count * spec.tp_frac
        p_rep = spec.param_count * (1.0 - spec.tp_frac)
        params_dev = p_tp / tp + p_rep          # after TP sharding
        # EP shards the expert slab (a subset of the TP-shardable params)
        # ep ways; everything else is replicated across the expert group
        p_exp_dev = spec.param_count * spec.expert_param_frac / tp
        if ep > 1:
            params_dev = params_dev - p_exp_dev + p_exp_dev / ep
        ms = cfg.bytes_per_param_states * params_dev / sdp

        # ---- memory: activations ---------------------------------------
        # SP shards the sequence axis: every activation tensor holds S/sp
        # tokens per device — the workload-balance lever long context needs
        bnd_dev = spec.bnd_bytes_per_sample * b_dev / sp
        int_dev = spec.int_bytes_per_sample * b_dev / sp / tp
        if ep > 1:
            # the expert group also shards tokens (DP-like for the dense
            # part); routed-expert activations are capacity-padded
            int_exp = (spec.int_bytes_per_sample * spec.expert_act_frac
                       * b_dev / sp / tp)
            bnd_dev = bnd_dev / ep
            int_dev = ((int_dev - int_exp) / ep
                       + int_exp * spec.capacity_factor / ep)
        if tp > 1:
            int_dev += cfg.tp_act_replicated_bnd * bnd_dev
        if strat.ckpt:
            mem_f = bnd_dev * inflight
            mem_b = int_dev
        else:
            mem_f = (bnd_dev + int_dev) * inflight
            mem_b = 0.0

        # ---- compute time ----------------------------------------------
        if spec.name in self.profiled_times:
            # profiled per-sample forward time (paper: batch x per-sample)
            comp_fwd = self.profiled_times[spec.name] * b_dev / sp / tp
        else:
            flops_dev = spec.flops_per_sample * b_dev / sp / tp
            comp_fwd = flops_dev / (dev.peak_flops * cfg.mfu)
        if ep > 1:
            # expert group shards tokens; the routed-expert share pays the
            # capacity padding and any modeled hot-rank imbalance
            ep_scale = ((1.0 - spec.expert_flops_frac)
                        + spec.expert_flops_frac * spec.capacity_factor
                        * ep_imb)
            comp_fwd = comp_fwd * ep_scale / ep
        comp_bwd = 2.0 * comp_fwd
        recompute = comp_fwd if strat.ckpt else 0.0

        # ---- communication ---------------------------------------------
        # Each collective is charged latency + bytes/bandwidth; with no
        # profiles attached the latency is exactly 0.0 and the bandwidth the
        # analytic one, so the pre-profiling numbers are reproduced ulp-for-
        # ulp (0.0 + x == x in IEEE arithmetic).
        # TP: all-reduce of hidden states, twice per layer direction
        tp_time_fwd = tp_time_bwd = 0.0
        if tp > 1:
            lat, bw = self._level_coeffs(strat, TP)
            msg = bnd_dev        # per-device hidden states (sp- and ep-sharded)
            ar = lat + 2.0 * self._ring_factor(tp) * msg / bw
            tp_time_fwd = 2.0 * ar
            tp_time_bwd = 2.0 * ar
            if spec.n_experts > 1 and cfg.moe_expert_parallel_tp:
                # token dispatch + combine all-to-all (fwd and bwd)
                a2a = lat + 2.0 * self._ring_factor(tp) / tp * msg * spec.top_k / bw
                tp_time_fwd += 2.0 * a2a
                tp_time_bwd += 2.0 * a2a

        # SDP: param all-gather before fwd and before bwd (per micro-batch),
        # grad reduce-scatter with the last micro-batch.
        sdp_ag_fwd = sdp_ag_bwd = sdp_rs = 0.0
        if sdp > 1:
            lat_ag, bw_ag = self._level_coeffs(strat, SDP, "all_gather")
            lat_rs, bw_rs = self._level_coeffs(strat, SDP, "reduce_scatter")
            pbytes = cfg.bytes_per_param * params_dev  # already TP-sharded
            sdp_ag_fwd = lat_ag + self._ring_factor(sdp) * pbytes / bw_ag
            sdp_ag_bwd = lat_ag + self._ring_factor(sdp) * pbytes / bw_ag
            sdp_rs = lat_rs + self._ring_factor(sdp) * pbytes / bw_rs

        # DP: grad all-reduce with the last micro-batch only.  Per the
        # paper's Takeaway-#3 accounting, DP synchronizes the FULL
        # (TP-sharded) gradient bytes — the all-reduce happens on unsharded
        # gradients before any ZeRO reduce-scatter, so no /sdp here.
        dp_ar = 0.0
        if dp > 1:
            lat, bw = self._level_coeffs(strat, DP)
            gbytes = cfg.bytes_per_param * params_dev
            dp_ar = lat + 2.0 * self._ring_factor(dp) * gbytes / bw

        # SP: ring attention rotates the local K/V panel sp−1 times per
        # forward (priced from the profiled ppermute pair); backward runs
        # the ring again carrying dK/dV accumulators (~2x the traffic).
        # Params are replicated across the sp group, so the last micro-
        # batch also all-reduces gradients over it (DP-like term).
        sp_ring_fwd = sp_ring_bwd = sp_ar = 0.0
        if sp > 1:
            lat_pp, bw_pp = self._level_coeffs(strat, SP)
            panel = spec.kv_bytes_per_sample * b_dev / sp
            sp_ring_fwd = (sp - 1) * (lat_pp + panel / bw_pp)
            sp_ring_bwd = 2.0 * sp_ring_fwd
            lat_sar, bw_sar = self._level_coeffs(strat, SP, "all_reduce")
            gbytes = cfg.bytes_per_param * params_dev
            sp_ar = lat_sar + 2.0 * self._ring_factor(sp) * gbytes / bw_sar

        # EP: all-to-all token dispatch + combine across the expert group
        # (fwd, and again for the gradients on the backward), plus a
        # DP-like gradient all-reduce of the replicated (non-expert)
        # params with the last micro-batch.
        ep_a2a = ep_ar = 0.0
        if ep > 1:
            lat_ep, bw_ep = self._level_coeffs(strat, EP)
            msg_ep = (spec.bnd_bytes_per_sample * b_dev / sp / ep
                      * spec.top_k * spec.capacity_factor * ep_imb)
            ep_a2a = 2.0 * (lat_ep + self._ring_factor(ep) * msg_ep / bw_ep)
            lat_ear, bw_ear = self._level_coeffs(strat, EP, "all_reduce")
            g_rep = cfg.bytes_per_param * (params_dev - p_exp_dev / ep)
            ep_ar = lat_ear + 2.0 * self._ring_factor(ep) * g_rep / bw_ear

        # ---- assemble (overlap model, §V) -------------------------------
        # forward: TP all-reduce and the EP all-to-all block; SDP gather
        # and the SP ring hand-off overlap with compute (the permute is
        # issued before the round's kernel — see kernels/ring_attention.py)
        fwd = (self._overlap(comp_fwd, sdp_ag_fwd + sp_ring_fwd)
               + tp_time_fwd + ep_a2a)
        # recompute forward (CKPT) repeats TP collectives + the SP ring too
        re_fwd = (self._overlap(recompute, sp_ring_fwd)
                  + tp_time_fwd + ep_a2a) if strat.ckpt else 0.0
        # backward: DP/SDP gradient comm overlaps with compute
        bwd_nosync = (self._overlap(comp_bwd, sdp_ag_bwd + sp_ring_bwd)
                      + tp_time_bwd + ep_a2a)
        bwd_sync = (self._overlap(
            comp_bwd,
            sdp_ag_bwd + sp_ring_bwd + sdp_rs + dp_ar + sp_ar + ep_ar)
            + tp_time_bwd + ep_a2a)

        if not _sp_applicable(spec, sp) or not _ep_applicable(spec, ep) or (
                cfg.min_samples_per_device > 0.0
                and b_dev < cfg.min_samples_per_device):
            # memory stays finite (the DP's bin weights must stay sane);
            # the poison time keeps any such pair out of optimal plans
            return LayerCosts(time=_SP_INVALID_TIME,
                              time_nosync=_SP_INVALID_TIME,
                              mem_f=mem_f, mem_b=mem_b, mem_ms=ms,
                              time_fwd=_SP_INVALID_TIME)

        return LayerCosts(
            time=fwd + re_fwd + bwd_sync,
            time_nosync=fwd + re_fwd + bwd_nosync,
            mem_f=mem_f,
            mem_b=mem_b,
            mem_ms=ms,
            time_fwd=fwd,
        )

    # ------------------------------------------------------------------
    # batched entry — whole (L, S) cost tables in one NumPy pass
    # ------------------------------------------------------------------
    def layer_cost_tables(self, specs: Sequence[LayerSpec],
                          strategies: Sequence[Strategy],
                          micro_batch_size: float, *,
                          inflight: float = 1) -> CostTables:
        """Vectorized equivalent of ``layer_costs`` + ``reshard_cost`` over
        every (layer, strategy) pair.

        Broadcasts (L,)-shaped layer workload vectors against (S,)-shaped
        strategy degree/bandwidth vectors; every arithmetic step mirrors the
        scalar path operation-for-operation so results agree to the last ulp
        (the memo-cache tests assert byte-identical search output).
        """
        cfg = self.cfg
        dev = self.cluster.device
        L, S = len(specs), len(strategies)
        if L == 0 or S == 0:
            z = np.zeros((L, S))
            return CostTables(*(z.copy() for _ in range(7)))

        # ---- per-strategy vectors (S,) --------------------------------
        dp = np.array([s.dp for s in strategies], float)
        sdp = np.array([s.sdp for s in strategies], float)
        tp = np.array([s.tp for s in strategies], float)
        spd = np.array([s.sp for s in strategies], float)
        epd = np.array([s.ep for s in strategies], float)
        total = np.array([s.total for s in strategies], float)
        ckpt = np.array([s.ckpt for s in strategies], bool)
        co = lambda pairs, i: np.array([p[i] for p in pairs])
        c_tp = [self._level_coeffs(s, TP) for s in strategies]
        c_ag = [self._level_coeffs(s, SDP, "all_gather") for s in strategies]
        c_rs = [self._level_coeffs(s, SDP, "reduce_scatter") for s in strategies]
        c_dp = [self._level_coeffs(s, DP) for s in strategies]
        c_sp = [self._level_coeffs(s, SP) for s in strategies]
        c_sar = [self._level_coeffs(s, SP, "all_reduce") for s in strategies]
        c_ep = [self._level_coeffs(s, EP) for s in strategies]
        c_ear = [self._level_coeffs(s, EP, "all_reduce") for s in strategies]
        c_tot = [self._group_coeffs("all_gather", int(s.total))
                 for s in strategies]
        bw_tp, bw_ag, bw_rs = co(c_tp, 1), co(c_ag, 1), co(c_rs, 1)
        bw_dp, bw_tot = co(c_dp, 1), co(c_tot, 1)
        bw_sp, bw_sar = co(c_sp, 1), co(c_sar, 1)
        bw_ep, bw_ear = co(c_ep, 1), co(c_ear, 1)
        # latency enters only where the paradigm is actually active — the
        # scalar path guards each comm term behind ``if deg > 1``
        lat_tp = np.where(tp > 1, co(c_tp, 0), 0.0)
        lat_ag = np.where(sdp > 1, co(c_ag, 0), 0.0)
        lat_rs = np.where(sdp > 1, co(c_rs, 0), 0.0)
        lat_dp = np.where(dp > 1, co(c_dp, 0), 0.0)
        lat_sp = np.where(spd > 1, co(c_sp, 0), 0.0)
        lat_sar = np.where(spd > 1, co(c_sar, 0), 0.0)
        lat_ep = np.where(epd > 1, co(c_ep, 0), 0.0)
        lat_ear = np.where(epd > 1, co(c_ear, 0), 0.0)
        lat_tot = np.where(total > 1, co(c_tot, 0), 0.0)
        ring_tp = np.where(tp > 1, (tp - 1) / tp, 0.0)
        ring_sdp = np.where(sdp > 1, (sdp - 1) / sdp, 0.0)
        ring_dp = np.where(dp > 1, (dp - 1) / dp, 0.0)
        ring_spd = np.where(spd > 1, (spd - 1) / spd, 0.0)
        ring_epd = np.where(epd > 1, (epd - 1) / epd, 0.0)
        ring_tot = np.where(total > 1, (total - 1) / total, 0.0)
        # hot-rank routing skew, exactly the scalar path's ``ep_imb``
        ep_imb = 1.0 + cfg.ep_imbalance * ring_epd

        # ---- per-layer vectors (L, 1) ---------------------------------
        col = lambda v: np.asarray(v, float).reshape(L, 1)
        param_count = col([sp.param_count for sp in specs])
        tp_frac = col([sp.tp_frac for sp in specs])
        bnd = col([sp.bnd_bytes_per_sample for sp in specs])
        intb = col([sp.int_bytes_per_sample for sp in specs])
        flops = col([sp.flops_per_sample for sp in specs])
        top_k = col([sp.top_k for sp in specs])
        moe = np.array([sp.n_experts > 1 for sp in specs]).reshape(L, 1)
        n_exp = col([sp.n_experts for sp in specs])
        epf = col([sp.expert_param_frac for sp in specs])
        eaf = col([sp.expert_act_frac for sp in specs])
        eff = col([sp.expert_flops_frac for sp in specs])
        cfac = col([sp.capacity_factor for sp in specs])
        kvb = col([sp.kv_bytes_per_sample for sp in specs])
        seq_l = col([sp.seq_len for sp in specs])
        sp_kind_ok = np.array([sp.kind != "ssm"
                               for sp in specs]).reshape(L, 1)
        profiled = col([self.profiled_times.get(sp.name, np.nan)
                        for sp in specs])

        # ---- memory: model states -------------------------------------
        b_dev = micro_batch_size / (dp * sdp)             # (S,)
        params_dev = param_count * tp_frac / tp + param_count * (1.0 - tp_frac)
        p_exp_dev = param_count * epf / tp
        params_dev = np.where(epd > 1,
                              params_dev - p_exp_dev + p_exp_dev / epd,
                              params_dev)
        ms = cfg.bytes_per_param_states * params_dev / sdp

        # ---- memory: activations --------------------------------------
        bnd_dev = bnd * b_dev / spd
        int_dev = intb * b_dev / spd / tp
        int_exp = intb * eaf * b_dev / spd / tp
        bnd_dev = np.where(epd > 1, bnd_dev / epd, bnd_dev)
        int_dev = np.where(epd > 1,
                           (int_dev - int_exp) / epd + int_exp * cfac / epd,
                           int_dev)
        int_dev = np.where(tp > 1,
                           int_dev + cfg.tp_act_replicated_bnd * bnd_dev,
                           int_dev)
        mem_f = np.where(ckpt, bnd_dev * inflight, (bnd_dev + int_dev) * inflight)
        mem_b = np.where(ckpt, int_dev, 0.0)

        # ---- compute time ---------------------------------------------
        comp_fwd = np.where(np.isnan(profiled),
                            (flops * b_dev / spd / tp) / (dev.peak_flops * cfg.mfu),
                            np.nan_to_num(profiled) * b_dev / spd / tp)
        ep_scale = (1.0 - eff) + eff * cfac * ep_imb
        comp_fwd = np.where(epd > 1, comp_fwd * ep_scale / epd, comp_fwd)
        comp_bwd = 2.0 * comp_fwd
        recompute = np.where(ckpt, comp_fwd, 0.0)

        # ---- communication --------------------------------------------
        # latency + bytes/bandwidth per collective, mirroring the scalar
        # path; lat_* is exactly 0.0 wherever a paradigm is inactive or no
        # profile is attached, so 0.0 + x keeps unprofiled results ulp-equal
        ar = lat_tp + 2.0 * ring_tp * bnd_dev / bw_tp
        tp_time = 2.0 * ar                                # fwd == bwd
        if cfg.moe_expert_parallel_tp:
            a2a = lat_tp + 2.0 * ring_tp / tp * bnd_dev * top_k / bw_tp
            tp_time = np.where(moe, tp_time + 2.0 * a2a, tp_time)

        pbytes = cfg.bytes_per_param * params_dev
        sdp_ag = lat_ag + ring_sdp * pbytes / bw_ag       # ag_fwd == ag_bwd
        sdp_rs = lat_rs + ring_sdp * pbytes / bw_rs
        dp_ar = lat_dp + 2.0 * ring_dp * pbytes / bw_dp

        # SP: sp−1 ppermute rounds of the local K/V panel (fwd), 2x on the
        # backward ring, plus the sp-group gradient all-reduce — mirrors
        # the scalar path's ``if sp > 1`` block
        panel = kvb * b_dev / spd
        sp_ring_fwd = np.where(spd > 1,
                               (spd - 1) * (lat_sp + panel / bw_sp), 0.0)
        sp_ring_bwd = 2.0 * sp_ring_fwd
        sp_ar = np.where(spd > 1,
                         lat_sar + 2.0 * ring_spd * pbytes / bw_sar, 0.0)

        # EP: all-to-all dispatch + combine, plus the replicated-param
        # gradient all-reduce — mirrors the scalar path's ``if ep > 1``
        msg_ep = bnd * b_dev / spd / epd * top_k * cfac * ep_imb
        ep_a2a = np.where(epd > 1,
                          2.0 * (lat_ep + ring_epd * msg_ep / bw_ep), 0.0)
        g_rep = cfg.bytes_per_param * (params_dev - p_exp_dev / epd)
        ep_ar = np.where(epd > 1,
                         lat_ear + 2.0 * ring_epd * g_rep / bw_ear, 0.0)

        # ---- assemble (overlap model, §V) ------------------------------
        sd = dev.overlap_slowdown

        def overlap(comp, comm):
            return np.where(comp <= 0.0, comm,
                            np.where(comm <= 0.0, comp,
                                     np.maximum(comp * sd, comm * sd)))

        fwd = overlap(comp_fwd, sdp_ag + sp_ring_fwd) + tp_time + ep_a2a
        re_fwd = np.where(ckpt,
                          overlap(recompute, sp_ring_fwd) + tp_time + ep_a2a,
                          0.0)
        bwd_nosync = overlap(comp_bwd, sdp_ag + sp_ring_bwd) + tp_time + ep_a2a
        bwd_sync = overlap(
            comp_bwd,
            sdp_ag + sp_ring_bwd + sdp_rs + dp_ar + sp_ar + ep_ar
        ) + tp_time + ep_a2a

        # pairs SP/EP cannot execute get the scalar path's poison time
        sp_bad = (spd > 1) & ~((seq_l > 0)
                               & (np.mod(seq_l, spd) == 0) & sp_kind_ok)
        ep_bad = (epd > 1) & ~((n_exp > 1) & (np.mod(n_exp, epd) == 0))
        sp_bad = sp_bad | ep_bad
        if cfg.min_samples_per_device > 0.0:
            # physical floor: DP/SDP cannot split one sample (see config)
            sp_bad = sp_bad | (b_dev < cfg.min_samples_per_device)

        # ---- reshard (layout-transformation) cost ----------------------
        reshard = lat_tot + 2.0 * ring_tot * (bnd * micro_batch_size / total) / bw_tot

        return CostTables(
            time_sync=np.where(sp_bad, _SP_INVALID_TIME,
                               fwd + re_fwd + bwd_sync),
            time_nosync=np.where(sp_bad, _SP_INVALID_TIME,
                                 fwd + re_fwd + bwd_nosync),
            time_fwd=np.where(sp_bad, _SP_INVALID_TIME, fwd),
            mem_f=mem_f,
            mem_b=mem_b,
            mem_ms=ms,
            reshard=reshard,
        )

    # ------------------------------------------------------------------
    def plan_peak_stage_mem(self, specs: Sequence[LayerSpec],
                            plan) -> List[float]:
        """Recompute each pipeline stage's exact peak memory (Eq. 2) for a
        finished :class:`~repro_torch.core.plan.ParallelPlan`, via the scalar
        ``layer_costs`` path — independent of the DP search machinery, so
        it serves as the feasibility oracle for frontier plans (every
        swept plan must fit under its own budget)."""
        from .pipeline_balance import inflight_microbatches
        B_m = plan.global_batch / plan.n_micro
        out: List[float] = []
        start = 0
        for i, n in enumerate(plan.partition):
            infl = inflight_microbatches(i, plan.pp_degree, plan.n_micro,
                                         plan.schedule, plan.vpp_degree)
            cum_f = peak = ms = 0.0
            for l in range(start, start + n):
                c = self.layer_costs(specs[l], plan.strategies[l], B_m,
                                     inflight=infl)
                cum_f += c.mem_f
                peak = max(peak, cum_f + c.mem_b)
                ms += c.mem_ms
            out.append(peak + ms)
            start += n
        return out

    # ------------------------------------------------------------------
    def reshard_cost(self, spec: LayerSpec, strat_to: Strategy,
                     micro_batch_size: float) -> float:
        """R(l, S_i, S_j): slice-gather transformation cost when the previous
        layer used a different strategy.  Modeled as moving this layer's
        boundary activations once across the stage's device group."""
        n = strat_to.total
        if n <= 1:
            return 0.0
        lat, bw = self._group_coeffs("all_gather", n)
        bytes_moved = spec.bnd_bytes_per_sample * micro_batch_size / n
        return lat + 2.0 * self._ring_factor(n) * bytes_moved / bw

    # ------------------------------------------------------------------
    def p2p_cost(self, spec: LayerSpec, micro_batch_size: float,
                 data_deg: int) -> float:
        """Pipeline stage-boundary activation transfer (per micro-batch).

        Priced from the profiled ``ppermute`` pair when the cluster is a
        single island and carries one, else the analytic inter-island
        bandwidth (PP hand-offs cross the slow domain on hierarchical
        clusters — Takeaway #1)."""
        lat, bw = self._group_coeffs("ppermute", -1)
        bytes_moved = spec.bnd_bytes_per_sample * micro_batch_size / max(1, data_deg)
        return lat + bytes_moved / bw
