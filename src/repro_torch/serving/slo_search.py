# The port's copy of repro/serving/slo_search.py: the same names and arithmetic.
"""SLO-aware serving plan search.

Reuses the Galvatron-BMW budget-axis frontier engine for inference: decode
is **bandwidth-bound** — each step must stream the (active) weights plus
every lane's cached KV pages through HBM — so a per-token latency SLO is
exactly a per-step *byte budget*::

    budget_bytes = slo_s * hbm_bandwidth * efficiency

That budget doubles as the memory budget ``sweep_budgets()`` already
sweeps: a plan whose per-device working set exceeds it cannot stream that
much per step, hence cannot meet the SLO.  The optimizer runs with an
*inference* cost configuration (weights only — no gradients or optimizer
states, ``bytes_per_param_states = bytes_per_param``), and each frontier
point is then refined into a :class:`repro_torch.core.plan.ServingSection` by the
analytic serving cost model below: the largest decode batch meeting the
SLO, a page size minimizing fragmentation, prefill degrees chosen
compute-bound, and predicted TTFT / per-token latency / throughput.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

from repro_torch.core.cost_model import CostModelConfig
from repro_torch.core.frontier import PlanFrontier
from repro_torch.core.hardware import ClusterSpec
from repro_torch.core.layerspec import LayerSpec
from repro_torch.core.optimizer import GalvatronOptimizer, OptimizerConfig
from repro_torch.core.plan import ParallelPlan, ServingSection

#: fraction of peak HBM bandwidth a decode step actually achieves
DECODE_BW_EFFICIENCY = 0.6
#: KV/weight bytes per element at serving time (bf16)
SERVE_ACT_BYTES = 2.0
#: candidate page sizes (tokens per page)
PAGE_SIZE_CANDIDATES = (8, 16, 32, 64)
#: candidate decode batch sizes
DECODE_BATCH_CANDIDATES = (1, 2, 4, 8, 16, 32, 64, 128, 256)


@dataclasses.dataclass(frozen=True)
class ServingModelStats:
    """Per-token workload of a model at serving time (one device's view is
    obtained by dividing by the TP degree)."""

    param_bytes: float            # total weight bytes (active params)
    kv_bytes_per_token: float     # K+V bytes per cached token, all layers
    flops_per_token: float        # decode FLOPs per generated token

    @staticmethod
    def from_layer_specs(specs: Sequence[LayerSpec]) -> "ServingModelStats":
        active = sum(s.active_param_count() for s in specs)
        kv = 0.0
        for s in specs:
            if s.kind in ("attn_mlp", "moe") and s.seq_len:
                # bnd bytes/sample = seq * d * act_bytes; KV per token is
                # 2 * kv_dim * act_bytes — recover d from the boundary
                # activation and apply the GQA ratio heuristically (1/4)
                d_bytes = s.bnd_bytes_per_sample / s.seq_len
                kv += 2 * d_bytes / 4
        return ServingModelStats(
            param_bytes=active * SERVE_ACT_BYTES,
            kv_bytes_per_token=kv,
            flops_per_token=2.0 * active)

    @staticmethod
    def from_model_config(cfg) -> "ServingModelStats":
        """Exact analytic stats from a ``repro_torch.models.ModelConfig``."""
        d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab_size
        kv_dim = cfg.kv_dim
        p_attn = d * cfg.q_dim + 2 * d * kv_dim + cfg.q_dim * d
        if cfg.n_experts > 1:
            p_ff_active = 3 * d * cfg.d_ff * cfg.top_k
        else:
            p_ff_active = 3 * d * cfg.d_ff
        p_embed = V * d * (1 if cfg.tie_embeddings else 2)
        active = p_embed + L * (p_attn + p_ff_active + 2 * d)
        return ServingModelStats(
            param_bytes=active * SERVE_ACT_BYTES,
            kv_bytes_per_token=L * 2 * kv_dim * SERVE_ACT_BYTES,
            flops_per_token=2.0 * active)


@dataclasses.dataclass(frozen=True)
class ServingCostModel:
    """Analytic decode/prefill latency (§V-style roofline, per device)."""

    cluster: ClusterSpec
    stats: ServingModelStats
    bw_efficiency: float = DECODE_BW_EFFICIENCY

    def _bw(self) -> float:
        return self.cluster.device.hbm_bandwidth * self.bw_efficiency

    def decode_step_s(self, batch: int, mean_context: float,
                      tp: int, pp: int) -> float:
        """One decode step: max of the bandwidth and compute rooflines.
        PP splits the weights but serializes micro-steps, so per-token
        latency sees the full pipeline depth (no batch pipelining gain for
        a single decode step)."""
        shard = max(1, tp) * max(1, pp)
        traffic = (self.stats.param_bytes / shard
                   + batch * mean_context * self.stats.kv_bytes_per_token
                   / max(1, tp))
        t_bw = traffic / self._bw()
        mfu = 0.45
        t_fl = (batch * self.stats.flops_per_token
                / (shard * self.cluster.device.peak_flops * mfu))
        # cross-stage hop latency for PP
        t_hop = 0.0
        if pp > 1:
            lat, _ = self.cluster.collective_coeffs("ppermute", pp)
            t_hop = lat * (pp - 1)
        return max(t_bw, t_fl) + t_hop

    def prefill_s(self, prompt_tokens: int, tp: int, pp: int) -> float:
        """Prefill is compute-bound (batched matmuls over the prompt)."""
        mfu = 0.45
        shard = max(1, tp) * max(1, pp)
        return (prompt_tokens * self.stats.flops_per_token
                / (shard * self.cluster.device.peak_flops * mfu))

    def kv_pool_bytes(self, n_pages: int, page_size: int, tp: int) -> float:
        return (n_pages * page_size * self.stats.kv_bytes_per_token
                / max(1, tp))

    def slo_budget_bytes(self, slo_ms: float) -> float:
        """Per-token SLO -> per-step streamable bytes -> memory budget."""
        return (slo_ms / 1e3) * self._bw()


@dataclasses.dataclass
class SloPoint:
    """One point of the serving frontier."""

    slo_ms: float
    budget_bytes: float
    plan: Optional[ParallelPlan]          # carries the ServingSection

    @property
    def feasible(self) -> bool:
        return self.plan is not None and self.plan.serving is not None


class ServingPlanSearch:
    """Wraps :class:`GalvatronOptimizer` with the serving cost model.

    ``specs``/``cluster`` describe the model and hardware exactly as for
    the training search; the optimizer itself runs with inference memory
    accounting (weights only)."""

    def __init__(self, specs: Sequence[LayerSpec], cluster: ClusterSpec,
                 config: Optional[OptimizerConfig] = None,
                 stats: Optional[ServingModelStats] = None):
        self.specs = list(specs)
        self.cluster = cluster
        self.stats = stats or ServingModelStats.from_layer_specs(specs)
        self.cost = ServingCostModel(cluster, self.stats)
        inference_cost = CostModelConfig(
            bytes_per_param_states=SERVE_ACT_BYTES,   # no grads / optimizer
            bytes_per_param=SERVE_ACT_BYTES)
        self.opt = GalvatronOptimizer(specs, cluster, config,
                                      cost_config=inference_cost)

    # ---- per-point refinement -------------------------------------------
    def _derive_serving(self, plan: ParallelPlan, slo_ms: float, *,
                        max_context: int, mean_context: float,
                        ttft_slo_ms: float) -> ServingSection:
        tp = max((s.tp for s in plan.strategies), default=1)
        pp = plan.pp_degree
        # decode batch: largest candidate meeting the SLO roofline and the
        # per-device HBM capacity (weights + KV pool for that batch)
        hbm = self.cluster.device.hbm_bytes
        best_b = 1
        for b in DECODE_BATCH_CANDIDATES:
            t = self.cost.decode_step_s(b, mean_context, tp, pp) * 1e3
            kv = (b * max_context * self.stats.kv_bytes_per_token
                  / max(1, tp))
            w = self.stats.param_bytes / (max(1, tp) * max(1, pp))
            if t <= slo_ms and kv + w <= hbm:
                best_b = b
        # page size: minimize fragmentation (half a page per request) plus
        # table overhead (one int32 row entry per page per lane)
        def waste(psz: int) -> float:
            frag = psz / 2 * self.stats.kv_bytes_per_token
            table = (max_context / psz) * 4.0
            return frag * best_b + table * best_b
        page_size = min((p for p in PAGE_SIZE_CANDIDATES
                         if max_context % p == 0),
                        key=waste, default=max(
                            p for p in PAGE_SIZE_CANDIDATES
                            if p <= max_context))
        # pool sized for the full decode batch at mean context + headroom
        tokens = best_b * (mean_context + page_size)
        kv_pool_pages = max(best_b,
                            int(-(-tokens // page_size)))
        tok_s = self.cost.decode_step_s(best_b, mean_context, tp, pp)
        ttft_s = (self.cost.prefill_s(int(mean_context), tp, pp)
                  + tok_s)
        prefill_chunk = max(page_size, min(512, max_context))
        return ServingSection(
            slo_ms=slo_ms,
            ttft_slo_ms=ttft_slo_ms,
            page_size=page_size,
            max_context=max_context,
            decode_batch=best_b,
            prefill_chunk=prefill_chunk,
            decode_tp=tp, decode_pp=pp,
            # prefill is compute-bound: prefer TP over PP at equal device
            # count (no pipeline fill latency on the critical TTFT path)
            prefill_tp=tp * pp, prefill_pp=1,
            kv_pool_pages=kv_pool_pages,
            est_tok_ms=tok_s * 1e3,
            est_ttft_ms=ttft_s * 1e3,
            est_tok_per_s=best_b / tok_s if tok_s > 0 else 0.0,
        )

    # ---- top level -------------------------------------------------------
    def sweep_slos(self, slo_ms_list: Sequence[float], *,
                   max_context: int = 2048,
                   mean_context: Optional[float] = None,
                   ttft_slo_ms: float = 0.0,
                   backend: Optional[str] = None,
                   verbose: bool = False
                   ) -> Tuple[List[SloPoint], PlanFrontier]:
        """Walk the latency-SLO axis through ``sweep_budgets()``.

        Returns one :class:`SloPoint` per requested SLO (same order) plus
        the underlying byte-budget :class:`PlanFrontier`.  Infeasible SLOs
        (no plan can stream its working set fast enough) get
        ``plan=None``."""
        mean_ctx = float(mean_context if mean_context is not None
                         else max_context / 2)
        budgets = [self.cost.slo_budget_bytes(s) for s in slo_ms_list]
        frontier = self.opt.sweep_budgets(budgets, backend=backend,
                                          verbose=verbose)
        points: List[SloPoint] = []
        for slo_ms, budget in zip(slo_ms_list, budgets):
            plan = frontier.plan_at(budget)
            if plan is not None:
                serving = self._derive_serving(
                    plan, slo_ms, max_context=max_context,
                    mean_context=mean_ctx, ttft_slo_ms=ttft_slo_ms)
                plan = dataclasses.replace(plan, serving=serving)
            points.append(SloPoint(slo_ms=slo_ms, budget_bytes=budget,
                                   plan=plan))
        return points, frontier
