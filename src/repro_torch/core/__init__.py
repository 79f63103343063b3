"""Galvatron-BMW core: automatic hybrid-parallelism search (the paper's
primary contribution), in pure Python/NumPy — model- and runtime-agnostic.

The port's own copy of ``repro/core/`` (without ``profiler.py``): the same
names and the same arithmetic, so a search gives byte-identical plans; the
hardware presets add H100 and leave out the reference's TPU presets."""
from .cost_model import (CostModel, CostModelConfig, CostTables, LayerCosts,
                         bubble_fraction, pipeline_iter_time)
from .decision_tree import SearchSpace, construct_search_space, pp_degree_candidates
from .dp_search import (StageSearchResult, dp_search_stage,
                        dp_search_stage_budgets, dp_search_stage_budgets_batch)
from .frontier import (CandidateBound, DominanceFrontier, FrontierPoint,
                       PlanFrontier)
from .hardware import (CLUSTERS, H100_SXM, ClusterSpec, CollectiveProfile,
                       DeviceSpec, h100_cluster, h100_node, paper_8gpu,
                       paper_16gpu_high, paper_16gpu_low, paper_32gpu_80g,
                       paper_64gpu)
from .layerspec import (LayerSpec, cross_attn_extra, dense_layer, embed_layer,
                        head_layer, merge, moe_layer, ssm_layer, total_params)
from .optimizer import (SEARCH_BACKENDS, GalvatronOptimizer, OptimizerConfig,
                        deepspeed_3d, galvatron_variant, normalize_batch_grid,
                        pure_baseline)
from .pipeline_balance import (ZB_W_ACT_FRAC, balance_degrees,
                               inflight_microbatches,
                               memory_balanced_partition,
                               time_balanced_partition, zb_w_pending_max)
from .plan import (PLAN_FORMAT_VERSION, ParallelPlan, PlanFormatError,
                   ServingSection)
from .strategy import (DP, SDP, TP, Strategy, enumerate_strategies,
                       strategy_set_id)

__all__ = [k for k in dir() if not k.startswith("_")]
