"""Plan -> executor bridge: derive a mesh execution policy from a
Galvatron-searched ``ParallelPlan`` (``repro/runtime/plan_bridge.py``).

The search is layer-granular; the executor applies policies per
layer-stack *segment*, so the bridge reduces each segment's strategies to
their dominant choice:

  * TP on the `model` axis iff any layer's plan has tp > 1,
  * ZeRO (SDP) on the batch axes iff the majority of layers use sdp > 1,
  * remat per segment iff the majority of the segment's layers have CKPT,
  * sequence sharding of the residual stream iff the modeled stash
    exceeds the HBM budget,
  * the ring-attention SP degree and the expert-parallel degree copied
    verbatim from ``plan.sp_degree`` and ``plan.ep_degree``.

The arithmetic and the defaults are the reference's.  The reference calls
``modeled_memory`` with a v5e pod's ``tp=16, data_shards=16``; here they
are keyword arguments with those defaults, so that a caller passes its own
mesh's degrees (the train driver does, with the card's memory).
"""
from __future__ import annotations

from typing import TYPE_CHECKING, List, Optional, Sequence

from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import build_stacks
from repro_torch.roofline.analysis import modeled_memory
from repro_torch.runtime.schedules import ScheduleProgram, compile_schedule
from repro_torch.runtime.sharding import ShardPolicy, mesh_axes

if TYPE_CHECKING:
    from repro_torch.core.layerspec import LayerSpec
    from repro_torch.core.plan import ParallelPlan


def _segment_bounds(cfg: ModelConfig) -> List[int]:
    """The remat segments' layer counts: :func:`build_stacks`'s, and for
    an encoder-decoder one of ``n_layers`` (the reference's
    ``build_stacks`` falls through to one dense stack; its remat flag
    covers both of the model's stacks)."""
    if cfg.is_encoder_decoder:
        return [cfg.n_layers]
    return [n for _, n in build_stacks(cfg)]


def policy_from_plan(cfg: ModelConfig, plan: "ParallelPlan", *,
                     specs: Optional[Sequence["LayerSpec"]] = None,
                     seq_len: int = 4096, chips: int = 256,
                     hbm_capacity: float = 16e9, tp: int = 16,
                     data_shards: int = 16) -> ShardPolicy:
    """The :class:`ShardPolicy` of ``plan`` for ``cfg``; with ``specs``
    (the full model's layer specs) ``seq_shard`` is set when the modeled
    training residency over ``chips`` cards, TP ``tp`` and ``data_shards``
    batch shards exceeds ``hbm_capacity`` bytes.  Raises
    NotImplementedError for an arch the port does not build."""
    strategies = plan.strategies
    # body layers only (embed/head specs may pad the plan at either end)
    n_body = cfg.n_layers
    if len(strategies) > n_body:
        off = (len(strategies) - n_body) // 2
        strategies = strategies[off:off + n_body]

    use_tp = any(s.tp > 1 for s in strategies)
    zero = sum(s.sdp > 1 for s in strategies) * 2 >= len(strategies)

    remat: List[bool] = []
    i = 0
    for seg in _segment_bounds(cfg):
        seg_s = strategies[i:i + seg] or strategies[-1:]
        remat.append(sum(s.ckpt for s in seg_s) * 2 >= len(seg_s))
        i += seg

    seq_shard = False
    if specs is not None:
        mm = modeled_memory(
            list(specs), mode="train", chips=chips, tp=tp,
            data_shards=data_shards, remat=any(remat),
            batch=plan.global_batch, hbm_capacity=hbm_capacity)
        seq_shard = not mm.fits      # only when the stash overflows
    ep = plan.ep_degree
    return ShardPolicy(tp=use_tp, zero=zero, remat_segments=tuple(remat),
                       seq_shard=seq_shard, sp_degree=plan.sp_degree,
                       ep_degree=ep,
                       expert_axis="expert" if ep > 1 else "model")


def schedule_program_from_plan(plan: "ParallelPlan", *,
                               validate: bool = False) -> ScheduleProgram:
    """Compile the plan's searched (schedule, pp_degree, n_micro,
    vpp_degree) into the tick program the pipeline runtime executes.

    An uncompilable combo raises a structured
    :class:`repro_torch.analysis.DiagnosticError` naming the plan field
    (rule ``PLN004``) instead of ``compile_schedule``'s bare
    ``ValueError``; ``validate=True`` also runs the schedule verifier."""
    from repro_torch.analysis.diagnostics import DiagnosticError, error
    try:
        return compile_schedule(plan.schedule, plan.pp_degree, plan.n_micro,
                                plan.vpp_degree, validate=validate)
    except DiagnosticError:
        raise
    except ValueError as e:
        raise DiagnosticError([error(
            "PLN004", "plan.schedule",
            f"plan prescribes an uncompilable schedule combo "
            f"(schedule={plan.schedule!r}, pp_degree={plan.pp_degree}, "
            f"n_micro={plan.n_micro}, vpp_degree={plan.vpp_degree}): {e}",
            "verify the plan with repro_torch.analysis.verify_plan for "
            "the full verdict")], context="schedule_program_from_plan") from e


def pipeline_loss_from_plan(cfg: ModelConfig, mesh, plan: "ParallelPlan"):
    """The pipeline runtime's ``loss_and_grads`` executing the plan's
    searched schedule on ``mesh`` (``runtime/pipeline.py``).

    The mesh's ``pipe`` axis must have ``plan.pp_degree`` ranks (the
    tables are compiled for that stage count); a mismatch raises a
    structured diagnostic (rule ``PLN006``) up front."""
    from repro_torch.runtime.pipeline import make_pipeline_loss_from_program
    n_pipe = mesh_axes(mesh).get("pipe", 1)
    if n_pipe != plan.pp_degree:
        from repro_torch.analysis.diagnostics import DiagnosticError, error
        raise DiagnosticError([error(
            "PLN006", "plan.pp_degree",
            f"plan was searched for pp_degree={plan.pp_degree} but the "
            f"mesh's 'pipe' axis has {n_pipe} device(s)",
            "build the mesh with make_pipeline_mesh(n_stages="
            f"{plan.pp_degree}, ...) or re-search for this cluster")],
            context="pipeline_loss_from_plan")
    prog = schedule_program_from_plan(plan)
    return make_pipeline_loss_from_program(cfg, mesh, prog)
