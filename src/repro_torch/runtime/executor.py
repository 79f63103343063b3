"""Device steps: training, prefill, the dense-cache decode step and the
serving engine's (``runtime/executor.py`` counterpart).

The JAX package jit-compiles each step with shardings and donated buffers.
PyTorch runs eagerly, so a built step is the model function itself: the
training step runs value-and-grad of ``lm_loss`` and the AdamW update, which
writes the parameters and optimizer state in place; the prefill and serving
steps run under ``torch.inference_mode()``, and the serving steps update the
caches or pools in place.

Each step runs on one device, or sharded over the ranks of a ``("data",
"model")`` mesh by a :class:`~repro_torch.runtime.sharding.ShardPolicy`:
training with DP, ZeRO-3 and head-aligned TP, remat per segment and
stash-only sequence sharding (each rank holds its shards of the
parameters and of the AdamW state: :func:`init_train_state`,
:func:`shard_train_state`); serving with the lanes over ``data``, the
paged pools' KV heads over ``model`` under TP, the dense caches' context
(or KV heads) and the SSM states' heads over ``model``
(:func:`init_serving_params`).  The collectives GSPMD inserts in the JAX
package run explicitly (``runtime/sharding.py``).
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device
from repro_torch.models.attention import Pool
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import (LM, build_stacks, decode_step,
                                            init_lm, lm_forward, lm_loss,
                                            paged_decode_step,
                                            paged_prefill_step)
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime.sharding import (ShardContext, ShardPolicy,
                                          abstract_params)


def init_train_state(cfg: ModelConfig, *, mesh: Optional[DeviceMesh] = None,
                     policy: Optional[ShardPolicy] = None, seed: int = 0,
                     opt_cfg: Optional[AdamWConfig] = None,
                     device: torch.device = "cuda"
                     ) -> Tuple[LM, Dict[str, Any]]:
    """Random weights from ``seed`` on ``device`` and their AdamW state.

    With a ``mesh`` (``("data", "model")``, every rank calling), each rank
    draws ``init_lm``'s numbers in its order and keeps its shards under
    ``policy`` (default ``ShardPolicy()``), each full part freed as soon as
    it is sliced: the numbers are the single process's on the same device
    type.  Raises NotImplementedError for an arch the port does not
    build."""
    dev = resolve_device(device)
    if mesh is None:
        params = init_lm(cfg, seed=seed, device=dev)
    else:
        ctx = ShardContext(cfg, mesh, policy or ShardPolicy())
        params = init_lm(cfg, seed=seed, device=dev, shard=ctx.shard_part)
    return params, adamw_init(list(params.parameters()), opt_cfg)


def shard_train_state(params: LM, mesh: DeviceMesh, policy: ShardPolicy, *,
                      cfg: ModelConfig,
                      opt_cfg: Optional[AdamWConfig] = None
                      ) -> Tuple[LM, Dict[str, Any]]:
    """:func:`init_train_state`'s sharded state from a full model of
    ``cfg`` (for example one bridged from JAX by
    ``bridge.params_from_jax``): its parameters replaced by this rank's
    shards, in place, and their AdamW state."""
    params = ShardContext(cfg, mesh, policy).shard_model(params)
    return params, adamw_init(list(params.parameters()), opt_cfg)


def gather_params(params: LM, mesh: DeviceMesh, policy: ShardPolicy, *,
                  cfg: ModelConfig) -> LM:
    """A full copy of a sharded model, on every rank (a collective of
    every rank), for checks."""
    ctx = ShardContext(cfg, mesh, policy)
    shards = dict(params.named_parameters())
    return ctx.shard_model(copy.deepcopy(params), lambda name, _: (
        ctx.gather_tensor(name, shards[name])))


def make_sharded_loss(cfg: ModelConfig, mesh: DeviceMesh,
                      policy: ShardPolicy
                      ) -> Callable[..., Tuple[torch.Tensor,
                                               List[torch.Tensor]]]:
    """``loss_and_grads(params, batch) -> (loss, grads)`` of a sharded
    model on ``mesh`` under ``policy``, called on every rank with the
    global batch (int ``tokens``/``labels`` (B, S), on any device), of
    which each rank takes its ``data`` rows.  ``loss`` is the global
    batch's 0-d fp32 loss, the same on every rank; ``grads``, aligned with
    ``params.parameters()``, are the rank's shards of the global gradient.
    Remat follows ``policy.remat_segments``.  ``loss_and_grads.shard`` is
    the :class:`ShardContext`.  Raises as ``ShardContext`` does."""
    ctx = ShardContext(cfg, mesh, policy)
    remat = list(policy.remat_segments) if policy.remat_segments else None

    def loss_and_grads(params: LM, batch: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        named = ctx.bind(params)
        leaves = [p for _, p in named]
        local = ctx.local_batch(batch, leaves[0].device)
        share = lm_loss(params, local, cfg, remat_segments=remat, shard=ctx)
        grads = torch.autograd.grad(share, leaves, allow_unused=True)
        grads = ctx.reduce_grads(named, grads)
        return ctx.data_sum(share.detach()), grads

    loss_and_grads.shard = ctx
    return loss_and_grads


def make_train_step(cfg: ModelConfig,
                    opt_cfg: Optional[AdamWConfig] = None, *,
                    remat_segments: Optional[Sequence[bool]] = None,
                    mesh: Optional[DeviceMesh] = None,
                    policy: Optional[ShardPolicy] = None
                    ) -> Callable[..., Dict[str, torch.Tensor]]:
    """``(params, opt_state, batch)`` -> ``{"loss", "grad_norm", "lr"}``
    (0-d tensors on the params' device); params and opt_state are updated
    in place.  ``batch`` holds int ``tokens`` and ``labels`` (B, S).
    ``remat_segments`` goes to :func:`lm_loss`.

    With a ``mesh`` the step is the sharded one (:func:`make_sharded_loss`
    under ``policy``, default ``ShardPolicy()``, whose ``remat_segments``
    it takes): ``batch`` is the global batch, ``params`` and ``opt_state``
    this rank's shards (:func:`init_train_state`), the gradient norm that
    of the whole model (every shard and every replicated leaf counted
    once), and AdamW updates the local shards.  Raises
    NotImplementedError for an arch the port does not build."""
    build_stacks(cfg)
    opt_cfg = opt_cfg or AdamWConfig()
    if mesh is not None:
        if remat_segments is not None:
            raise ValueError("a sharded step takes remat from "
                             "policy.remat_segments")
        return _sharded_step(cfg, opt_cfg, mesh, policy or ShardPolicy())

    def step(params: LM, opt_state: Dict[str, Any],
             batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        leaves = list(params.parameters())
        loss = lm_loss(params, batch, cfg, remat_segments=remat_segments)
        grads = torch.autograd.grad(loss, leaves)
        metrics = adamw_update(leaves, grads, opt_state, opt_cfg)
        metrics["loss"] = loss.detach()
        return metrics

    return step


def _sharded_step(cfg: ModelConfig, opt_cfg: AdamWConfig, mesh: DeviceMesh,
                  policy: ShardPolicy) -> Callable[..., Dict[str,
                                                          torch.Tensor]]:
    loss_and_grads = make_sharded_loss(cfg, mesh, policy)
    ctx = loss_and_grads.shard

    def step(params: LM, opt_state: Dict[str, Any],
             batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        loss, grads = loss_and_grads(params, batch)
        named = list(params.named_parameters())
        metrics = adamw_update([p for _, p in named], grads, opt_state,
                               opt_cfg, grad_norm=ctx.grad_norm(named, grads))
        metrics["loss"] = loss
        return metrics

    step.shard = ctx
    return step


# --------------------------------------------------------------------------
# serving: one device, or sharded over a ("data", "model") mesh
# --------------------------------------------------------------------------

SERVING_POLICY = ShardPolicy(tp=False, zero=False)


def _serving_context(cfg: ModelConfig, mesh: DeviceMesh,
                     policy: Optional[ShardPolicy]) -> ShardContext:
    return ShardContext(cfg, mesh, policy or SERVING_POLICY, serving=True)


def init_serving_params(cfg: ModelConfig, *,
                        mesh: Optional[DeviceMesh] = None,
                        policy: Optional[ShardPolicy] = None, seed: int = 0,
                        device: torch.device = "cuda") -> LM:
    """Random weights from ``seed`` on ``device`` for the serving steps.

    With a ``mesh`` each rank draws ``init_lm``'s numbers and keeps its
    shards under ``policy`` (default ``ShardPolicy(tp=False, zero=False)``,
    the serving drivers' policy): the rule table's (``param_specs``),
    except that under TP each Mamba2 ``in_proj`` is the rank's columns
    (``models/ssm.py::ssm_tp_columns``), taken once here rather than
    gathered over ``model`` every step."""
    dev = resolve_device(device)
    if mesh is None:
        return init_lm(cfg, seed=seed, device=dev)
    ctx = _serving_context(cfg, mesh, policy)
    return init_lm(cfg, seed=seed, device=dev, shard=ctx.shard_part)


def shard_serving_params(params: LM, mesh: DeviceMesh,
                         policy: Optional[ShardPolicy] = None, *,
                         cfg: ModelConfig) -> LM:
    """:func:`init_serving_params`'s shards from a full model of ``cfg``
    (for example one bridged from JAX), its parameters replaced in
    place."""
    return _serving_context(cfg, mesh, policy).shard_model(params)


def make_prefill_step(cfg: ModelConfig, *,
                      mesh: Optional[DeviceMesh] = None,
                      policy: Optional[ShardPolicy] = None
                      ) -> Callable[[LM, Dict[str, torch.Tensor]],
                                    torch.Tensor]:
    """``(params, batch)`` -> logits (B, S, V): the inference forward of
    ``batch["tokens"]`` (B, S), :func:`lm_forward` without the loss, for
    every arch the port builds.  Raises NotImplementedError for another.

    With a ``mesh`` (``policy`` default ``ShardPolicy(tp=False,
    zero=False)``; params from :func:`init_serving_params`), every rank
    calls it with the whole batch and gets its block of the logits, as the
    reference's step leaves them sharded: its lanes (rows split over
    ``data`` when they divide, ``ShardContext.lane_range``) and under TP
    its vocabulary columns ``[r V / tp, (r + 1) V / tp)``.
    ``step.shard`` is the :class:`ShardContext`."""
    build_stacks(cfg)
    if mesh is None:
        @torch.inference_mode()
        def step(params: LM, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
            return lm_forward(params, batch["tokens"], cfg)[0]

        return step
    ctx = _serving_context(cfg, mesh, policy)

    @torch.inference_mode()
    def sharded(params: LM, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        ctx.bind(params)
        tokens = batch["tokens"]
        lo, hi = ctx.lane_range(tokens.shape[0])
        return lm_forward(params, tokens[lo:hi].to(params.embed.device), cfg,
                          shard=ctx)[0]

    sharded.shard = ctx
    return sharded


def make_serve_step(cfg: ModelConfig, *, mesh: Optional[DeviceMesh] = None,
                    policy: Optional[ShardPolicy] = None
                    ) -> Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]:
    """``(params, state, token (B,))`` -> ``(logits (B, V), state)``: one
    decode step on the KV caches and SSM states of ``init_decode_state``,
    written in place, for dense, MoE, SSM and hybrid decoders.  Raises
    NotImplementedError for an arch the port does not build.

    With a ``mesh`` (``policy`` default ``ShardPolicy(tp=False,
    zero=False)``), every rank calls it with the whole ``token``, its
    params from :func:`init_serving_params` and its state from
    ``init_decode_state(shard=step.shard)``: lanes over ``data``, each
    cache's context (or KV heads) and each SSM state's heads over
    ``model`` (``runtime/sharding.py::decode_state_specs``).  The logits
    are every lane's whole rows, the same on every rank."""
    build_stacks(cfg)
    ctx = None if mesh is None else _serving_context(cfg, mesh, policy)

    @torch.inference_mode()
    def step(params: LM, state: Dict[str, Any], token: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        if ctx is not None:
            ctx.bind(params)
        return decode_step(params, state, token, cfg, shard=ctx)

    step.shard = ctx
    return step


def make_paged_decode_step(cfg: ModelConfig, *,
                           mesh: Optional[DeviceMesh] = None,
                           policy: Optional[ShardPolicy] = None
                           ) -> Callable[..., torch.Tensor]:
    """``(params, pools, token (B,), page_rows (B,P), lengths (B,))`` ->
    logits (B, V); the pools are written in place.

    With a ``mesh`` (``policy`` default ``ShardPolicy(tp=False,
    zero=False)``): the inputs whole on every rank, the pools from
    ``init_paged_state(shard=step.shard)`` (their KV heads over ``model``
    under TP, ``paged_state_specs``), params from
    :func:`init_serving_params`; the logits whole, the same on every
    rank."""
    ctx = None if mesh is None else _serving_context(cfg, mesh, policy)

    @torch.inference_mode()
    def step(params: LM, pools: List[Pool], token: torch.Tensor,
             page_rows: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        if ctx is not None:
            ctx.bind(params)
        return paged_decode_step(params, pools, token, page_rows, lengths,
                                 cfg, shard=ctx)

    step.shard = ctx
    return step


def make_paged_prefill_step(cfg: ModelConfig, *,
                            mesh: Optional[DeviceMesh] = None,
                            policy: Optional[ShardPolicy] = None
                            ) -> Callable[..., torch.Tensor]:
    """``(params, pools, tokens (PB,S), page_rows (PB,P), base, prompt_len
    (PB,))`` -> last-prompt-position logits (PB, V); the pools are written
    in place.  ``mesh`` and ``policy`` as :func:`make_paged_decode_step`."""
    ctx = None if mesh is None else _serving_context(cfg, mesh, policy)

    @torch.inference_mode()
    def step(params: LM, pools: List[Pool], tokens: torch.Tensor,
             page_rows: torch.Tensor, base: int,
             prompt_len: torch.Tensor) -> torch.Tensor:
        if ctx is not None:
            ctx.bind(params)
        return paged_prefill_step(params, pools, tokens, page_rows, base,
                                  prompt_len, cfg, shard=ctx)

    step.shard = ctx
    return step
