"""Device steps: training, prefill, the dense-cache decode step and the
serving engine's (``runtime/executor.py`` counterpart).

The JAX package jit-compiles each step with shardings and donated buffers.
PyTorch runs eagerly, so a built step is the model function itself: the
training step runs value-and-grad of ``lm_loss`` and the AdamW update, which
writes the parameters and optimizer state in place; the prefill and serving
steps run under ``torch.inference_mode()``, and the serving steps update the
caches or pools in place.

Each step runs on one device, or sharded over the ranks of a ``("data",
"model")`` or ``("data", "expert")`` mesh by a
:class:`~repro_torch.runtime.sharding.ShardPolicy`: training with DP,
ZeRO-3, head-aligned TP (a MoE layer's experts over ``model``) or EP (its
experts over ``expert``, the batch over ``data`` x ``expert``), remat per
segment and stash-only sequence sharding (each rank holds its shards of
the parameters and of the AdamW state: :func:`init_train_state`,
:func:`shard_train_state`); serving with the lanes over the batch axes
(x ``expert``), the paged pools' KV heads over ``model`` under TP, the
dense caches' context (or KV heads) and the SSM states' heads over
``model`` (:func:`init_serving_params`).  The paged steps do not run on an
expert mesh: their pools serve every lane on every rank, and EP needs the
lanes split.  The collectives GSPMD inserts in the JAX package run
explicitly (``runtime/sharding.py``).

An encoder-decoder config (``models/encdec.py``) takes the same steps:
its params come from ``init_encdec``, its training step runs
``encdec_loss`` (the reference's ``loss_fn_for``), its prefill is the
encoder and the teacher-forced decoder, and its serving step
``encdec_decode_step`` on the state of ``init_encdec_decode_state``; with
a mesh each runs sharded as a decoder-only model's does (``shard=``
through ``models/encdec.py``).  The paged steps are decoder-only.

A VLM config (internvl2-26b) takes a decoder-only model's steps: its
training and prefill batches carry ``patches`` (B, n_vis, d_vision),
which ``lm_forward`` projects and prepends (on a mesh, each rank's lanes
of them); its serving steps take tokens only, as the reference's do.
"""
from __future__ import annotations

import copy
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device
from repro_torch.models.attention import Pool
from repro_torch.models.common import ModelConfig
from repro_torch.models.encdec import (EncDec, decode_train,
                                       encdec_decode_step, encdec_loss,
                                       encode, init_encdec)
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
                     ) -> Tuple[LM | EncDec, Dict[str, Any]]:
    """Random weights from ``seed`` on ``device`` and their AdamW state:
    ``init_lm``'s, or for an encoder-decoder config ``init_encdec``'s (its
    default 4096-row decoder position table, as the reference's
    ``init_train_state``).

    With a ``mesh`` (``("data", "model")`` or ``("data", "expert")``, every
    rank calling), each rank draws ``init_lm``'s (``init_encdec``'s)
    numbers in its order and keeps its shards under ``policy`` (default
    ``ShardPolicy()``), each full part freed as soon as it is sliced (a MoE
    layer's experts kept only where they are the rank's): the numbers are
    the single process's on the same device type.  Raises
    NotImplementedError for an arch the port does not build."""
    dev = resolve_device(device)
    params = _draw(cfg, seed, dev, None if mesh is None else ShardContext(
        cfg, mesh, policy or ShardPolicy()))
    return params, adamw_init(list(params.parameters()), opt_cfg)


def _draw(cfg: ModelConfig, seed: int, dev: torch.device,
          ctx: Optional[ShardContext]) -> LM | EncDec:
    """``init_encdec`` or ``init_lm`` of ``seed``; with ``ctx`` the rank's
    shards."""
    if cfg.is_encoder_decoder:
        return init_encdec(cfg, seed=seed, device=dev,
                           shard=None if ctx is None else ctx.shard_part)
    if ctx is None:
        return init_lm(cfg, seed=seed, device=dev)
    return init_lm(cfg, seed=seed, device=dev, shard=ctx.shard_part,
                   experts=ctx.expert_range())


def shard_train_state(params: LM | EncDec, mesh: DeviceMesh,
                      policy: ShardPolicy, *, cfg: ModelConfig,
                      opt_cfg: Optional[AdamWConfig] = None
                      ) -> Tuple[LM | EncDec, Dict[str, Any]]:
    """:func:`init_train_state`'s sharded state from a full model of
    ``cfg`` (for example one bridged from JAX by
    ``bridge.params_from_jax``): its parameters replaced by this rank's
    shards, in place, and their AdamW state."""
    params = ShardContext(cfg, mesh, policy).shard_model(params)
    return params, adamw_init(list(params.parameters()), opt_cfg)


def gather_params(params: LM | EncDec, mesh: DeviceMesh,
                  policy: ShardPolicy, *, cfg: ModelConfig) -> LM | EncDec:
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
    global batch (int ``tokens``/``labels`` (B, S), for an encoder-decoder
    also ``frames`` (B, T_enc, d), for a VLM ``patches`` (B, n_vis,
    d_vision), on any device), of which each rank takes its batch rows
    (over ``data``, x ``expert`` on an expert mesh).
    ``loss`` is the global
    batch's 0-d fp32 loss, the same on every rank; ``grads``, aligned with
    ``params.parameters()``, are the rank's shards of the global gradient.
    Remat follows ``policy.remat_segments`` (an encoder-decoder's both
    stacks by its first entry, as ``make_train_step``'s).
    ``loss_and_grads.shard`` is the :class:`ShardContext`.  Raises as
    ``ShardContext`` does."""
    ctx = ShardContext(cfg, mesh, policy)
    remat = list(policy.remat_segments) if policy.remat_segments else None
    if cfg.is_encoder_decoder:
        def loss_fn(params, batch):
            return encdec_loss(params, batch, cfg,
                               remat=bool(remat and remat[0]), shard=ctx)
    else:
        def loss_fn(params, batch):
            return lm_loss(params, batch, cfg, remat_segments=remat,
                           shard=ctx)

    def loss_and_grads(params: LM | EncDec, batch: Dict[str, torch.Tensor]
                       ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        named = ctx.bind(params)
        leaves = [p for _, p in named]
        local = ctx.local_batch(batch, leaves[0].device)
        share = loss_fn(params, local)
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
    in place.  ``batch`` holds int ``tokens`` and ``labels`` (B, S), for
    an encoder-decoder config float ``frames`` (B, T_enc, d), and for a
    VLM config float ``patches`` (B, n_vis, d_vision) (``lm_loss``).
    ``remat_segments`` goes to :func:`lm_loss`; an encoder-decoder runs
    ``encdec_loss`` with ``remat = bool(remat_segments and
    remat_segments[0])``, the reference's ``loss_fn_for``.

    With a ``mesh`` the step is the sharded one (:func:`make_sharded_loss`
    under ``policy``, default ``ShardPolicy()``, whose ``remat_segments``
    it takes): ``batch`` is the global batch, ``params`` and ``opt_state``
    this rank's shards (:func:`init_train_state`), the gradient norm that
    of the whole model (every shard and every replicated leaf counted
    once), and AdamW updates the local shards.  Raises
    NotImplementedError for an arch the port does not build."""
    opt_cfg = opt_cfg or AdamWConfig()
    if mesh is not None:
        if not cfg.is_encoder_decoder:
            build_stacks(cfg)
        if remat_segments is not None:
            raise ValueError("a sharded step takes remat from "
                             "policy.remat_segments")
        return _sharded_step(cfg, opt_cfg, mesh, policy or ShardPolicy())
    if cfg.is_encoder_decoder:
        remat = bool(remat_segments and remat_segments[0])

        def loss_fn(params, batch):
            return encdec_loss(params, batch, cfg, remat=remat)
    else:
        build_stacks(cfg)

        def loss_fn(params, batch):
            return lm_loss(params, batch, cfg, remat_segments=remat_segments)

    def step(params: LM | EncDec, opt_state: Dict[str, Any],
             batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        leaves = list(params.parameters())
        loss = loss_fn(params, batch)
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

    def step(params: LM | EncDec, opt_state: Dict[str, Any],
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


def _refuse_paged_encdec(cfg: ModelConfig) -> None:
    """The paged steps serve decoder-only models, as the reference's."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            f"{cfg.name!r} is an encoder-decoder: the paged steps serve "
            "decoder-only models (its cross-attention reads per-lane "
            "encoder K/V); serve it with make_prefill_step and "
            "make_serve_step")


def _serving_context(cfg: ModelConfig, mesh: DeviceMesh,
                     policy: Optional[ShardPolicy], *,
                     paged: bool = False) -> ShardContext:
    if paged and "expert" in (mesh.mesh_dim_names or ()):
        raise NotImplementedError(
            "the paged engine does not run on an expert mesh: its pools "
            "serve every lane on every rank, and expert parallelism needs "
            "the lanes split over data x expert (serve the dense-cache "
            "engine, or TP on a ('data', 'model') mesh)")
    return ShardContext(cfg, mesh, policy or SERVING_POLICY, serving=True)


def init_serving_params(cfg: ModelConfig, *,
                        mesh: Optional[DeviceMesh] = None,
                        policy: Optional[ShardPolicy] = None, seed: int = 0,
                        device: torch.device = "cuda") -> LM | EncDec:
    """Random weights from ``seed`` on ``device`` for the serving steps
    (``init_encdec``'s for an encoder-decoder config).

    With a ``mesh`` each rank draws ``init_lm``'s (``init_encdec``'s)
    numbers and keeps its shards under ``policy`` (default
    ``ShardPolicy(tp=False, zero=False)``, the serving CLIs' policy):
    the rule table's (``param_specs``), except that under TP each Mamba2
    ``in_proj`` is the rank's columns (``models/ssm.py::ssm_tp_columns``),
    taken once here rather than gathered over ``model`` every step."""
    return _draw(cfg, seed, resolve_device(device), None if mesh is None
                 else _serving_context(cfg, mesh, policy))


def shard_serving_params(params: LM | EncDec, mesh: DeviceMesh,
                         policy: Optional[ShardPolicy] = None, *,
                         cfg: ModelConfig) -> LM | EncDec:
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
    every arch the port builds (a VLM's ``batch["patches"]`` (B, n_vis,
    d_vision), where present, projected and prepended; the logits are the
    text rows').  Raises NotImplementedError for another arch.
    For an encoder-decoder, ``decode_train`` of the tokens against
    ``encode`` of ``batch["frames"]`` (B, T_enc, d).

    With a ``mesh`` (``policy`` default ``ShardPolicy(tp=False,
    zero=False)``; params from :func:`init_serving_params`), every rank
    calls it with the whole batch and gets its block of the logits, as the
    reference's step leaves them sharded: its lanes (rows split over
    ``data``, x ``expert`` on an expert mesh, when they divide,
    ``ShardContext.lane_range``) and under TP
    its vocabulary columns ``[r V / tp, (r + 1) V / tp)`` (an
    encoder-decoder's whole rows where its table does not split,
    ``ShardContext.split_vocab``).
    ``step.shard`` is the :class:`ShardContext`."""
    if cfg.is_encoder_decoder:
        ctx = None if mesh is None else _serving_context(cfg, mesh, policy)

        @torch.inference_mode()
        def encdec(params: EncDec, batch: Dict[str, torch.Tensor]
                   ) -> torch.Tensor:
            tokens, frames = batch["tokens"], batch["frames"]
            if ctx is not None:
                ctx.bind(params)
                lo, hi = ctx.lane_range(tokens.shape[0])
                tokens, frames = tokens[lo:hi], frames[lo:hi]
            dev = params.embed.device
            return decode_train(params, tokens.to(dev),
                                encode(params, frames, cfg, shard=ctx), cfg,
                                shard=ctx)

        encdec.shard = ctx
        return encdec
    build_stacks(cfg)
    if mesh is None:
        @torch.inference_mode()
        def step(params: LM, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
            return lm_forward(params, batch["tokens"], cfg,
                              patches=batch.get("patches"))[0]

        return step
    ctx = _serving_context(cfg, mesh, policy)

    @torch.inference_mode()
    def sharded(params: LM, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        ctx.bind(params)
        dev = params.embed.device
        lo, hi = ctx.lane_range(batch["tokens"].shape[0])
        patches = batch.get("patches")
        if patches is not None:
            patches = patches[lo:hi].to(dev)
        return lm_forward(params, batch["tokens"][lo:hi].to(dev), cfg,
                          patches=patches, shard=ctx)[0]

    sharded.shard = ctx
    return sharded


def make_serve_step(cfg: ModelConfig, *, mesh: Optional[DeviceMesh] = None,
                    policy: Optional[ShardPolicy] = None
                    ) -> Callable[..., Tuple[torch.Tensor, Dict[str, Any]]]:
    """``(params, state, token (B,))`` -> ``(logits (B, V), state)``: one
    decode step on the KV caches and SSM states of ``init_decode_state``,
    written in place, for dense, MoE, SSM, hybrid and VLM decoders (a
    VLM's tokens only, as the reference's); for an
    encoder-decoder, ``encdec_decode_step`` on the state of
    ``init_encdec_decode_state``.  Raises NotImplementedError for an arch
    the port does not build.

    With a ``mesh`` (``policy`` default ``ShardPolicy(tp=False,
    zero=False)``), every rank calls it with the whole ``token``, its
    params from :func:`init_serving_params` and its state from
    ``init_decode_state(shard=step.shard)`` (an encoder-decoder's from
    ``init_encdec_decode_state(shard=step.shard)``): lanes over ``data``
    (x ``expert`` on an expert mesh), each
    cache's context (or KV heads) and each SSM state's heads over
    ``model`` (``runtime/sharding.py::decode_state_specs``; under TP an
    encoder-decoder's cross K/V the rank's heads).  The logits are every
    lane's whole rows, the same on every rank."""
    if not cfg.is_encoder_decoder:
        build_stacks(cfg)
    ctx = None if mesh is None else _serving_context(cfg, mesh, policy)
    if cfg.is_encoder_decoder:
        def encdec(params: EncDec, state: Dict[str, Any],
                   token: torch.Tensor
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
            if ctx is not None:
                ctx.bind(params)
            return encdec_decode_step(params, state, token, cfg, shard=ctx)

        encdec.shard = ctx
        return encdec

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
    _refuse_paged_encdec(cfg)
    ctx = (None if mesh is None
           else _serving_context(cfg, mesh, policy, paged=True))

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
    _refuse_paged_encdec(cfg)
    ctx = (None if mesh is None
           else _serving_context(cfg, mesh, policy, paged=True))

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
