"""Pipeline-parallel runtime: micro-batches pipelined over the ``pipe`` axis
of a ``DeviceMesh`` with point-to-point stage hand-off, composable with data
parallelism on a ``data`` axis (``repro/runtime/pipeline.py``).

The *schedule* is data, not code: ``runtime/schedules.py`` compiles a named
schedule (``gpipe`` / ``1f1b`` / ``1f1b-interleaved`` / ``zb-h1``) into
per-tick tables, and :func:`make_pipeline_loss_from_program` walks the
forward projection of whatever table it is handed.  Virtual stage
``s = v·P + i`` holds layers ``[s·Lc, (s+1)·Lc)`` on pipe rank ``i`` as
chunk ``v`` (:func:`stage_split_params`, :func:`init_stage`).  Each tick, the
first virtual stage embeds its micro-batch, every other stage takes the
previous tick's hand-off over ``i → i+1`` (and over the wrap link
``P-1 → 0`` when ``V > 1``), and the last virtual stage runs the final
norm, the head (``embed.T`` when tied) and the cross entropy where the
table's ``loss_valid`` is set; the loss is those ticks' sum over ``m``.

The JAX runtime differentiates its scan with autodiff.  PyTorch cannot
differentiate across processes, so the backward is scheduled here: it walks
the ticks in reverse order, which is the order autodiff of the scan takes,
and each stage sends the gradient of its tick input back along the hand-off
link.  ``gpipe`` keeps each tick's autograd graph; the schedules with
``prog.remat`` set (``1f1b``, ``1f1b-interleaved``, ``zb-h1``) stash only the
tick's input and recompute the tick in the backward, the counterpart of
``jax.checkpoint(tick)``.  The tables' genuine B/W ticks are not executed
(``zb-h1`` runs its forward projection, as in the JAX runtime).

Gradients of the stacked blocks stay on their rank; the replicated leaves'
gradients are summed over ``pipe``; then loss and gradients are averaged
over ``data``.  The loss *value* is summed over ``pipe`` after the
backward, never inside it.

Two deliberate differences from the JAX runtime:

(a) bubble slots (``valid`` false) do no work: their outputs are never
    consumed and their loss is masked, so the JAX runtime's computation
    there only costs time;
(b) the replicated leaves live where they are used rather than on every
    pipe rank: the embedding on the first stage, the final norm and the
    head on the last, a tied embedding on both, its gradient summed between
    the two.  At qwen3-4b's width that saves 0.78 B parameters a rank.

Hand-offs, and the sums over ``pipe`` and ``data``, travel as host
tensors over gloo (one card refuses two NCCL ranks); a group of another
backend raises.  Only one
homogeneous stack is pipelined: the hybrid, encoder-decoder models and a
MoE model with dense blocks first (kimi-k2) raise, as the JAX runtime's
assert does.  A MoE stack (arctic-480b) runs with its load-balance aux
loss dropped, as the JAX runtime drops it (``h, _ = block(...)``).
"""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.kernels.ring_attention import host_tensor
from repro_torch.models.common import ModelConfig
from repro_torch.models.embedding import embed
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.models.transformer import (_BLOCK_APPLY, LM, _logits,
                                            build_stacks, init_lm_parts)
from repro_torch.runtime.schedules import ScheduleProgram, compile_schedule
from repro_torch.runtime.sharding import check_gloo

Batch = Dict[str, torch.Tensor]


def _check_stack(cfg: ModelConfig) -> str:
    """The one homogeneous stack's kind (a MoE model of MoE blocks only,
    such as arctic-480b, included); raises ValueError otherwise (the
    hybrid, kimi-k2's dense first layer before its MoE blocks, an
    encoder-decoder's two stacks), as the reference asserts one stack,
    and for a VLM, whose patches the pipeline's loss would not read (the
    reference's pipeline trains it text-only, its projector idle)."""
    if cfg.is_encoder_decoder:
        raise ValueError(
            f"pipeline runtime requires one homogeneous stack; "
            f"{cfg.name!r} is an encoder-decoder, with an encoder and a "
            f"decoder stack (run it unpipelined)")
    if cfg.arch_type == "vlm":
        raise ValueError(
            f"the pipeline runtime trains on tokens only; {cfg.name!r} is a "
            f"VLM, whose batches carry patches for its projector (run it "
            f"unpipelined: runtime/executor.py's make_train_step)")
    stacks = build_stacks(cfg)
    if cfg.arch_type == "hybrid" or len(stacks) != 1:
        raise ValueError(
            f"pipeline runtime requires one homogeneous stack; "
            f"{cfg.name!r} is {cfg.arch_type!r} with segments "
            f"{[kind for kind, _ in stacks]} (run it unpipelined)")
    return stacks[0][0]


def stage_layers(n_layers: int, n_stages: int, n_chunks: int,
                 stage: int) -> List[List[int]]:
    """The layers of each chunk ``v`` on pipe rank ``stage``: those of
    virtual stage ``v·P + stage``, ``[s·Lc, (s+1)·Lc)`` with
    ``Lc = L / (P·V)``.  Raises ValueError when ``P·V`` does not divide
    ``L``."""
    PV = n_stages * n_chunks
    if n_layers % PV:
        raise ValueError(f"{n_layers} layers not divisible by {n_stages} "
                         f"stages x {n_chunks} chunks")
    lc = n_layers // PV
    return [list(range((v * n_stages + stage) * lc,
                       (v * n_stages + stage + 1) * lc))
            for v in range(n_chunks)]


class StageParams(nn.Module):
    """One pipe rank's share of an :class:`~repro_torch.models.transformer.LM`.

    ``blocks`` is keyed by global layer index, so ``named_parameters()``
    gives the LM's own names (``blocks.4.attn.wq``); ``chunks[v]`` lists
    chunk ``v``'s layers.  ``embed`` is held by the first stage, and by the
    last when the embeddings are tied; ``final_norm`` and ``head`` by the
    last."""

    def __init__(self, blocks: Dict[int, nn.Module], chunks: List[List[int]],
                 *, stage: int, n_stages: int,
                 embed: Optional[torch.Tensor] = None,
                 final_norm: Optional[torch.Tensor] = None,
                 head: Optional[torch.Tensor] = None):
        super().__init__()
        self.stage, self.n_stages, self.chunks = stage, n_stages, chunks
        # the LM's order: embed, blocks, final_norm, head
        self.register_parameter("embed", _param(embed))
        self.blocks = nn.ModuleDict({str(j): blocks[j]
                                     for chunk in chunks for j in chunk})
        self.register_parameter("final_norm", _param(final_norm))
        self.register_parameter("head", _param(head))

    def chunk_blocks(self, v: int) -> List[nn.Module]:
        return [self.blocks[str(j)] for j in self.chunks[v]]

    @property
    def embed_copy(self) -> bool:
        """True on the last of several stages holding a tied embedding: a
        copy of the first stage's, counted there only."""
        return (self.embed is not None and self.n_stages > 1
                and self.stage == self.n_stages - 1)


def _param(t: Optional[torch.Tensor]) -> Optional[nn.Parameter]:
    if t is None or isinstance(t, nn.Parameter):
        return t
    return nn.Parameter(t)


def _holds(stage: int, n_stages: int, tied: bool) -> Dict[str, bool]:
    first, last = stage == 0, stage == n_stages - 1
    return {"embed": first or (last and tied), "final_norm": last,
            "head": last and not tied}


def stage_split_params(params: LM, n_stages: int,
                       n_chunks: int = 1) -> List[StageParams]:
    """Split a whole model into its ``n_stages`` pipe ranks' shares (the
    same tensors, not copies): rank ``i``'s chunk ``v`` carries the layers
    of global virtual stage ``v·P + i``, the interleaved round-robin
    placement of the JAX package's ``stage_split_params``; with V = 1 this
    is the plain contiguous split.  Raises ValueError for a model with a
    shared attention block, a VLM's projector or blocks of two kinds
    (kimi-k2's dense first layer before its MoE blocks), or when ``P·V``
    does not divide the layers."""
    if params.shared_attn is not None:
        raise ValueError("pipeline runtime requires one homogeneous stack; "
                         "the model has a shared attention block")
    if params.projector is not None:
        raise ValueError("the pipeline runtime trains on tokens only; the "
                         "model has a VLM's projector")
    kinds = sorted({type(b).__name__ for b in params.blocks})
    if len(kinds) > 1:
        raise ValueError("pipeline runtime requires one homogeneous stack; "
                         f"the model has blocks of {kinds}")
    tied = params.head is None
    out = []
    for i in range(n_stages):
        chunks = stage_layers(len(params.blocks), n_stages, n_chunks, i)
        has = _holds(i, n_stages, tied)
        out.append(StageParams(
            {j: params.blocks[j] for chunk in chunks for j in chunk}, chunks,
            stage=i, n_stages=n_stages,
            embed=params.embed if has["embed"] else None,
            final_norm=params.final_norm if has["final_norm"] else None,
            head=params.head if has["head"] else None))
    return out


def init_stage(cfg: ModelConfig, n_stages: int, n_chunks: int, stage: int, *,
               seed: int = 0, device: torch.device = "cuda") -> StageParams:
    """Pipe rank ``stage``'s share of ``init_lm(cfg, seed=seed)``: the same
    numbers (the generator draws the whole model in sequence) without ever
    holding the whole model, each unneeded part dropped once drawn."""
    _check_stack(cfg)
    chunks = stage_layers(cfg.n_layers, n_stages, n_chunks, stage)
    mine = {j for chunk in chunks for j in chunk}
    has = _holds(stage, n_stages, cfg.tie_embeddings)
    parts = init_lm_parts(cfg, seed=seed, device=device,
                          keep=lambda part: part in mine or has.get(part,
                                                                    False))
    return StageParams(parts["blocks"], chunks, stage=stage,
                       n_stages=n_stages, embed=parts["embed"],
                       final_norm=(parts["final_norm"] if has["final_norm"]
                                   else None),
                       head=parts["head"])


# --------------------------------------------------------------------------
# the tick loop
# --------------------------------------------------------------------------

def make_pipeline_loss(cfg: ModelConfig, mesh: DeviceMesh, n_micro: int,
                       schedule: str = "gpipe",
                       n_chunks: Optional[int] = None):
    """``loss_and_grads(stage, batch)`` running the compiled ``schedule``
    over ``mesh``'s ``pipe`` axis; see
    :func:`make_pipeline_loss_from_program`."""
    n_stages = mesh.size(mesh.mesh_dim_names.index("pipe"))
    prog = compile_schedule(schedule, n_stages, n_micro, n_chunks)
    return make_pipeline_loss_from_program(cfg, mesh, prog)


class _Link:
    """Point-to-point hand-offs along the pipe ring: posted receives, and
    sends kept alive until :meth:`drain`."""

    def __init__(self, group: dist.ProcessGroup, stage: int, n_stages: int,
                 device: torch.device):
        check_gloo(group, "the pipeline")
        self.group, self.device = group, device
        self.nxt = dist.get_global_rank(group, (stage + 1) % n_stages)
        self.prv = dist.get_global_rank(group, (stage - 1) % n_stages)
        self.sends: List[Tuple[Any, torch.Tensor]] = []
        self.wait_s = 0.0

    def post_recv(self, src: int, shape, dtype, tag: int):
        buf = torch.empty(shape, dtype=dtype,
                          pin_memory=self.device.type == "cuda")
        return dist.irecv(buf, src, self.group, tag), buf

    def wait(self, posted) -> torch.Tensor:
        req, buf = posted
        t0 = time.perf_counter()
        req.wait()
        self.wait_s += time.perf_counter() - t0
        return buf.to(self.device, non_blocking=True)

    def send(self, x: torch.Tensor, dst: int, tag: int) -> None:
        x = host_tensor(x.detach())
        self.sends.append((dist.isend(x, dst, self.group, tag), x))

    def drain(self) -> None:
        for req, _ in self.sends:
            req.wait()
        self.sends.clear()


def _host_sum(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    """``x`` summed over the gloo ``group`` on the host."""
    check_gloo(group, "the pipeline")
    h = x.detach().cpu()
    dist.all_reduce(h, group=group)
    return h.to(x.device)


def make_pipeline_loss_from_program(cfg: ModelConfig, mesh: DeviceMesh,
                                    prog: ScheduleProgram):
    """The generic tick loop for any compiled :class:`ScheduleProgram`.

    Returns ``loss_and_grads(stage, batch) -> (loss, grads)``, called on
    every rank of ``mesh`` (dims ``("pipe", "data")``) with the rank's
    :class:`StageParams` and the global batch: ``tokens``/``labels``
    (m, B_m, S), micro dim leading, of which the rank takes its ``data``
    shard of B_m.  ``loss`` is the 0-d fp32 loss summed over ``pipe`` and
    averaged over ``data``; ``grads`` are aligned with
    ``stage.parameters()``.  Three-phase programs run their forward
    projection.  ``loss_and_grads.stats`` holds the last call's ticks
    worked and idle, and its seconds computing and waiting for receives:
    on a CUDA device each tick's work ends in a synchronize, which the
    hand-off's copy to the host would wait for anyway, so the compute time
    is the device's."""
    prog = prog.forward_program()
    names = mesh.mesh_dim_names
    P = mesh.size(names.index("pipe"))
    if prog.n_stages != P:
        raise ValueError(f"a program for {prog.n_stages} stages on a pipe "
                         f"axis of {P}")
    kind = _check_stack(cfg)
    block = _BLOCK_APPLY[kind]
    m, V, T = prog.n_micro, prog.n_chunks, prog.n_ticks
    pipe = mesh.get_group("pipe")
    i = mesh.get_local_rank("pipe")
    n_data = mesh.size(names.index("data"))
    data = mesh.get_group("data")
    d_idx = mesh.get_local_rank("data")
    last_vs = P * V - 1
    ticks = [t for t in range(T) if prog.valid[t, i]]
    vstage = {t: int(prog.chunk_index[t, i]) * P + i for t in ticks}
    mb_of = {t: int(prog.mb_index[t, i]) for t in ticks}

    def loss_and_grads(stage: StageParams, batch: Batch
                       ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        if (stage.stage, stage.n_stages, len(stage.chunks)) != (i, P, V):
            raise ValueError(
                f"stage {stage.stage} of {stage.n_stages} with "
                f"{len(stage.chunks)} chunks on pipe rank {i} of {P} running "
                f"{V} chunks")
        leaves = list(stage.parameters())
        dev = leaves[0].device
        B = batch["tokens"].shape[1] // n_data
        tokens = batch["tokens"][:, d_idx * B:(d_idx + 1) * B].to(dev)
        labels = batch["labels"][:, d_idx * B:(d_idx + 1) * B].to(dev)
        S = tokens.shape[2]
        positions = torch.arange(S, device=dev).expand(B, S)
        shape = (B, S, cfg.d_model)
        link = _Link(pipe, i, P, dev)
        busy = [0.0]

        def tick(t: int, x: Optional[torch.Tensor]):
            """Tick ``t``'s work: (output, loss or None)."""
            v, mb = vstage[t] // P, mb_of[t]
            if vstage[t] == 0:
                x = embed(stage.embed, tokens[mb]).to(cfg.dtype)
            for blk in stage.chunk_blocks(v):
                x = block(blk, x, positions, cfg, window=cfg.sliding_window)
                if kind == "moe":           # the aux loss is dropped
                    x = x[0]
            loss = None
            if prog.loss_valid[t, i]:
                loss = cross_entropy_loss(_logits(stage, x, cfg), labels[mb])
            return x, loss

        def timed(fn, *args):
            t0 = time.perf_counter()
            out = fn(*args)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            busy[0] += time.perf_counter() - t0
            return out

        for p in leaves:
            p.grad = None
        # forward: every receive posted up front (tag: the consumer's tick)
        recvs = {t: link.post_recv(link.prv, shape, cfg.dtype, t)
                 for t in ticks if vstage[t] > 0}
        saved: Dict[int, Any] = {}
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for t in ticks:
            x_in = link.wait(recvs.pop(t)) if vstage[t] > 0 else None
            if prog.remat:
                with torch.no_grad():
                    y, loss = timed(tick, t, x_in)
                saved[t] = x_in
            else:
                if x_in is not None:
                    x_in.requires_grad_()
                y, loss = timed(tick, t, x_in)
                saved[t] = (x_in, y, loss)
            if loss is not None:
                acc = acc + loss.detach()
            if vstage[t] < last_vs:
                link.send(y, link.nxt, t + 1)
            del y, loss
        link.drain()
        # backward, in reverse tick order (tag: T + the consumer's tick)
        recvs = {t: link.post_recv(link.nxt, shape, cfg.dtype, T + t + 1)
                 for t in ticks if vstage[t] < last_vs}
        seed = torch.full((), 1.0 / m, dtype=torch.float32, device=dev)
        for t in reversed(ticks):
            dy = link.wait(recvs.pop(t)) if vstage[t] < last_vs else None

            def back(t=t, dy=dy):
                if prog.remat:
                    x_in = saved.pop(t)
                    if x_in is not None:
                        x_in.requires_grad_()
                    with torch.enable_grad():
                        y, loss = tick(t, x_in)
                else:
                    x_in, y, loss = saved.pop(t)
                if dy is None:
                    torch.autograd.backward(loss, seed)
                else:
                    torch.autograd.backward(y, dy)
                return x_in

            x_in = timed(back)
            if vstage[t] > 0:
                link.send(x_in.grad, link.prv, T + t)
            del x_in, dy
        link.drain()
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in leaves]
        for p in leaves:
            p.grad = None
        # a tied embedding held by the first and the last stage (the first
        # parameter of both): the sum of the two (a + b == b + a, so both
        # ranks hold the same bits)
        if stage.embed is not None and P > 1 and cfg.tie_embeddings:
            g = grads[0]
            peer = link.prv if stage.stage == 0 else link.nxt
            mine = host_tensor(g)
            other = torch.empty_like(mine)
            for req in dist.batch_isend_irecv(
                    [dist.P2POp(dist.isend, mine, peer, pipe),
                     dist.P2POp(dist.irecv, other, peer, pipe)]):
                req.wait()
            grads[0] = g + other.to(dev)
        loss = acc / m
        if P > 1:
            loss = _host_sum(loss, pipe)
        if n_data > 1:
            grads = [_host_sum(g, data) / n_data for g in grads]
            loss = _host_sum(loss, data) / n_data
        loss_and_grads.stats = {
            "work_ticks": len(ticks), "bubble_ticks": T - len(ticks),
            "program_bubble_ticks": prog.bubble_ticks,
            "busy_s": busy[0], "recv_wait_s": link.wait_s}
        return loss, grads

    loss_and_grads.stats = {}
    return loss_and_grads


def pipeline_grad_norm(stage: StageParams, grads: Sequence[torch.Tensor],
                       mesh: DeviceMesh) -> torch.Tensor:
    """The global gradient norm of a pipelined model: the square root of
    the sum over ``pipe`` of each rank's squared gradients, every leaf
    counted on exactly one rank (a tied embedding's copy on the last stage
    is not).  Gradients are the same on every ``data`` rank after
    :func:`make_pipeline_loss_from_program`'s average, so ``data`` is not
    summed.  Equals ``optim.adamw.global_norm`` of the whole model's
    gradients, summed in another order."""
    parts = [g.float().square().sum()
             for k, g in enumerate(grads)
             if not (k == 0 and stage.embed_copy)]
    dev = grads[0].device
    sq = (torch.stack(parts).sum() if parts
          else torch.zeros((), dtype=torch.float32, device=dev))
    sq = _host_sum(sq, mesh.get_group("pipe"))
    return torch.sqrt(sq)
