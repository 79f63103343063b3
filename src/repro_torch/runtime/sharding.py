"""Plan -> sharded execution over ``torch.distributed`` ranks
(``repro/runtime/sharding.py``).

A searched plan maps onto a ``("data", "model")`` or ``("data",
"expert")`` mesh as in the JAX package (DESIGN.md §3):

  * TP level  -> parameters sharded along ``model`` (Megatron column/row
                 parallel; the vocabulary of the embedding and the head),
  * SDP level -> parameters *additionally* sharded along the batch axes
                 (ZeRO-3),
  * DP level  -> the batch dim sharded along the batch axes,
  * CKPT      -> remat per layer-stack segment,
  * EP level  -> the experts sharded along ``expert``, the batch dim
                 co-sharded over the batch axes x ``expert``, MoE dispatch
                 by all-to-all (``models/moe.py::_moe_ep``),
  * PP, SP    -> the pipeline runtime and ring attention.

The first half of this module is the reference's rule table:
:func:`leaf_spec` gives each parameter, per dim, the mesh axes it shards
over (``None``, ``"model"`` or a tuple of batch axes), the entries of the
JAX package's ``PartitionSpec``; :func:`param_specs`, :func:`opt_specs` and
:func:`batch_specs` apply it to a model, its AdamW state and a batch.  Any
mapping of axis name to size stands for a mesh here, so the tables can be
drawn for a pod without its ranks.

PyTorch has no GSPMD to insert the collectives, so the second half runs
them explicitly, Megatron style (:class:`ShardContext`): each rank holds its
shard of every leaf; a ZeRO leaf is all-gathered over ``data`` where it is
used and its gradient reduce-scattered in the backward; TP runs
copy-to-TP-region (whose backward sums over ``model``) before each column
product and reduce-from-TP-region (whose forward sums over ``model``)
after each row product; the embedding lookup and the cross entropy are
vocab-parallel where the vocabulary splits over ``model`` (a table and an
untied head that the rule table leaves whole over ``model`` are looked up
and projected whole on every ``model`` rank,
:attr:`ShardContext.split_vocab`); the other gradients are summed over
``data``.  Attention
runs on the rank's ``n_heads / tp`` query heads and ``n_kv_heads / tp``
KV heads, split head-aligned, so query head h still reads KV head h // G:
tp must divide ``n_kv_heads`` (GSPMD would reshard a split head; the rule
table itself only checks divisibility, as the reference's does).  A VLM's
projector is a Megatron MLP: w1 column-parallel, w2 row-parallel.  A Mamba2
block runs on the rank's ``ssm_heads / tp`` heads: its ``in_proj`` is
stored as the contiguous column shard the rule table names, which cuts
across the packed ``[z | x | B | C | dt]`` columns, so the block gathers
it over ``model`` on use (backward: a reduce-scatter) and takes its heads'
z, x and dt columns and all of B and C; the gated norm runs, forward and
backward, on whole ``d_inner`` rows gathered over ``model``, alike on
every rank (``models/ssm.py::ssm_block``).  GSPMD reshards the split
columns instead; the numbers are the same.  A MoE layer under TP holds
``n_experts / tp`` experts, routes every token on every ``model`` rank and
sums the partial outputs over ``model`` (``models/moe.py::_moe_tp``, the
reference's ``_moe_shmap``); on an expert mesh the ``expert`` ranks act as
data ranks for everything but the experts, whose gradients alone are
summed over ``data`` only.

Serving takes the reference's serving rules too: :func:`paged_state_specs`
(the page pools' KV heads over ``model`` under TP) and
:func:`decode_state_specs` (dense caches' lanes over the batch axes and
their context, else their KV heads, over ``model``; SSM states' heads over
``model``), which :class:`DecodeLayout` reads for a rank's share.  A model
placed for serving (``ShardContext(serving=True)``) holds each Mamba2
``in_proj`` as the rank's columns rather than the rule table's shard.  A
cache whose context splits over ``model`` is read by each rank on its
slots, and the parts' attention is merged from their row log-sum-exp
(:meth:`ShardContext.merge_context`).

Every collective carries host tensors over gloo (one card refuses two NCCL
ranks; a group of another backend raises): a CUDA tensor is copied into
pinned memory, and received tensors are summed back on its device.  Sums
are taken in fp32 in rank order from an ``all_to_all`` (a reduce-scatter)
and shared by an all-gather, so every rank holds the same bits and two
runs give the same bits; bf16 partial sums travel in bf16 and are rounded
once after the fp32 sum.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import (Any, Callable, Dict, List, Mapping, Optional, Sequence,
                    Tuple, Union)

import torch
import torch.distributed as dist
from torch import nn
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.kernels.ring_attention import host_tensor
from repro_torch.runtime.dry import DryMesh, is_dry
from repro_torch.models.common import ModelConfig
from repro_torch.models.encdec import init_encdec
from repro_torch.models.ssm import ssm_tp_columns
from repro_torch.models.transformer import init_lm

Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]
MeshLike = Union[DeviceMesh, Mapping[str, int]]


@dataclasses.dataclass(frozen=True)
class ShardPolicy:
    """How a plan's dominant strategy maps to the fixed mesh."""
    tp: bool = True            # use the "model" axis for parameter sharding
    zero: bool = True          # SDP: shard params over the batch axes too
    remat_segments: Optional[Tuple[bool, ...]] = None
    # beyond-paper knobs (perf iteration):
    shard_cache_seq: bool = True   # decode KV cache: shard context over "model"
    expert_axis: str = "model"     # mesh axis carrying the expert dimension
    seq_shard: bool = False        # Megatron-style sequence parallelism on
                                   # the residual stream (stash / model)
    sp_degree: int = 1             # ring-attention sequence parallelism: the
                                   # searched plan.sp_degree
    ep_degree: int = 1             # expert parallelism: the searched
                                   # plan.ep_degree (format v5)

    @staticmethod
    def from_strategy(strategy, remat_segments=None) -> "ShardPolicy":
        ep = getattr(strategy, "ep", 1)
        return ShardPolicy(tp=strategy.tp > 1, zero=strategy.sdp > 1,
                           remat_segments=tuple(remat_segments or ()) or None,
                           sp_degree=getattr(strategy, "sp", 1),
                           ep_degree=ep,
                           expert_axis="expert" if ep > 1 else "model")


# --------------------------------------------------------------------------
# the rule table
# --------------------------------------------------------------------------

def mesh_axes(mesh: MeshLike) -> Dict[str, int]:
    """{axis name: size} of a ``DeviceMesh`` or of a mapping, in order."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return {n: mesh.size(i) for i, n in enumerate(mesh.mesh_dim_names)}


def batch_axes(mesh: MeshLike) -> Tuple[str, ...]:
    axes = mesh_axes(mesh)
    return tuple(a for a in ("pod", "data") if a in axes)


def _axis_size(mesh: MeshLike, axes) -> int:
    if axes is None:
        return 1
    if isinstance(axes, str):
        axes = (axes,)
    sizes = mesh_axes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


def _fits(mesh: MeshLike, dim: int, axes) -> bool:
    s = _axis_size(mesh, axes)
    return s > 1 and dim % s == 0


# parameter-name classes
_COLUMN = {"wq", "wk", "wv", "w_gate", "w_up", "in_proj", "w_fc", "w1"}
_ROW = {"wo", "w_down", "out_proj", "w_proj", "w2"}
_EMBED = {"embed"}
_HEAD = {"head"}
_REPLICATED_HINT = {"router"}
# the port's block lists that the JAX package stacks on a leading L axis
_STACKED = ("blocks.", "enc_blocks.", "dec_blocks.")


def _rule(name: str, shape: Sequence[int], mesh: MeshLike,
          pol: ShardPolicy) -> List[Entry]:
    """The reference's ``_leaf_spec`` on a leaf of the JAX layout, padded
    to the leaf's rank."""
    nd = len(shape)
    bt = batch_axes(mesh)
    model = "model" if ("model" in mesh_axes(mesh) and pol.tp) else None
    zero = bt if (pol.zero and bt) else None
    out: List[Entry] = [None] * nd

    if name in _REPLICATED_HINT or nd <= 1:
        return out
    if name in _EMBED and nd == 2:
        return [model if _fits(mesh, shape[0], model) else None,
                zero if _fits(mesh, shape[1], zero) else None]
    if name in _HEAD and nd == 2:
        return [zero if _fits(mesh, shape[0], zero) else None,
                model if _fits(mesh, shape[1], model) else None]
    if name in ("enc_pos", "dec_pos"):
        return out
    # MoE stacked experts: (L, E, d, f) / (L, E, f, d)
    if name in (_COLUMN | _ROW) and nd == 4:
        e_ax = pol.expert_axis if pol.tp or pol.expert_axis != "model" else None
        e_ax = e_ax if _fits(mesh, shape[1], e_ax) else None
        z_ax = zero if _fits(mesh, shape[2], zero) else None
        return [None, e_ax, z_ax, None]
    if name in _COLUMN:         # (..., d_in, d_out): column parallel
        out[-1] = model if _fits(mesh, shape[-1], model) else None
        out[-2] = zero if _fits(mesh, shape[-2], zero) else None
        return out
    if name in _ROW:
        out[-2] = model if _fits(mesh, shape[-2], model) else None
        out[-1] = zero if _fits(mesh, shape[-1], zero) else None
        return out
    # default: try ZeRO-sharding the largest dim (skipping stacked L at 0)
    if pol.zero and nd >= 2:
        big = max(range(1, nd), key=lambda i: shape[i])
        if _fits(mesh, shape[big], zero):
            out[big] = zero
    return out


def leaf_spec(name: str, shape: Sequence[int], mesh: MeshLike,
              pol: ShardPolicy) -> Spec:
    """Per dim of the port parameter ``name`` (``blocks.3.attn.wq``,
    ``embed``) of ``shape``, the mesh axes it shards over.

    The JAX package stacks a segment's blocks on a leading layer axis, and
    its rules read that rank: a block's leaf is judged as the stacked leaf
    would be (a block's 1-D norm is ZeRO-sharded like the stacked (L, d)
    one) and the layer entry dropped, so the table equals the reference's
    on every leaf.  The encoder-decoder's ``enc_blocks.N.`` and
    ``dec_blocks.N.`` are such blocks too."""
    leaf = name.rsplit(".", 1)[-1]
    if name.startswith(_STACKED):
        return tuple(_rule(leaf, (1, *shape), mesh, pol)[1:])
    return tuple(_rule(leaf, tuple(shape), mesh, pol))


def _named_shapes(params) -> List[Tuple[str, Tuple[int, ...]]]:
    if isinstance(params, nn.Module):
        return [(n, tuple(p.shape)) for n, p in params.named_parameters()]
    return [(n, tuple(s)) for n, s in params]


def param_specs(params, mesh: MeshLike, pol: ShardPolicy) -> Dict[str, Spec]:
    """{name: :func:`leaf_spec`} of a model (an ``nn.Module`` at full size,
    on any device, ``meta`` included) or of (name, shape) pairs."""
    return {n: leaf_spec(n, s, mesh, pol) for n, s in _named_shapes(params)}


def opt_specs(params, mesh: MeshLike, pol: ShardPolicy) -> Dict[str, Any]:
    """AdamW's state mirrors the parameters' specs; the step is
    replicated.  {"step": (), "master"/"m"/"v": specs aligned with
    ``params``}."""
    specs = list(param_specs(params, mesh, pol).values())
    return {"step": (), "master": specs, "m": list(specs),
            "v": list(specs)}


def batch_specs(shapes: Mapping[str, Sequence[int]], mesh: MeshLike,
                pol: Optional[ShardPolicy] = None) -> Dict[str, Spec]:
    """Every leading batch dimension over the batch axes (co-sharded over
    ``expert`` with ``pol.ep_degree > 1`` and an ``expert`` axis); dim 1
    over ``seq`` with ``pol.sp_degree > 1`` and a ``seq`` axis; a dim that
    does not divide stays whole."""
    bt = batch_axes(mesh)
    axes = mesh_axes(mesh)
    if pol is not None and pol.ep_degree > 1 and "expert" in axes:
        bt = bt + ("expert",)
    seq = ("seq" if (pol is not None and pol.sp_degree > 1
                     and "seq" in axes) else None)
    out = {}
    for k, shape in shapes.items():
        entries: List[Entry] = [None] * len(shape)
        if len(shape) >= 1 and bt and shape[0] % _axis_size(mesh, bt) == 0:
            entries[0] = bt
        if seq and len(shape) >= 2 and shape[1] % _axis_size(mesh, seq) == 0:
            entries[1] = seq
        out[k] = tuple(entries)
    return out


def _map_named(tree, fn, name: str = ""):
    """``fn(name, shape)`` on every tensor of a tree of dicts and lists,
    ``name`` the last dict key above it (the JAX package's path rule: a
    list entry takes its list's key); other leaves are kept."""
    if isinstance(tree, Mapping):
        return {k: _map_named(v, fn, k) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map_named(v, fn, name) for v in tree)
    if isinstance(tree, torch.Tensor):
        return fn(name, tuple(tree.shape))
    return tree


def _paged_leaf(name: str, shape: Sequence[int], mesh: MeshLike,
                pol: ShardPolicy) -> Spec:
    """The reference's ``paged_state_shardings`` rule on one leaf."""
    model = "model" if ("model" in mesh_axes(mesh) and pol.tp) else None
    nd = len(shape)
    if name in ("k", "v") and nd >= 4:
        entries: List[Entry] = [None] * nd
        if model and shape[nd - 2] % _axis_size(mesh, model) == 0:
            entries[nd - 2] = model
        return tuple(entries)
    return ()


def paged_state_specs(pools, mesh: MeshLike, pol: ShardPolicy):
    """Per dim of each K/V page pool (``init_paged_state``: one {"k", "v"}
    of (n_pages + 1, page_size, KV, dh) a layer), the mesh axes it shards
    over: under TP the KV-head dim over ``model`` (head-parallel decode),
    when it divides.  The page dim stays whole on every rank, data ranks
    included: every lane may read any pool row.  The reference's
    ``paged_state_shardings`` on each leaf (its stacked layer dim
    dropped); the same tree with a spec for each tensor."""
    return _map_named(pools, lambda n, s: _paged_leaf(n, s, mesh, pol))


def _decode_leaf(name: str, shape: Sequence[int], mesh: MeshLike,
                 pol: ShardPolicy) -> Spec:
    """The reference's ``decode_state_shardings`` rule on one leaf."""
    bt = batch_axes(mesh)
    model = "model" if "model" in mesh_axes(mesh) else None
    nd = len(shape)
    entries: List[Entry] = [None] * nd

    def lanes(off: int) -> None:
        if bt and nd > off and shape[off] % _axis_size(mesh, bt) == 0:
            entries[off] = bt

    if name in ("k", "v") and nd >= 4:      # (..., B, C, KV, dh)
        off = nd - 4
        lanes(off)
        if (pol.shard_cache_seq and model
                and shape[off + 1] % _axis_size(mesh, model) == 0):
            entries[off + 1] = model
        elif model and shape[off + 2] % _axis_size(mesh, model) == 0:
            entries[off + 2] = model
        return tuple(entries)
    if name == "ssm" and nd >= 4:           # (..., B, H, P, N)
        off = nd - 4
        lanes(off)
        if model and shape[off + 1] % _axis_size(mesh, model) == 0:
            entries[off + 1] = model
        return tuple(entries)
    if name == "conv" and nd >= 3:          # (..., B, K-1, C)
        lanes(nd - 3)
        return tuple(entries)
    if name == "cross_kv" or (nd >= 2 and name not in ("index",)):
        lanes(1 if nd >= 2 and shape[0] < 256 else 0)  # stacked-L heuristic
        return tuple(entries)
    return ()


def decode_state_specs(state, mesh: MeshLike, pol: ShardPolicy):
    """Per dim of each tensor of a dense-cache decode state
    (``init_decode_state`` on one device, or its shapes on ``meta``), the
    mesh axes it shards over: K/V caches' lanes over the batch axes and
    their context over ``model`` (``pol.shard_cache_seq``, when it
    divides), else their KV heads; SSM states' lanes over the batch axes
    and heads over ``model``; the conv history's lanes only; the index
    whole; an encoder-decoder's ``cross_kv`` (one (k, v) a decoder layer)
    its lanes only.  Not gated on ``pol.tp``.  The reference's
    ``decode_state_shardings`` on each leaf (a stacked leaf's layer dim
    dropped, which its rule skips by rank); the same tree with a spec for
    each tensor.  Under TP the port's ``cross_kv`` holds the rank's KV
    heads (``models/encdec.py::init_encdec_decode_state``), where this
    spec, as the reference's, keeps them whole."""
    out = _map_named(state, lambda n, s: _decode_leaf(n, s, mesh, pol))
    if isinstance(state, Mapping) and "self_cache" in state:
        # an encoder-decoder's state: a layer's (B, T, KV, dh) cross K/V
        # judged as the reference's stacked (L, B, T, KV, dh) leaf
        n_layers = len(state["cross_kv"])
        out["cross_kv"] = _map_named(
            state["cross_kv"], lambda n, s: _decode_leaf(
                n, (n_layers, *s), mesh, pol)[1:], "cross_kv")
    return out


@dataclasses.dataclass(frozen=True)
class DecodeLayout:
    """Where a sharded dense-cache decode state lies, by
    :func:`decode_state_specs` (``ShardContext.decode_layout``): this
    rank's lanes ``[lo, hi)`` of ``batch`` (every lane unless they split
    over ``data``); what of each K/V cache of ``span`` slots splits over a
    ``model`` axis of several ranks: ``"seq"`` (rank ``r`` holds slots
    ``[r span/m, (r+1) span/m)``), ``"heads"`` (its KV heads) or None
    (whole); whether each SSM state's heads split over it."""
    batch: int
    span: int
    lanes: Tuple[int, int]
    kv: Optional[str]
    ssm_heads: bool


# --------------------------------------------------------------------------
# host collectives over gloo
# --------------------------------------------------------------------------

# the reference's HLO opcodes of collectives (``repro/roofline/``)
COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


class Traffic:
    """Bytes this rank sent through gloo (a dry group's: would send), in
    all (``bytes_sent``) and by collective under the reference's opcode
    names (``per_op``).  The port's :func:`all_reduce` is a reduce-scatter
    plus an all-gather; both halves count under ``"all-reduce"``, as one
    HLO all-reduce would, and so does :func:`all_reduce_max`'s gather.
    ``a2a_bytes`` counts the MoE all-to-alls apart (they are in
    ``bytes_sent`` too); nothing here sends a ``"collective-permute"``."""

    def __init__(self):
        self.bytes_sent = 0
        self.a2a_bytes = 0
        self.per_op = dict.fromkeys(COLLECTIVES, 0)

    def add(self, n: int, op: str) -> None:
        self.bytes_sent += n
        self.per_op[op] += n
        if op == "all-to-all":
            self.a2a_bytes += n


def group_size(group) -> int:
    """The ranks of a process group or of a dry group
    (``runtime/dry.py``)."""
    return group.size if is_dry(group) else dist.get_world_size(group)


def check_gloo(group: dist.ProcessGroup, what: str) -> None:
    """Raise unless ``group`` is a gloo group (or a dry one): ``what`` (the
    pipeline's hand-offs, the sharded executor's collectives) carries host
    tensors."""
    if is_dry(group):
        return
    backend = dist.get_backend(group)
    if backend != "gloo":
        raise ValueError(f"{what} carries host tensors over gloo; the "
                         f"group's backend is {backend!r}")


def _pinned(shape, dtype, cuda: bool) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, pin_memory=cuda)


def _charge(traffic: Optional[Traffic], n: int, op: str) -> None:
    if traffic is not None:
        traffic.add(n, op)


def all_gather_dim(x: torch.Tensor, group: dist.ProcessGroup, dim: int,
                   traffic: Optional[Traffic] = None, *,
                   op: str = "all-gather") -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in rank order; the
    bytes this rank sends are added to ``traffic`` under ``op``.  On a dry
    group, an empty tensor of the result's shape."""
    n = group_size(group)
    if n == 1:
        return x
    if is_dry(group):
        _charge(traffic, (n - 1) * x.numel() * x.element_size(), op)
        shape = list(x.shape)
        shape[dim] *= n
        return x.new_empty(shape)
    h = host_tensor(x.detach().movedim(dim, 0).contiguous())
    out = _pinned((n * h.shape[0], *h.shape[1:]), h.dtype, x.is_cuda)
    dist.all_gather_into_tensor(out, h, group=group)
    _charge(traffic, (n - 1) * h.numel() * h.element_size(), op)
    return out.to(x.device).movedim(0, dim).contiguous()


def reduce_scatter_dim(x: torch.Tensor, group: dist.ProcessGroup, dim: int,
                       traffic: Optional[Traffic] = None, *,
                       op: str = "reduce-scatter") -> torch.Tensor:
    """This rank's slice along ``dim`` of the group's sum: chunk ``j`` of
    every rank goes to rank ``j`` (``all_to_all``), which adds them in
    fp32 (float64 in float64) in rank order on ``x``'s device and rounds
    once to its dtype.  On a dry group, an empty tensor of the slice's
    shape."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {n} ranks")
    if is_dry(group):
        _charge(traffic, (n - 1) * x.numel() // n * x.element_size(), op)
        shape = list(x.shape)
        shape[dim] //= n
        return x.new_empty(shape)
    h = host_tensor(x.detach().movedim(dim, 0).contiguous())
    recv = _pinned(h.shape, h.dtype, x.is_cuda)
    dist.all_to_all_single(recv, h, group=group)
    _charge(traffic, (n - 1) * h.numel() // n * h.element_size(), op)
    parts = recv.to(x.device).reshape(n, h.shape[0] // n, *h.shape[1:])
    acc = parts[0].to(torch.promote_types(x.dtype, torch.float32))
    for j in range(1, n):
        acc += parts[j].to(acc.dtype)
    return acc.to(x.dtype).movedim(0, dim).contiguous()


def all_to_all_dim0(x: torch.Tensor, group: dist.ProcessGroup,
                    traffic: Optional[Traffic] = None) -> torch.Tensor:
    """Chunk ``j`` of ``x`` along dim 0 sent to rank ``j`` of ``group``;
    the chunks received, in rank order along dim 0 (the tiled
    ``all_to_all`` of the reference's ``_moe_ep``)."""
    n = group_size(group)
    if n == 1:
        return x
    if x.shape[0] % n:
        raise ValueError(f"dim 0 of {tuple(x.shape)} does not split over "
                         f"{n} ranks")
    _charge(traffic, (n - 1) * x.numel() // n * x.element_size(),
            "all-to-all")
    if is_dry(group):
        return x.new_empty(x.shape)
    h = host_tensor(x.detach().contiguous())
    recv = _pinned(h.shape, h.dtype, x.is_cuda)
    dist.all_to_all_single(recv, h, group=group)
    return recv.to(x.device)


def all_reduce(x: torch.Tensor, group: dist.ProcessGroup,
               traffic: Optional[Traffic] = None) -> torch.Tensor:
    """The group's sum, the same bits on every rank (a reduce-scatter of
    the flattened tensor, padded to the group, then an all-gather)."""
    n = group_size(group)
    if n == 1:
        return x
    flat = x.reshape(-1)
    pad = (-flat.numel()) % n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    full = all_gather_dim(reduce_scatter_dim(flat, group, 0, traffic,
                                             op="all-reduce"),
                          group, 0, traffic, op="all-reduce")
    return full[:x.numel()].reshape(x.shape)


def all_reduce_max(x: torch.Tensor, group: dist.ProcessGroup,
                   traffic: Optional[Traffic] = None) -> torch.Tensor:
    if group_size(group) == 1:
        return x
    return all_gather_dim(x[None], group, 0, traffic,
                          op="all-reduce").amax(0)


# --------------------------------------------------------------------------
# autograd functions: the collectives GSPMD would insert
# --------------------------------------------------------------------------

class _GatherOnUse(torch.autograd.Function):
    """ZeRO: forward all-gathers a shard along ``dim``; backward
    reduce-scatters the gradient, summing the data ranks' shares."""

    @staticmethod
    def forward(ctx, x, group, dim, traffic):
        ctx.group, ctx.dim, ctx.traffic = group, dim, traffic
        return all_gather_dim(x, group, dim, traffic)

    @staticmethod
    def backward(ctx, g):
        return (reduce_scatter_dim(g, ctx.group, ctx.dim, ctx.traffic),
                None, None, None)


class _CopyToTP(torch.autograd.Function):
    """Megatron's copy-to-TP-region: identity; backward sums over
    ``model``."""

    @staticmethod
    def forward(ctx, x, group, traffic):
        ctx.group, ctx.traffic = group, traffic
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group, ctx.traffic), None, None


class _AllToAll(torch.autograd.Function):
    """:func:`all_to_all_dim0`; backward sends each chunk's gradient back
    to the rank it came from (the same exchange)."""

    @staticmethod
    def forward(ctx, x, group, traffic):
        ctx.group, ctx.traffic = group, traffic
        return all_to_all_dim0(x, group, traffic)

    @staticmethod
    def backward(ctx, g):
        return all_to_all_dim0(g, ctx.group, ctx.traffic), None, None


class _ReduceFromTP(torch.autograd.Function):
    """Megatron's reduce-from-TP-region: sums over ``model``; backward is
    the identity."""

    @staticmethod
    def forward(ctx, x, group, traffic):
        return all_reduce(x, group, traffic)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


class _GatherSlices(torch.autograd.Function):
    """The slices of ``group`` gathered along ``dim``, entering work that
    runs replicated on every rank of the group (stash-only sequence
    parallelism entering a layer, dim 1; the gated norm's whole rows, the
    last dim), so each rank's gradient is the whole one: backward keeps
    this rank's slice."""

    @staticmethod
    def forward(ctx, x, group, rank, dim, traffic):
        ctx.rank, ctx.n, ctx.dim = rank, x.shape[dim], dim
        return all_gather_dim(x, group, dim, traffic)

    @staticmethod
    def backward(ctx, g):
        a = ctx.rank * ctx.n
        return (g.narrow(ctx.dim, a, ctx.n).contiguous(), None, None, None,
                None)


class _KeepSlice(torch.autograd.Function):
    """Leaving replicated work: this rank's slice along ``dim``; backward
    gathers the slices' gradients."""

    @staticmethod
    def forward(ctx, x, group, rank, dim, traffic):
        ctx.group, ctx.dim, ctx.traffic = group, dim, traffic
        n = x.shape[dim] // group_size(group)
        return x.narrow(dim, rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g):
        return (all_gather_dim(g, ctx.group, ctx.dim, ctx.traffic), None,
                None, None, None)


class _VocabParallelCE(torch.autograd.Function):
    """Per-token fp32 (float64 logits: float64) cross entropy of logits
    split over ``model`` along the vocabulary (this rank's columns ``[lo,
    lo + V_local)``): the max, the sum of exponentials and the gold logit
    are reduced over the group; backward is softmax minus one-hot on the
    rank's columns."""

    @staticmethod
    def forward(ctx, logits, labels, lo, group, traffic):
        lf = logits.to(torch.promote_types(logits.dtype, torch.float32))
        m = all_reduce_max(lf.amax(-1), group, traffic)
        e = torch.exp(lf - m[..., None])
        se = all_reduce(e.sum(-1), group, traffic)
        local = labels.long() - lo
        inr = (local >= 0) & (local < lf.shape[-1])
        idx = local.clamp(0, lf.shape[-1] - 1)
        gold = all_reduce(lf.gather(-1, idx[..., None])[..., 0] * inr, group,
                          traffic)
        ctx.save_for_backward(e, se, idx, inr)
        ctx.dtype = logits.dtype
        return m + torch.log(se) - gold

    @staticmethod
    def backward(ctx, g):
        e, se, idx, inr = ctx.saved_tensors
        grad = e / se[..., None]
        grad.scatter_add_(-1, idx[..., None], -inr.to(grad.dtype)[..., None])
        grad *= g[..., None]
        return grad.to(ctx.dtype), None, None, None, None


class _Apply(nn.Module):
    """``fn(block, ...)`` as a module call, so that ``functional_call`` can
    hand the block its gathered weights."""

    def __init__(self, fn: Callable, blk: nn.Module):
        super().__init__()
        self.fn, self.blk = fn, blk

    def forward(self, *args, **kwargs):
        return self.fn(self.blk, *args, **kwargs)


# --------------------------------------------------------------------------
# the execution context
# --------------------------------------------------------------------------

def abstract_params(cfg: ModelConfig) -> nn.Module:
    """The model's parameters on the ``meta`` device: names and shapes,
    no storage (``init_lm``'s, a VLM's projector included;
    ``init_encdec``'s for an encoder-decoder config, its default 4096-row
    decoder position table, as the reference's)."""
    if cfg.is_encoder_decoder:
        return init_encdec(cfg, device="meta")
    return init_lm(cfg, device="meta")


class ShardContext:
    """A sharded run's mesh, policy and specs, and the operations the model
    functions (``models/``) call when handed it as ``shard=``.

    The mesh must be a ``("data", "model")`` ``DeviceMesh`` (for example
    ``launch/mesh.py::make_local_mesh``) or a ``("data", "expert")`` one
    (``make_expert_mesh``) over the whole default group, with gloo groups,
    or a ``runtime/dry.py::DryMesh``: rank 0 of a mesh given as a mapping,
    whose collectives move nothing and count what they would send (the
    dry run's; its rule table drawn on ``DryMesh.spec_axes``).
    TP is on when ``policy.tp`` and the ``model`` axis has more than one
    rank; ``policy.seq_shard`` shards the residual stream's tokens over
    ``model``.  The mesh decides the policy's ``expert_axis`` and
    ``ep_degree``: on an expert mesh the experts shard over ``expert`` and
    the batch over ``data`` x ``expert`` (the ``batch`` group, the world),
    elsewhere the experts follow TP.  ``serving`` places each Mamba2
    ``in_proj`` under TP as the rank's columns
    (``models/ssm.py::ssm_tp_columns``), which the serving steps read
    without a gather.  Raises ValueError on another mesh or backend and on
    a TP degree that does not split what the model has: the attention heads
    and d_ff of a dense model (a VLM's, and its projector's width d) and
    of an encoder-decoder, the SSM heads of a Mamba2 block, the shared
    attention block's heads of the hybrid, the experts and the shared and
    residual branches' widths of a MoE model.  The embedding table and an
    untied head are split over ``model`` only where the rule table splits
    them (the vocabulary divides): elsewhere (internvl2's 92553, whisper's
    51865) every ``model`` rank looks up and projects onto the whole table
    or head, with the plain cross entropy, and their gradients, the same
    on every ``model`` rank, are not summed over ``model``
    (:attr:`split_vocab`)."""

    def __init__(self, cfg: ModelConfig, mesh: Union[DeviceMesh, DryMesh],
                 policy: ShardPolicy, *, serving: bool = False):
        names = tuple(mesh.mesh_dim_names or ())
        if names not in (("data", "model"), ("data", "expert")):
            raise ValueError(f"the sharded executor runs on a ('data', "
                             f"'model') or ('data', 'expert') mesh; got "
                             f"{mesh.mesh_dim_names}")
        dry = isinstance(mesh, DryMesh)
        if not dry and mesh.size() != dist.get_world_size():
            raise ValueError(f"a mesh of {mesh.size()} ranks in a world of "
                             f"{dist.get_world_size()}")
        # every rank's group: the world, or the dry mesh's
        self.world = mesh.world if dry else dist.group.WORLD
        axes = mesh_axes(mesh)
        # the mesh's second axis: "model" (TP) or "expert" (EP)
        self.axis = names[1]
        policy = dataclasses.replace(
            policy, expert_axis=self.axis,
            ep_degree=axes["expert"] if self.axis == "expert" else 1)
        self.cfg, self.mesh, self.policy = cfg, mesh, policy
        self.data = mesh.get_group("data")
        self.axis_group = mesh.get_group(self.axis)
        for g in (self.data, self.axis_group, self.world):
            check_gloo(g, "the sharded executor")
        self.n_data, self.n_axis = axes["data"], axes[self.axis]
        self.data_rank = mesh.get_local_rank("data")
        self.axis_rank = mesh.get_local_rank(self.axis)
        model = self.axis == "model"
        self.model = self.axis_group if model else None
        self.n_model = self.n_axis if model else 1
        self.model_rank = self.axis_rank if model else 0
        self.expert = None if model else self.axis_group
        self.n_expert = 1 if model else self.n_axis
        self.expert_rank = 0 if model else self.axis_rank
        # the batch rows split over data, and over expert too on an expert
        # mesh (rank r at (r // n_expert, r % n_expert) holds share r)
        self.batch = self.data if model else self.world
        self.n_batch = self.n_data * self.n_expert
        self.batch_rank = self.data_rank * self.n_expert + self.expert_rank
        self.rows = 0           # the global batch of the current forward
        self.tp = self.n_model if (policy.tp and self.n_model > 1) else 1
        if self.tp > 1:
            _check_tp(cfg, self.tp)
        abstract = abstract_params(cfg)
        self.specs = param_specs(abstract, mesh.spec_axes if dry else axes,
                                 policy)
        self._shapes = {n: tuple(p.shape)
                        for n, p in abstract.named_parameters()}
        # the vocabulary split over model (the embedding's rows; an untied
        # head's columns follow the same rule), else whole on every rank
        self.split_vocab = self.tp > 1 and self.specs["embed"][0] == "model"
        # a serving model holds each Mamba2 in_proj as the rank's columns
        # (models/ssm.py::ssm_tp_columns), taken once when it is placed,
        # where training gathers the rule table's shard every call
        self.serving = serving
        self._cut: Dict[str, List[Tuple[int, int]]] = {}
        if serving and self.tp > 1 and cfg.arch_type in ("ssm", "hybrid"):
            cols = ssm_tp_columns(cfg, self.tp, self.model_rank)
            for n, shape in list(self._shapes.items()):
                if n.endswith(".ssm.in_proj"):
                    self._cut[n] = cols
                    self._shapes[n] = (shape[0], sum(b - a for a, b in cols))
        self._zero: Dict[int, int] = {}
        self.traffic = Traffic()

    # ---- placement ------------------------------------------------------

    def _dims(self, name: str) -> Tuple[Optional[int], Optional[int]]:
        """(dim over the mesh's second axis, ``model`` or ``expert``; data
        dim) of a leaf, None where it is whole."""
        spec = self.specs[name]
        mdim = (None if name in self._cut else
                next((i for i, e in enumerate(spec) if e == self.axis),
                     None))
        ddim = next((i for i, e in enumerate(spec)
                     if isinstance(e, tuple)), None)
        return mdim, ddim

    def expert_range(self) -> Optional[Tuple[int, int]]:
        """This rank's experts ``[lo, hi)`` where the rule table splits a
        MoE model's experts over the mesh's second axis, else None (for
        ``init_lm(experts=)``, which then draws only them)."""
        name = next((n for n in self.specs if n.endswith(".moe.w_up")), None)
        if name is None or self.specs[name][0] != self.axis:
            return None
        n = self.cfg.n_experts // self.n_axis
        return self.axis_rank * n, (self.axis_rank + 1) * n

    def shard_tensor(self, name: str, full: torch.Tensor) -> torch.Tensor:
        """This rank's shard of the full leaf ``name``: a fresh tensor where
        it is cut (so the full one can be freed), else the leaf itself (a
        replicated leaf, or an expert leaf drawn as the rank's experts
        already, :meth:`expert_range`: no copy of either is made)."""
        mdim, ddim = self._dims(name)
        t = whole = full.detach()
        if name in self._cut:
            t = torch.cat([t[..., a:b] for a, b in self._cut[name]], dim=-1)
        if mdim is not None and t.shape[mdim] == self._shapes[name][mdim]:
            t = t.chunk(self.n_axis, mdim)[self.axis_rank]
        if ddim is not None:
            t = t.chunk(self.n_data, ddim)[self.data_rank]
        return t if t is whole else t.clone(
            memory_format=torch.contiguous_format)

    def shard_part(self, prefix: str, part):
        """``init_lm_parts``'s hook: a block or the shared attention block
        (its parameters replaced by their shards, in place) or a top-level
        leaf (its shard), named by ``prefix``."""
        if part is None:
            return None
        if isinstance(part, torch.Tensor):
            return self.shard_tensor(prefix, part)
        return self.shard_model(part, lambda name, p: self.shard_tensor(
            f"{prefix}.{name}", p))

    def shard_model(self, params: nn.Module,
                    fn: Optional[Callable[[str, torch.Tensor],
                                          torch.Tensor]] = None
                    ) -> nn.Module:
        """A full model's parameters replaced by this rank's shards, in
        place (or by ``fn(name, parameter)``)."""
        fn = fn or self.shard_tensor
        for name, p in list(params.named_parameters()):
            *path, leaf = name.split(".")
            owner = functools.reduce(getattr, path, params)
            owner._parameters[leaf] = nn.Parameter(fn(name, p))
        return params

    def gather_tensor(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """The full leaf ``name`` from this rank's shard ``t`` (a
        parameter or its gradient); a collective of every rank."""
        if name in self._cut:
            raise ValueError(f"{name} is placed for serving as this rank's "
                             "columns; the whole leaf is not its gather")
        mdim, ddim = self._dims(name)
        t = t.detach()
        if ddim is not None:
            t = all_gather_dim(t, self.data, ddim, self.traffic)
        if mdim is not None:
            t = all_gather_dim(t, self.axis_group, mdim, self.traffic)
        return t

    def bind(self, params: nn.Module) -> List[Tuple[str, torch.Tensor]]:
        """Check that ``params`` holds this rank's shards and note which are
        gathered on use; returns ``named_parameters()``."""
        named = list(params.named_parameters())
        if [n for n, _ in named] != list(self.specs):
            raise ValueError("the model's parameters are not the config's")
        self._zero = {}
        for name, p in named:
            mdim, ddim = self._dims(name)
            full = self._shapes[name]
            want = list(full)
            if mdim is not None:
                want[mdim] //= self.n_axis
            if ddim is not None:
                want[ddim] //= self.n_data
                self._zero[id(p)] = ddim
            if list(p.shape) != want:
                raise ValueError(f"{name}: shape {tuple(p.shape)} is not "
                                 f"this rank's shard {tuple(want)} of "
                                 f"{tuple(full)}")
        return named

    # ---- what the model functions call ----------------------------------

    def w(self, p: torch.Tensor) -> torch.Tensor:
        """A leaf as the computation uses it: a ZeRO shard gathered over
        ``data`` (its gradient reduce-scattered in the backward)."""
        dim = self._zero.get(id(p))
        if dim is None:
            return p
        return _GatherOnUse.apply(p, self.data, dim, self.traffic)

    def block(self, fn: Callable, blk: nn.Module, x: torch.Tensor,
              *args, seq: bool = False, **kwargs) -> torch.Tensor:
        """``fn(blk, x, ...)`` on the block's gathered weights, with the
        context as ``shard=``; with ``seq`` (x is a token slice, the flag
        :meth:`seq_slice` returned for the block's stack) on the gathered
        tokens, keeping this rank's slice of the output (of its first
        element where ``fn`` returns a tuple: a MoE block's ``(x,
        aux)``)."""
        if seq:
            x = _GatherSlices.apply(x, self.model, self.model_rank, 1,
                                    self.traffic)
        gathered = {f"blk.{n}": self.w(p) for n, p in blk.named_parameters()
                    if id(p) in self._zero}
        if gathered:
            y = torch.func.functional_call(_Apply(fn, blk), gathered,
                                           (x, *args),
                                           {**kwargs, "shard": self})
        else:
            y = fn(blk, x, *args, **kwargs, shard=self)
        if seq:
            if isinstance(y, tuple):
                return (_KeepSlice.apply(y[0], self.model, self.model_rank,
                                         1, self.traffic), *y[1:])
            y = _KeepSlice.apply(y, self.model, self.model_rank, 1,
                                 self.traffic)
        return y

    def seq_slice(self, x: torch.Tensor) -> Tuple[torch.Tensor, bool]:
        """The embedded tokens (B, S, d) entering a stack, and whether the
        stack runs on token slices: this rank's slice under sequence
        sharding, which is on for the forward when ``policy.seq_shard``
        holds, ``model`` has several ranks and splits S (the reference's
        constraint applies only then).  The flag goes to each of the
        stack's :meth:`block` calls and to :meth:`seq_gather`."""
        seq = (self.policy.seq_shard and self.n_model > 1
               and x.shape[1] % self.n_model == 0)
        if seq:
            x = _KeepSlice.apply(x, self.model, self.model_rank, 1,
                                 self.traffic)
        return x, seq

    def seq_gather(self, x: torch.Tensor, seq: bool) -> torch.Tensor:
        """A stack's output whole in the token dim (``seq`` as
        :meth:`seq_slice` returned it)."""
        return _GatherSlices.apply(x, self.model, self.model_rank, 1,
                                   self.traffic) \
            if seq else x

    def to_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Copy-to-TP-region: a replicated tensor entering TP-local work
        (also a replicated leaf used on the rank's heads, such as the
        QK-norm weights), whose gradient is summed over ``model``."""
        if self.tp == 1:
            return x
        return _CopyToTP.apply(x, self.model, self.traffic)

    def from_tp(self, x: torch.Tensor) -> torch.Tensor:
        """Reduce-from-TP-region: a row product's partial sums added over
        ``model``."""
        if self.tp == 1:
            return x
        return _ReduceFromTP.apply(x, self.model, self.traffic)

    def tp_local(self, t: torch.Tensor) -> torch.Tensor:
        """This rank's slice of the last dim of a replicated leaf (a QKV
        bias) for its heads, its gradient summed over ``model``."""
        if self.tp == 1:
            return t
        n = t.shape[-1] // self.tp
        return self.to_tp(t)[..., self.model_rank * n:
                             (self.model_rank + 1) * n]

    def gather_tp(self, t: torch.Tensor) -> torch.Tensor:
        """A column shard of a leaf over ``model`` made whole (the ranks'
        shards concatenated along the last dim); backward reduce-scatters:
        each rank's partial gradient of the whole summed over ``model``,
        its shard kept."""
        if self.tp == 1:
            return t
        return _GatherOnUse.apply(t, self.model, t.dim() - 1, self.traffic)

    def gather_columns(self, x: torch.Tensor) -> torch.Tensor:
        """The ``model`` ranks' columns of ``x`` (last dim) gathered into
        whole rows, for work that every rank then runs alike; backward
        keeps the rank's columns of the whole gradient, which every rank
        holds."""
        if self.tp == 1:
            return x
        return _GatherSlices.apply(x, self.model, self.model_rank,
                                   x.dim() - 1, self.traffic)

    def keep_columns(self, x: torch.Tensor) -> torch.Tensor:
        """The rank's columns of rows that every rank holds whole, leaving
        work run alike (:meth:`gather_columns`); backward gathers the
        columns' gradients, so that work runs its backward on whole
        rows."""
        if self.tp == 1:
            return x
        return _KeepSlice.apply(x, self.model, self.model_rank, x.dim() - 1,
                                self.traffic)

    def local_cfg(self, cfg: ModelConfig) -> ModelConfig:
        """The config of the rank's heads."""
        if self.tp == 1:
            return cfg
        return cfg.with_(n_heads=cfg.n_heads // self.tp,
                         n_kv_heads=cfg.n_kv_heads // self.tp,
                         head_dim=cfg.dh)

    def embed(self, table: torch.Tensor, tokens: torch.Tensor
              ) -> torch.Tensor:
        """The lookup; with the vocabulary split over ``model`` on the
        rank's rows, the others' rows added over ``model`` (each token's
        row lives on one rank)."""
        table = self.w(table)
        if not self.split_vocab:
            return torch.nn.functional.embedding(tokens, table)
        n = table.shape[0]
        local = tokens.long() - self.model_rank * n
        inr = (local >= 0) & (local < n)
        out = torch.nn.functional.embedding(local.clamp(0, n - 1), table)
        return self.from_tp(out * inr[..., None].to(out.dtype))

    def tied_logits(self, x: torch.Tensor, table: torch.Tensor
                    ) -> torch.Tensor:
        """``x @ table.T`` for a tied output projection (``table`` (V, d),
        a ZeRO shard gathered): with the vocabulary split over ``model`` x
        enters the TP region and the result is the rank's vocabulary
        columns; else every rank projects onto the whole table."""
        table = self.w(table)
        if self.split_vocab:
            x = self.to_tp(x)
        return x @ table.T

    def cross_entropy(self, logits: torch.Tensor, labels: torch.Tensor,
                      ignore_id: int = -100) -> torch.Tensor:
        """This rank's share of the mean token cross entropy: its tokens'
        summed loss over the label count of every batch rank (summed over
        the ``batch`` group, the shares give ``cross_entropy_loss`` of the
        global batch, and their gradients its gradient).  With the
        vocabulary split over ``model``, ``logits`` are the rank's
        vocabulary columns."""
        if self.split_vocab:
            lo = self.model_rank * logits.shape[-1]
            tok = _VocabParallelCE.apply(logits, labels, lo, self.model,
                                         self.traffic)
        else:
            lf = logits.to(torch.promote_types(logits.dtype, torch.float32))
            gold = lf.gather(-1, labels.long().clamp_min(0)[..., None])
            tok = torch.logsumexp(lf, dim=-1) - gold[..., 0]
        mask = (labels != ignore_id).float()
        count = all_reduce(mask.sum().detach(), self.batch, self.traffic)
        return (tok * mask).sum() / count.clamp_min(1.0)

    # ---- what the serving steps call ------------------------------------

    def lane_range(self, batch: int) -> Tuple[int, int]:
        """This rank's lanes ``[lo, hi)`` of ``batch``: its share over the
        ``batch`` group (``data``, x ``expert`` on an expert mesh) when it
        splits them (the rule of :func:`batch_specs`), else every lane.
        Notes ``batch`` as the global batch of the forward that follows
        (``rows``, which the MoE layer's gate reads)."""
        self.rows = batch
        if self.n_batch == 1 or batch % self.n_batch:
            return 0, batch
        b = batch // self.n_batch
        return self.batch_rank * b, (self.batch_rank + 1) * b

    def decode_layout(self, batch: int, span: int) -> DecodeLayout:
        """The :class:`DecodeLayout` of ``batch`` lanes of K/V caches of
        ``span`` slots (and SSM states), by :func:`decode_state_specs`."""
        cfg, axes = self.cfg, mesh_axes(self.mesh)
        k = _decode_leaf("k", (batch, span, max(cfg.n_kv_heads, 1), 1),
                         axes, self.policy)
        ssm = _decode_leaf("ssm", (batch, max(cfg.ssm_heads, 1), 1, 1),
                           axes, self.policy)
        kv = (None if self.n_model == 1 else "seq" if k[1] == "model"
              else "heads" if k[2] == "model" else None)
        return DecodeLayout(batch, span, self.lane_range(batch), kv,
                            self.n_model > 1 and ssm[1] == "model")

    def gather_model(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """The ``model`` ranks' ``x`` concatenated along ``dim``."""
        return all_gather_dim(x, self.model, dim % x.dim(), self.traffic)

    def gather_lanes(self, x: torch.Tensor, batch: int) -> torch.Tensor:
        """Every lane's rows of ``x`` (this rank's :meth:`lane_range` of
        ``batch`` along dim 0), gathered over the ``batch`` group when
        split."""
        lo, hi = self.lane_range(batch)
        if hi - lo == batch:
            return x
        return all_gather_dim(x, self.batch, 0, self.traffic)

    def gather_vocab(self, logits: torch.Tensor) -> torch.Tensor:
        """Whole rows of logits from the rank's vocabulary columns where
        the vocabulary splits over ``model`` (``torch.argmax`` on them
        breaks ties to the lowest index, as one process does, whatever the
        TP degree)."""
        if not self.split_vocab:
            return logits
        return self.gather_model(logits, -1)

    def merge_context(self, out: torch.Tensor, lse: torch.Tensor
                      ) -> torch.Tensor:
        """Attention over a cache whose slots split over ``model`` from
        each rank's part over its slots: ``out`` (B,S,H,dh) and its row
        log-sum-exp ``lse`` (B,S,H) fp32, ``+inf`` where the rank holds
        no admissible key (such a part weighs 0).  The parts are gathered,
        rescaled by ``exp(lse - max)`` and summed in fp32 in rank order,
        then divided and rounded once to ``out``'s dtype: every rank holds
        the same bits.  A row with no key on any rank gives zeros (the
        kernel's semantics)."""
        if self.n_model == 1:
            return out
        parts = self.gather_model(
            torch.cat([out.float(), lse[..., None]], -1)[None], 0)
        outs, lses = parts[..., :-1], parts[..., -1]
        lses = lses.masked_fill(lses == float("inf"), float("-inf"))
        top = lses.amax(0)
        top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
        w = torch.exp(lses - top)
        num = w[0, ..., None] * outs[0].float()
        den = w[0].clone()
        for j in range(1, outs.shape[0]):
            num += w[j, ..., None] * outs[j].float()
            den += w[j]
        merged = num / den.clamp_min(torch.finfo(den.dtype).tiny)[..., None]
        return merged.masked_fill((den == 0)[..., None], 0.0).to(out.dtype)

    def host_value(self, x: float) -> float:
        """Rank 0's ``x`` on every rank: a host decision (the serving
        engine's clock) that every rank must take alike (on a dry mesh,
        rank 0's own)."""
        if is_dry(self.world):
            return x
        t = torch.tensor([x], dtype=torch.float64)
        dist.broadcast(t, src=0)
        return float(t.item())

    # ---- the step's pieces ------------------------------------------------

    def local_batch(self, batch: Mapping[str, torch.Tensor],
                    device: torch.device) -> Dict[str, torch.Tensor]:
        """This batch rank's rows of the global batch (over ``data``, x
        ``expert`` on an expert mesh), on ``device``."""
        B = batch["tokens"].shape[0]
        if B % self.n_batch:
            raise ValueError(f"a batch of {B} does not split over "
                             f"{self.n_batch} batch ranks")
        self.rows = B
        b = B // self.n_batch
        return {k: v[self.batch_rank * b:(self.batch_rank + 1) * b].to(device)
                for k, v in batch.items()}

    def reduce_grads(self, named: Sequence[Tuple[str, torch.Tensor]],
                     grads: Sequence[Optional[torch.Tensor]]
                     ) -> List[torch.Tensor]:
        """Each leaf's gradient summed over the ``batch`` group: an expert
        leaf sharded over ``expert`` over ``data`` only; a ZeRO leaf's
        ``data`` sum was reduce-scattered in the backward (its ``expert``
        sum is taken here), the others are summed here."""
        out = []
        for (name, p), g in zip(named, grads):
            expert = "expert" in self.specs[name]
            if g is None:
                g = torch.zeros_like(p)
            elif id(p) not in self._zero:
                g = all_reduce(g, self.data if expert else self.batch,
                               self.traffic)
            elif not expert and self.n_expert > 1:
                g = all_reduce(g, self.expert, self.traffic)
            out.append(g)
        return out

    def grad_norm(self, named: Sequence[Tuple[str, torch.Tensor]],
                  grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """The global gradient norm: each shard counted on one rank (the
        one at index 0 of every axis the leaf is not sharded over), the
        squares summed over the world."""
        coord = {"data": self.data_rank, "model": self.model_rank,
                 "expert": self.expert_rank}
        dev = grads[0].device
        sq = torch.zeros((), dtype=torch.float32, device=dev)
        for (name, _), g in zip(named, grads):
            sharded = {a for e in self.specs[name] if e is not None
                       for a in ((e,) if isinstance(e, str) else e)}
            if all(coord[a] == 0 for a in coord if a not in sharded):
                sq = sq + g.float().square().sum()
        return torch.sqrt(all_reduce(sq, self.world, self.traffic))

    def data_sum(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` summed over the ``batch`` group (the shares of a loss)."""
        return all_reduce(x, self.batch, self.traffic)

    def all_to_all(self, x: torch.Tensor) -> torch.Tensor:
        """:func:`all_to_all_dim0` over ``expert``, differentiable."""
        return _AllToAll.apply(x, self.expert, self.traffic)


def _check_tp(cfg: ModelConfig, tp: int) -> None:
    """Head-aligned TP splits what the model has evenly: the attention heads
    and d_ff of a dense model (of a MoE model's dense blocks, of a VLM)
    and of an encoder-decoder, a VLM projector's width, the SSM heads of a
    Mamba2 block, the shared attention block's heads of the hybrid, a MoE
    model's experts (the rank runs its own) and its shared expert's and
    dense residual branch's widths.  The vocabulary need not split: the
    table and an untied head stay whole where it does not, as the rule
    table leaves them."""
    checks = []
    if cfg.is_encoder_decoder:
        checks += [("*_blocks.*.attn.wq", "n_heads", cfg.n_heads),
                   ("*_blocks.*.attn.wk", "n_kv_heads", cfg.n_kv_heads),
                   ("*_blocks.*.mlp.w_fc", "d_ff", cfg.d_ff)]
    elif cfg.arch_type in ("ssm", "hybrid"):
        checks.append(("blocks.*.ssm.in_proj", "ssm_heads", cfg.ssm_heads))
        if cfg.arch_type == "hybrid" and cfg.attn_every:
            checks += [("shared_attn.attn.wq", "n_heads", cfg.n_heads),
                       ("shared_attn.attn.wk", "n_kv_heads", cfg.n_kv_heads)]
    else:
        checks += [("blocks.*.attn.wq", "n_heads", cfg.n_heads),
                   ("blocks.*.attn.wk", "n_kv_heads", cfg.n_kv_heads)]
        if cfg.n_experts <= 1 or cfg.first_k_dense:
            checks.append(("blocks.*.mlp.w_up", "d_ff", cfg.d_ff))
    if cfg.n_experts > 1:
        checks.append(("blocks.*.moe.w_up", "n_experts", cfg.n_experts))
        for branch in ("shared_expert_ff", "dense_residual_ff"):
            if getattr(cfg, branch):
                leaf = branch.replace("_expert_ff", "").replace("_ff", "")
                checks.append((f"blocks.*.moe.{leaf}.w_up", branch,
                               getattr(cfg, branch)))
    if cfg.arch_type == "vlm":
        checks.append(("projector.w1", "d_model", cfg.d_model))
    for leaf, what, n in checks:
        if n % tp:
            raise ValueError(f"tp {tp} does not split {leaf}: {what} {n} "
                             f"is not a multiple of {tp}")
