"""Mixture-of-experts FFN with top-k routing (``repro/models/moe.py``
counterpart).

Three dispatches on one device, each with the reference's arithmetic:

  * ``sort``    — flat (token, choice) pairs are sorted by expert id
    (stable), ranked within each expert, and written into a dense
    (E·C + 1, d) buffer whose last row takes the dropped pairs.
  * ``einsum``  — GShard one-hot dispatch, O(T·E·C·d) extra work; the
    small-scale oracle for the sort path.
  * ``grouped`` — every token of the batch routed at once (one aux loss),
    dispatched per group into an (E·C, d) buffer through an add, a dropped
    pair sent to slot 0 with a zero value.

Groups are batch rows: tokens compete for expert capacity only within
their row.  The reference runs ``sort`` and ``einsum`` under ``jax.vmap``
over rows and averages their aux losses; here each runs over all rows at
once with the same per-row ranks and capacities, and the experts' products
run once over every row's buffer (``torch.bmm`` over E), as the vmapped
einsum does.  Every expert runs on its whole capacity buffer, empty slots
included.

Two deliberate differences from the reference, neither in the numbers it
defines:

  * the top-k is a stable descending sort, so ties go to the lower expert
    index as ``jax.lax.top_k`` gives them (``torch.topk`` promises no
    order among ties);
  * a token's k contributions are summed in a fixed order, that of the
    reference's scatter (sorted position, which is expert id), one add at
    a time in x's dtype: a scatter-add with repeated indices would use
    atomics on the card and change a bf16 sum of three or more terms from
    run to run.

Arctic's dense residual branch and Kimi-K2's shared expert are computed
alongside the routed experts.  The switch-style load-balance aux loss is
returned for the trainer (``lm_loss`` weighs it by ``router_aux_coef``).

Sharded (``shard``, ``runtime/sharding.py::ShardContext``), the layer runs
on the rank's rows, and one of:

  * :func:`_moe_ep` — the reference's ``_moe_ep`` on an expert mesh whose
    gate is open (:func:`expert_axis_usable`), for sort, grouped and
    shmap: the rank's E/ep experts, each group's (E·C, d) buffer built in
    global expert order and exchanged by one all-to-all over ``expert``
    each way;
  * :func:`_moe_tp` — the reference's ``_moe_shmap`` under TP: the rank's
    E/tp experts on the pairs routed to them, the partial outputs summed
    over ``model``;
  * the one-device dispatch, where the experts are whole on the rank.

The aux loss returned is then the rank's share: summed over the batch
ranks, the shares give the reference's aux of the global batch (a mean of
the groups' for sort, einsum and EP; a mean of the data ranks' joint aux
for shmap under ``_moe_shmap``; the global batch's joint aux for
grouped), and their gradients its gradient.  Deliberate differences: the
einsum dispatch raises where the experts are split over ranks, and so does
an expert mesh whose experts are split but whose batch is not.
"""
from __future__ import annotations

import math
from typing import Mapping, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import ModelConfig
from .layers import init_dense, swiglu
from .mlp import SwiGLU, init_swiglu, swiglu_mlp



class MoE(nn.Module):
    """router (d, E) fp32; w_gate/w_up (E, d, f) and w_down (E, f, d) in
    the model dtype; the optional ``shared`` expert and ``dense_residual``
    branch, each a :class:`SwiGLU`."""

    def __init__(self, router: torch.Tensor, w_gate: torch.Tensor,
                 w_up: torch.Tensor, w_down: torch.Tensor,
                 shared: Optional[SwiGLU] = None,
                 dense_residual: Optional[SwiGLU] = None):
        super().__init__()
        self.router = nn.Parameter(router)
        self.w_gate = nn.Parameter(w_gate)
        self.w_up = nn.Parameter(w_up)
        self.w_down = nn.Parameter(w_down)
        self.register_module("shared", shared)
        self.register_module("dense_residual", dense_residual)


def _expert_weights(E: int, d_in: int, d_out: int, dtype: torch.dtype, *,
                    generator: torch.Generator, device: torch.device,
                    experts: Optional[Tuple[int, int]] = None
                    ) -> torch.Tensor:
    """(E, d_in, d_out) of N(0, 1/d_in), drawn one expert at a time: one
    fp32 draw of the whole stack would be a temporary of E·d_in·d_out·4
    bytes (17.8 GB for one of arctic-480b's).  ``experts`` ``(lo, hi)``
    keeps only those experts' weights, (hi - lo, d_in, d_out), drawing the
    others all the same (the numbers kept are the whole stack's)."""
    lo, hi = experts or (0, E)
    w = torch.empty(hi - lo, d_in, d_out, dtype=dtype, device=device)
    if w.device.type == "meta":
        return w
    for e in range(E):
        we = init_dense(d_in, d_out, dtype, generator=generator,
                        device=device)
        if lo <= e < hi:
            w[e - lo] = we
    return w


def init_moe(cfg: ModelConfig, *, generator: torch.Generator,
             device: torch.device, dtype: Optional[torch.dtype] = None,
             experts: Optional[Tuple[int, int]] = None) -> MoE:
    """Random weights with the reference's distributions (not its
    numbers); ``experts`` ``(lo, hi)`` keeps only those experts (a rank's
    share, :func:`_expert_weights`)."""
    dt = dtype or cfg.dtype
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    kw = dict(generator=generator, device=device)
    router = init_dense(d, E, torch.float32, **kw)
    w_gate = _expert_weights(E, d, f, dt, experts=experts, **kw)
    w_up = _expert_weights(E, d, f, dt, experts=experts, **kw)
    w_down = _expert_weights(E, f, d, dt, experts=experts, **kw)
    shared = (init_swiglu(d, cfg.shared_expert_ff, dt, **kw)
              if cfg.shared_expert_ff else None)
    residual = (init_swiglu(d, cfg.dense_residual_ff, dt, **kw)
                if cfg.dense_residual_ff else None)
    return MoE(router, w_gate, w_up, w_down, shared, residual)


def _capacity(n_tokens: int, cfg: ModelConfig) -> int:
    c = int(math.ceil(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))
    return max(cfg.top_k, c)


def _top_k(probs: torch.Tensor, k: int
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last axis, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(p: MoE, xf: torch.Tensor, cfg: ModelConfig, shard=None):
    """xf (..., T, d) -> (topv, topi (..., T, k), aux (...)): the routing
    and the switch load-balance loss of each group of T tokens, in fp32.
    With ``shard``, xf is the rank's share of the tokens of every batch rank
    routed together (T each): aux is this rank's share of their loss."""
    logits = xf.float() @ p.router                          # (..., T, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(probs, cfg.top_k)
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    E = cfg.n_experts
    if shard is None:
        frac_tokens = F.one_hot(topi, E).float().sum(-2).mean(-2)  # (..., E)
        frac_probs = probs.mean(-2)
    else:
        n = xf.shape[-2] * shard.n_batch
        counts = F.one_hot(topi, E).float().sum((-3, -2))
        frac_tokens = shard.data_sum(counts) / n
        frac_probs = probs.sum(-2) / n
    aux = E * (frac_tokens * frac_probs).sum(-1) / cfg.top_k
    return topv, topi, aux


def _experts(p: MoE, h: torch.Tensor) -> torch.Tensor:
    """h (E, N, d) -> (E, N, d) through each expert's SwiGLU."""
    g = torch.bmm(h, p.w_gate)
    u = torch.bmm(h, p.w_up)
    return torch.bmm(swiglu(g, u), p.w_down)


def _group_experts(p: MoE, buf: torch.Tensor, E: int) -> torch.Tensor:
    """Each group's (E·C, d) buffer through the experts, all groups in one
    product over E: buf (G, E·C, d) -> (G, E·C, d)."""
    G, EC, d = buf.shape
    C = EC // E
    h = buf.reshape(G, E, C, d).transpose(0, 1).reshape(E, G * C, d)
    y = _experts(p, h)
    return y.reshape(E, G, C, d).transpose(0, 1).reshape(G, EC, d)


def _sorted_pairs(topv: torch.Tensor, topi: torch.Tensor, T: int, k: int):
    """Each group's (token, choice) pairs sorted by expert id, stably:
    (order, expert, token, weight), each (G, T·k)."""
    G = topi.shape[0]
    flat_e = topi.reshape(G, T * k)
    flat_w = topv.reshape(G, T * k)
    flat_t = torch.arange(T, device=topi.device).repeat_interleave(k)
    flat_t = flat_t.expand(G, T * k)
    order = torch.argsort(flat_e, dim=1, stable=True)
    return (order, flat_e.gather(1, order), flat_t.gather(1, order),
            flat_w.gather(1, order))


def _combine(contrib: torch.Tensor, order: torch.Tensor, T: int,
             k: int) -> torch.Tensor:
    """The reference's ``out.at[st].add(contrib)`` in a fixed order:
    contrib (G, T·k, d) in sorted order -> out (G, T, d), each token's k
    contributions added one at a time in their sorted order (the order of
    the reference's scatter), in contrib's dtype."""
    G, _, d = contrib.shape
    inv = torch.argsort(order, dim=1)       # each pair's sorted position
    pos = inv.reshape(G, T, k).sort(dim=-1).values.reshape(G, T * k)
    parts = contrib.gather(1, pos[..., None].expand(G, T * k, d))
    parts = parts.reshape(G, T, k, d)
    out = parts[:, :, 0]
    for j in range(1, k):
        out = out + parts[:, :, j]
    return out


def _ranks(se: torch.Tensor, E: int, T: int, k: int) -> torch.Tensor:
    """Each sorted pair's rank within its expert in its group: se (G, T·k)
    sorted expert ids -> (G, T·k)."""
    G = se.shape[0]
    if se.device.type == "meta":    # no ids to count: the counts' shape
        counts = se.new_empty((G, E))
    else:
        gi = torch.arange(G, device=se.device)[:, None]
        counts = torch.bincount((se + gi * E).reshape(-1),
                                minlength=G * E).reshape(G, E)
    starts = counts.cumsum(1) - counts
    return torch.arange(T * k, device=se.device) - starts.gather(1, se)


def _moe_sort(p: MoE, x: torch.Tensor, cfg: ModelConfig
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_moe_sort`` on each group (row) of x (G, T, d):
    -> (out (G, T, d), aux (G,))."""
    G, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)
    topv, topi, aux = _route(p, x, cfg)
    order, se, st, sw = _sorted_pairs(topv, topi, T, k)
    gi = torch.arange(G, device=x.device)[:, None]
    rank = _ranks(se, E, T, k)
    keep = rank < C
    slot = torch.where(keep, se * C + rank, E * C)          # E·C: drop row
    buf = x.new_zeros(G, E * C + 1, d)
    buf = buf.index_put((gi, slot), x[gi, st])
    y = _group_experts(p, buf[:, :E * C], E)
    picked = y[gi, torch.where(keep, slot, 0)]
    contrib = (torch.where(keep[..., None], picked, 0.0)
               * sw[..., None].to(x.dtype))
    return _combine(contrib, order, T, k), aux


def _moe_einsum(p: MoE, x: torch.Tensor, cfg: ModelConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's GShard one-hot ``_moe_einsum`` on each group (row)
    of x (G, T, d): -> (out (G, T, d), aux (G,))."""
    G, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)
    topv, topi, aux = _route(p, x, cfg)
    # position of each (t, choice) within its expert, in (t, choice)
    # order: the sort path's stable order
    flat = F.one_hot(topi, E).reshape(G, T * k, E)
    rank = flat.cumsum(1) - flat
    rank = (rank * flat).sum(-1).reshape(G, T, k)
    keep = rank < C
    disp = (F.one_hot(topi, E).to(x.dtype)[..., None]
            * F.one_hot(torch.where(keep, rank, C), C + 1)
            .to(x.dtype)[:, :, :, None, :])                 # (G,T,k,E,C+1)
    disp = disp[..., :C]
    h = torch.einsum("gtkec,gtd->gecd", disp, x)
    y = _group_experts(p, h.reshape(G, E * C, d), E).reshape(G, E, C, d)
    comb = disp * topv[..., None, None].to(x.dtype)
    return torch.einsum("gtkec,gecd->gtd", comb, y), aux


def _moe_grouped(p: MoE, x: torch.Tensor, cfg: ModelConfig, shard=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_moe_grouped``: the G·T tokens of x (G, T, d)
    routed at once (one aux; with ``shard``, this rank's share of the
    global batch's, :func:`_route`), each group dispatched into its own
    (E·C, d) buffer through an add.  -> (out (G, T, d), aux ())."""
    G, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)
    topv, topi, aux = _route(p, x.reshape(G * T, d), cfg, shard)
    order, se, st, sw = _sorted_pairs(topv.reshape(G, T, k),
                                      topi.reshape(G, T, k), T, k)
    experts = torch.arange(E, device=x.device).expand(G, E).contiguous()
    starts = torch.searchsorted(se.contiguous(), experts)
    rank = torch.arange(T * k, device=x.device) - starts.gather(1, se)
    keep = rank < C
    slot = torch.where(keep, se * C + rank, 0)     # dropped -> slot 0,
    gathered = x.gather(1, st[..., None].expand(G, T * k, d))
    vals = torch.where(keep[..., None], gathered, 0.0)   # ... zero value
    gi = torch.arange(G, device=x.device)[:, None]
    buf = x.new_zeros(G, E * C, d).index_put((gi, slot), vals,
                                             accumulate=True)
    y = _group_experts(p, buf, E)
    picked = y.gather(1, slot[..., None].expand(G, T * k, d))
    contrib = (torch.where(keep[..., None], picked, 0.0)
               * sw[..., None].to(x.dtype))
    return _combine(contrib, order, T, k), aux


def _moe_ep(p: MoE, x: torch.Tensor, cfg: ModelConfig, shard
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_moe_ep`` on this rank's groups x (G, T, d) and
    its E/ep experts: each group routed on its own (the sort path's
    routing, ranks and drops), its (E·C, d) buffer built in global expert
    order; one all-to-all over ``expert`` sends expert block q's slab to
    rank q, which runs its experts on the (ep·G, E_loc·C, d) slabs it
    receives, in source rank order; the reverse all-to-all brings the
    outputs home, slot ``e*C + r`` again.  -> (out (G, T, d), this rank's
    share of the mean of every group's aux)."""
    G, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)
    n, E_loc = shard.n_expert, p.w_gate.shape[0]
    topv, topi, aux = _route(p, x, cfg)
    order, se, st, sw = _sorted_pairs(topv, topi, T, k)
    gi = torch.arange(G, device=x.device)[:, None]
    rank = _ranks(se, E, T, k)
    keep = rank < C
    slot = torch.where(keep, se * C + rank, E * C)          # E·C: drop row
    buf = x.new_zeros(G, E * C + 1, d).index_put((gi, slot), x[gi, st])
    slabs = buf[:, :E * C].reshape(G, n, E_loc * C, d).transpose(0, 1)
    recv = shard.all_to_all(slabs.contiguous())     # (n, G, E_loc·C, d)
    y = _group_experts(p, recv.reshape(n * G, E_loc * C, d), E_loc)
    y = shard.all_to_all(y.reshape(n, G, E_loc * C, d))
    y = y.transpose(0, 1).reshape(G, E * C, d)
    picked = y[gi, torch.where(keep, slot, 0)]
    contrib = (torch.where(keep[..., None], picked, 0.0)
               * sw[..., None].to(x.dtype))
    return _combine(contrib, order, T, k), aux.mean() / shard.n_batch


def _moe_tp(p: MoE, x: torch.Tensor, cfg: ModelConfig, shard, aux: str
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_moe_shmap`` under TP: x (G, T, d), this rank's
    groups, whole on every ``model`` rank, which holds experts ``[off, off
    + E_loc)``.  Every rank routes every token alike and keeps the pairs
    routed to its experts, within capacity (the sort path's ranks); its
    partial outputs are summed over ``model`` (``shard.from_tp``).  The
    rows dispatched enter through copy-to-TP-region, and so do the combine
    weights: each reaches only this rank's experts, so their gradients are
    summed over ``model``, and the router's and x's gradients through the
    routing come out whole on every rank, the aux's counted once.  ``aux``
    "group", "local" or "global": the mean of each group's aux, the joint
    aux of the rank's tokens (``_moe_shmap``'s), or of the global batch's
    (``_moe_grouped``'s), as this rank's share."""
    G, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)
    E_loc = p.w_gate.shape[0]
    off = shard.model_rank * E_loc
    if aux == "group":
        topv, topi, a = _route(p, x, cfg)
        a = a.mean() / shard.n_batch
    else:
        topv, topi, a = _route(p, x.reshape(G * T, d), cfg,
                               shard if aux == "global" else None)
        topv, topi = topv.reshape(G, T, k), topi.reshape(G, T, k)
        a = a if aux == "global" else a / shard.n_batch
    order, se, st, sw = _sorted_pairs(shard.to_tp(topv), topi, T, k)
    gi = torch.arange(G, device=x.device)[:, None]
    rank = _ranks(se, E, T, k)
    mine = (rank < C) & (se >= off) & (se < off + E_loc)
    slot = torch.where(mine, (se - off) * C + rank, E_loc * C)
    xd = shard.to_tp(x)
    buf = xd.new_zeros(G, E_loc * C + 1, d).index_put((gi, slot), xd[gi, st])
    y = _group_experts(p, buf[:, :E_loc * C], E_loc)
    picked = y[gi, torch.where(mine, slot, 0)]
    contrib = (torch.where(mine[..., None], picked, 0.0)
               * sw[..., None].to(x.dtype))
    return shard.from_tp(_combine(contrib, order, T, k)), a


def expert_axis_usable(cfg: ModelConfig, mesh, batch: int) -> bool:
    """Can :func:`_moe_ep` run: ``mesh`` (a ``DeviceMesh`` or a mapping of
    axis name to size) has an ``"expert"`` axis of size > 1 that divides
    the expert count, and a batch of ``batch`` rows shards evenly over the
    batch axes x ``expert``."""
    if mesh is None:
        return False
    axes = (dict(mesh) if isinstance(mesh, Mapping) else
            {a: mesh.size(i) for i, a in enumerate(mesh.mesh_dim_names
                                                   or ())})
    n_ep = axes.get("expert", 1)
    if n_ep <= 1 or cfg.n_experts % n_ep:
        return False
    span = n_ep * math.prod(axes[a] for a in ("pod", "data") if a in axes)
    return batch % span == 0


def _moe_sharded(p: MoE, x: torch.Tensor, cfg: ModelConfig, dispatch: str,
                 shard) -> Tuple[torch.Tensor, torch.Tensor]:
    """The routed experts of a sharded run on the rank's rows x, as the
    reference chooses: EP whenever the gate opens (sort, grouped and
    shmap), TP where the experts split over ``model``, else the one-device
    dispatch on the rank's rows; the aux as this rank's share."""
    split = p.w_gate.shape[0] < cfg.n_experts
    if dispatch != "einsum" and expert_axis_usable(cfg, shard.mesh,
                                                   shard.rows):
        return _moe_ep(p, x, cfg, shard)
    if split and dispatch == "einsum":
        raise NotImplementedError(
            "the einsum dispatch is the one-device oracle: it does not run "
            "on experts split over ranks (use sort, grouped or shmap)")
    # shmap is the reference's _moe_shmap on a mesh with a model axis, its
    # grouped path elsewhere
    mode = {"sort": "group", "einsum": "group", "grouped": "global",
            "shmap": "local" if shard.axis == "model" else "global"}[dispatch]
    if split and shard.n_expert > 1:
        raise NotImplementedError(
            f"experts split over 'expert' run only on rows split over the "
            f"batch axes x 'expert'; a batch of {shard.rows} does not split "
            f"over {shard.n_batch} ranks")
    if split:
        return _moe_tp(p, x, cfg, shard, mode)
    if mode == "group":
        fn = _moe_sort if dispatch == "sort" else _moe_einsum
        out, aux = fn(p, x, cfg)
        return out, aux.mean() / shard.n_batch
    out, aux = _moe_grouped(p, x, cfg, shard if mode == "global" else None)
    return out, aux if mode == "global" else aux / shard.n_batch


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig, *,
            dispatch: str = "sort",
            shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss ()), each batch row a
    group.  ``cfg.moe_dispatch`` ``"grouped"`` or ``"shmap"`` overrides the
    default ``"sort"``; ``"shmap"`` runs the grouped path, as the reference
    does with no mesh.  With ``shard`` (``runtime/sharding.py::
    ShardContext``), x is the rank's rows and the routed experts run
    sharded (:func:`_moe_sharded`); the aux is the rank's share, and the
    shared expert and the dense residual branch run Megatron-style under
    TP."""
    if dispatch == "sort" and cfg.moe_dispatch in ("grouped", "shmap"):
        dispatch = cfg.moe_dispatch
    if dispatch not in ("sort", "einsum", "grouped", "shmap"):
        raise ValueError(f"unknown MoE dispatch {dispatch!r}")
    if shard is not None:
        out, aux = _moe_sharded(p, x, cfg, dispatch, shard)
    elif dispatch in ("grouped", "shmap"):
        out, aux = _moe_grouped(p, x, cfg)
    else:
        fn = _moe_sort if dispatch == "sort" else _moe_einsum
        out, aux = fn(p, x, cfg)
        aux = aux.mean()
    if p.shared is not None:
        out = out + swiglu_mlp(p.shared, x, shard)
    if p.dense_residual is not None:
        out = out + swiglu_mlp(p.dense_residual, x, shard)
    return out, aux
