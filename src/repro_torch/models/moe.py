"""Mixture-of-experts FFN with top-k routing (``repro/models/moe.py``
counterpart, one device).

Three dispatches, each with the reference's arithmetic:

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
Expert parallelism and tensor parallelism for MoE (the reference's
``_moe_ep`` and ``_moe_shmap``) are not ported: ``shard`` raises.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from .common import ModelConfig
from .layers import init_dense, swiglu
from .mlp import SwiGLU, init_swiglu, swiglu_mlp

_NOT_PORTED = ("expert and tensor parallelism for MoE are not ported yet "
               "(ROADMAP.md queue 1, item 4 (b), EP and TP for MoE)")


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
                    generator: torch.Generator,
                    device: torch.device) -> torch.Tensor:
    """(E, d_in, d_out) of N(0, 1/d_in), drawn one expert at a time: one
    fp32 draw of the whole stack would be a temporary of E·d_in·d_out·4
    bytes (17.8 GB for one of arctic-480b's)."""
    w = torch.empty(E, d_in, d_out, dtype=dtype, device=device)
    if w.device.type == "meta":
        return w
    for e in range(E):
        w[e] = init_dense(d_in, d_out, dtype, generator=generator,
                          device=device)
    return w


def init_moe(cfg: ModelConfig, *, generator: torch.Generator,
             device: torch.device,
             dtype: Optional[torch.dtype] = None) -> MoE:
    """Random weights with the reference's distributions (not its
    numbers)."""
    dt = dtype or cfg.dtype
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    kw = dict(generator=generator, device=device)
    router = init_dense(d, E, torch.float32, **kw)
    w_gate = _expert_weights(E, d, f, dt, **kw)
    w_up = _expert_weights(E, d, f, dt, **kw)
    w_down = _expert_weights(E, f, d, dt, **kw)
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


def _route(p: MoE, xf: torch.Tensor, cfg: ModelConfig):
    """xf (..., T, d) -> (topv, topi (..., T, k), aux (...)): the routing
    and the switch load-balance loss of each group of T tokens, in fp32."""
    logits = xf.float() @ p.router                          # (..., T, E)
    probs = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(probs, cfg.top_k)
    topv = topv / topv.sum(-1, keepdim=True).clamp_min(1e-9)
    E = cfg.n_experts
    frac_tokens = F.one_hot(topi, E).float().sum(-2).mean(-2)   # (..., E)
    frac_probs = probs.mean(-2)
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
    counts = torch.bincount((se + gi * E).reshape(-1),
                            minlength=G * E).reshape(G, E)
    starts = counts.cumsum(1) - counts
    rank = torch.arange(T * k, device=x.device) - starts.gather(1, se)
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


def _moe_grouped(p: MoE, x: torch.Tensor, cfg: ModelConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_moe_grouped``: the G·T tokens of x (G, T, d)
    routed at once (one aux), each group dispatched into its own (E·C, d)
    buffer through an add.  -> (out (G, T, d), aux ())."""
    G, T, d = x.shape
    E, k = cfg.n_experts, cfg.top_k
    C = _capacity(T, cfg)
    topv, topi, aux = _route(p, x.reshape(G * T, d), cfg)
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


def moe_ffn(p: MoE, x: torch.Tensor, cfg: ModelConfig, *,
            dispatch: str = "sort",
            shard=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) -> (out (B, S, d), aux loss ()), each batch row a
    group.  ``cfg.moe_dispatch`` ``"grouped"`` or ``"shmap"`` overrides the
    default ``"sort"``; ``"shmap"`` runs the grouped path, as the reference
    does with no mesh.  ``shard`` (a sharded run) raises
    NotImplementedError: EP and TP for MoE are not ported."""
    if shard is not None:
        raise NotImplementedError(_NOT_PORTED)
    if dispatch == "sort" and cfg.moe_dispatch in ("grouped", "shmap"):
        dispatch = cfg.moe_dispatch
    if dispatch in ("grouped", "shmap"):
        out, aux = _moe_grouped(p, x, cfg)
    elif dispatch in ("sort", "einsum"):
        fn = _moe_sort if dispatch == "sort" else _moe_einsum
        out, aux = fn(p, x, cfg)
        aux = aux.mean()
    else:
        raise ValueError(f"unknown MoE dispatch {dispatch!r}")
    if p.shared is not None:
        out = out + swiglu_mlp(p.shared, x)
    if p.dense_residual is not None:
        out = out + swiglu_mlp(p.dense_residual, x)
    return out, aux
