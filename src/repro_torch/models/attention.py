"""Grouped-query attention with RoPE and optional QK-norm / QKV-bias: the
full-sequence layer (:func:`attention`, whose ``impl="ring"`` is
sequence-parallel ring attention), the one-token decode layer over a dense
ring or linear KV cache (:func:`attention_decode`), the paged-cache
layers of the serving path, and the encoder-decoder's cross-attention over
precomputed encoder K/V (:func:`cross_attention`).  On the card the inner attention runs the
flash-attention kernels (``kernels/ops.py``).

The JAX package's caches and pools are functional (``cache.at[...].set``).
Here the decode and paged functions write K/V into the per-layer caches and
pools **in place** (``index_put_``).  The paged functions return only the
attention output.  Each pool has one
row more than the page table hands out: row ``N = pool.shape[0] - 1`` is a
sink that receives the writes the JAX package drops (``mode="drop"``:
inactive lanes, padding positions, unassigned pages), so no write needs a
host-side filter.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import torch
import torch.distributed as dist
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_ref

from .common import ModelConfig
from .layers import apply_rope, init_dense, rms_norm

Pool = Dict[str, torch.Tensor]


class Attention(nn.Module):
    """wq (d, q_dim), wk/wv (d, kv_dim), wo (q_dim, d); optional biases and
    per-head QK-norm weights (dh,)."""

    def __init__(self, wq: torch.Tensor, wk: torch.Tensor, wv: torch.Tensor,
                 wo: torch.Tensor, *, bq: Optional[torch.Tensor] = None,
                 bk: Optional[torch.Tensor] = None,
                 bv: Optional[torch.Tensor] = None,
                 q_norm: Optional[torch.Tensor] = None,
                 k_norm: Optional[torch.Tensor] = None):
        super().__init__()
        for name, t in dict(wq=wq, wk=wk, wv=wv, wo=wo, bq=bq, bk=bk, bv=bv,
                            q_norm=q_norm, k_norm=k_norm).items():
            self.register_parameter(
                name, None if t is None else nn.Parameter(t))


def init_attention(cfg: ModelConfig, *, generator: torch.Generator,
                   device: torch.device, cross: bool = False) -> Attention:
    """Random projections (wq, wk, wv, wo drawn in that order); the
    config's QKV biases, except on a ``cross`` (-attention) block, and its
    QK-norm weights."""
    d, dt = cfg.d_model, cfg.dtype
    kw = dict(generator=generator, device=device)
    extra = {}
    if cfg.qkv_bias and not cross:
        extra.update(bq=torch.zeros(cfg.q_dim, dtype=dt, device=device),
                     bk=torch.zeros(cfg.kv_dim, dtype=dt, device=device),
                     bv=torch.zeros(cfg.kv_dim, dtype=dt, device=device))
    if cfg.qk_norm:
        extra.update(q_norm=torch.ones(cfg.dh, dtype=dt, device=device),
                     k_norm=torch.ones(cfg.dh, dtype=dt, device=device))
    return Attention(init_dense(d, cfg.q_dim, dt, **kw),
                     init_dense(d, cfg.kv_dim, dt, **kw),
                     init_dense(d, cfg.kv_dim, dt, **kw),
                     init_dense(cfg.q_dim, d, dt, **kw), **extra)


def _project_qkv(p: Attention, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor, shard=None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q, k, v of ``cfg``'s heads; with a sharding context ``shard``,
    ``cfg`` is its rank's heads and the replicated biases and QK-norm
    weights enter the TP region through it."""
    B, S, _ = x.shape
    q, k, v = x @ p.wq, x @ p.wk, x @ p.wv
    if p.bq is not None:
        bq, bk, bv = ((p.bq, p.bk, p.bv) if shard is None else
                      (shard.tp_local(b) for b in (p.bq, p.bk, p.bv)))
        q, k, v = q + bq, k + bk, v + bv
    q = q.reshape(B, S, cfg.n_heads, cfg.dh)
    k = k.reshape(B, S, cfg.n_kv_heads, cfg.dh)
    v = v.reshape(B, S, cfg.n_kv_heads, cfg.dh)
    if cfg.qk_norm:
        qn, kn = ((p.q_norm, p.k_norm) if shard is None else
                  (shard.to_tp(p.q_norm), shard.to_tp(p.k_norm)))
        q = rms_norm(q, qn, cfg.norm_eps)
        k = rms_norm(k, kn, cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def sdpa_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
             causal: bool, window: Optional[int] = None,
             q_offset: Union[int, torch.Tensor] = 0,
             kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain grouped-query attention with the JAX ``sdpa_ref`` signature:
    ``q_offset`` is the absolute position of q[0] (an int, or one per
    lane), ``kv_len`` (B,) masks cache positions >= it.

    Unlike the JAX function, a query row with no admissible key gives
    zeros (the flash kernel's semantics), not a uniform average over V;
    such rows occur only in padding and inactive lanes."""
    B = q.shape[0]
    off = torch.as_tensor(q_offset, device=q.device).expand(B)
    return flash_attention_ref(q, k, v, causal=causal, window=window,
                               q_offset=off, kv_len=kv_len)


def sdpa_chunked(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                 causal: bool, window: Optional[int] = None,
                 block_q: int = 512) -> torch.Tensor:
    """Plain attention with q in blocks over all of T, so the largest score
    tensor is (B, H, block_q, T) instead of (B, H, S, T) (the JAX package's
    ``sdpa_chunked``, with its block rule: ``block_q`` halved until it
    divides S).  Query ``i`` sits at position ``i``.  The JAX function is
    its pure-jnp analogue of the flash kernel for backends without Pallas;
    here it serves CPU tensors, and the card runs the kernel."""
    B, S = q.shape[:2]
    bq = min(block_q, S)
    while S % bq:
        bq //= 2
    return torch.cat([
        flash_attention_ref(q[:, i:i + bq], k, v, causal=causal,
                            window=window,
                            q_offset=torch.full((B,), i, device=q.device))
        for i in range(0, S, bq)], dim=1)


def _kernel_window(window: Optional[int], T: int) -> Optional[int]:
    """The window for the flash kernel over T keys.

    A window of at least T masks nothing that the causal mask keeps for a
    query below T, so it becomes full attention: the kernel refuses a
    window longer than its keys, while the JAX package builds its masks in
    jnp and takes any window.  The full-sequence layer's queries sit below
    T = S; the paged engine steps only such queries over its gathered view
    (a lane with no room left is stepped as inactive)."""
    return None if window is not None and window >= T else window


ATTN_IMPLS = ("ring", "flash", "chunked", "ref", "auto")


def attention(p: Attention, x: torch.Tensor, positions: torch.Tensor,
              cfg: ModelConfig, *, causal: bool = True,
              window: Optional[int] = None, impl: str = "auto",
              sp_group: Optional[dist.ProcessGroup] = None,
              shard=None) -> torch.Tensor:
    """Full-sequence (train / prefill) self-attention: x (B,S,d) ->
    (B,S,d).

    ``impl`` is one of ``ATTN_IMPLS``.  ``"auto"`` is ``"flash"`` on a CUDA
    tensor and on a ``meta`` one (the dry run's stand-in for the card); on
    a CPU tensor it is the JAX rule, ``"chunked"`` for S >= 1024 and
    ``"ref"`` below.  ``"chunked"`` and ``"ref"`` are plain versions and
    take only CPU tensors; ``"flash"`` and ``"ring"`` dispatch by device
    (``kernels/ops.py``).

    ``impl="ring"`` runs sequence-parallel ring attention over the ranks of
    ``sp_group`` (the JAX package's ``sp_axis``/``sp_size``; None is a ring
    of one rank): x and ``positions`` are this rank's slice of a sequence
    split in rank order over the group.  ``positions`` (B,S) must be the
    shard's absolute token positions, so that RoPE agrees with the
    unsharded layer.

    ``shard`` (``runtime/sharding.py::ShardContext``) runs the layer
    tensor-parallel: x enters the TP region, the rank's weights hold its
    ``n_heads / tp`` query and ``n_kv_heads / tp`` KV heads, and the
    output projection's partial sums are added over ``model``."""
    if impl not in ATTN_IMPLS:
        raise ValueError(f"impl must be one of {ATTN_IMPLS}; got {impl!r}")
    B, S, _ = x.shape
    if shard is not None:
        x, cfg = shard.to_tp(x), shard.local_cfg(cfg)
    q, k, v = _project_qkv(p, x, cfg, positions, shard)
    if impl == "auto":
        impl = ("flash" if x.is_cuda or x.is_meta else
                "chunked" if S >= 1024 else "ref")
    if impl in ("chunked", "ref") and (x.is_cuda or x.is_meta):
        raise ValueError(f"impl={impl!r} is a plain version for CPU tensors; "
                         "on the card use 'flash' or 'ring'")
    if impl == "ring":
        out = ops.ring_flash_attention(q, k, v, group=sp_group,
                                       causal=causal, window=window)
    elif impl == "flash":
        out = ops.flash_attention(q, k, v, causal=causal,
                                  window=_kernel_window(window, S))
    elif impl == "chunked":
        out = sdpa_chunked(q, k, v, causal=causal, window=window)
    else:
        out = sdpa_ref(q, k, v, causal=causal, window=window)
    out = out.reshape(B, S, cfg.q_dim) @ p.wo
    return out if shard is None else shard.from_tp(out)


def attention_decode(p: Attention, x: torch.Tensor, cache: Pool,
                     cache_index: Union[int, torch.Tensor], cfg: ModelConfig,
                     *, window: Optional[int] = None, shard=None,
                     layout=None) -> Tuple[torch.Tensor, Pool]:
    """One-token decode with a ring or linear KV cache.

    x (B,1,d).  cache["k"/"v"]: (B, C, KV, dh) with C the full context or
    the sliding window span (:func:`init_kv_cache`).  ``cache_index`` is the
    number of tokens already in context, the new token's position: an int
    or 0-d tensor shared by every lane, or (B,) when lanes sit at different
    positions (the serve loop after slot recycling).  The new token's K/V
    are written **in place** at slot ``index % C`` before the read.
    Returns the output (B,1,d) through ``wo`` and ``cache``, the same
    tensors.

    Slot ``s`` holds position ``idx - ((idx - s) % C)``; the JAX package
    admits it when that lies in [0, idx] and, with a window ``w``, above
    ``idx - w``.  Softmax over the admitted keys ignores their order, and
    each K was rotated at its own position, so the kernel reads the cache
    as it lies:

    * no window, or ``w >= C`` (every serving call: the window is at least
      the span :func:`init_kv_cache` gives): the admitted slots are the
      first ``min(idx + 1, C)``, a per-lane ``kv_len``, non-causal;
    * ``w < C`` and no lane wrapped: causal at ``q_offset = idx``;
    * ``w < C`` after a wrap (only when a caller passes a window shorter
      than the span): the admitted slots form a cyclic range, so the cache
      is gathered into position order (:func:`_ring_in_order`).  This copy
      is off the serving path.

    ``shard`` (``runtime/sharding.py::ShardContext``) with the state's
    ``layout`` (``DecodeLayout``) runs a rank's share: x, ``cache_index``
    and the cache are its lanes, the cache its slice (``layout.kv``).
    Under TP the rank projects its ``n_heads / tp`` query and
    ``n_kv_heads / tp`` KV heads and ``wo`` is row-parallel, its partial
    sums added over ``model``.

    * ``"seq"``: the rank holds slots ``[r C/m, (r+1) C/m)`` of every
      lane's ring; the new token's K/V are written only where they fall,
      which under TP needs every head of the token (q, k and v gathered
      over ``model``, a few KB).  Each rank attends its slots (non-causal,
      its local ``kv_len``) with the row log-sum-exp, the parts are merged
      (``ShardContext.merge_context``) and under TP each rank keeps its
      heads.  A window shorter than the span raises ValueError.
    * ``"heads"``: the rank's KV heads; under TP the one-device arithmetic
      on them, without TP its heads' outputs gathered before the
      replicated ``wo``.
    * None: the cache is whole on every rank."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per lane, got S={S}")
    idx = torch.as_tensor(cache_index, device=x.device).to(
        torch.int32).expand(B)
    split, lcfg = None, cfg
    if shard is not None:
        split, x, lcfg = layout.kv, shard.to_tp(x), shard.local_cfg(cfg)
    q, k, v = _project_qkv(p, x, lcfg, idx.reshape(B, 1), shard)
    if split == "seq":
        out = _decode_context_shard(q, k, v, cache, idx, layout.span, window,
                                    shard)
    elif split == "heads" and shard.tp == 1:
        r, m = shard.model_rank, shard.n_model
        h, g = cfg.n_heads // m, cfg.n_kv_heads // m
        out = shard.gather_model(_decode_attend(
            q[:, :, r * h:(r + 1) * h], k[:, :, r * g:(r + 1) * g],
            v[:, :, r * g:(r + 1) * g], cache, idx, window), 2)
    else:       # one device, TP on the rank's heads, or a whole cache
        out = _decode_attend(q, k, v, cache, idx, window)
    out = out.reshape(B, 1, -1) @ p.wo
    return (out if shard is None else shard.from_tp(out)), cache


def _decode_attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   cache: Pool, idx: torch.Tensor,
                   window: Optional[int]) -> torch.Tensor:
    """:func:`attention_decode`'s write and read of a whole ring (its
    three routes), on the heads of q, k, v and the cache."""
    B, C = cache["k"].shape[:2]
    lane = torch.arange(B, device=q.device)
    slot = (idx % C).long()
    cache["k"][lane, slot] = k[:, 0].to(cache["k"].dtype)
    cache["v"][lane, slot] = v[:, 0].to(cache["v"].dtype)
    if window is None or window >= C:
        return ops.flash_attention(q, cache["k"], cache["v"], causal=False,
                                   kv_len=(idx + 1).clamp(max=C))
    if not bool((idx >= C).any()):      # a host sync, off the serving path
        return ops.flash_attention(q, cache["k"], cache["v"], causal=True,
                                   window=window, q_offset=idx)
    k_pos, v_pos, q_offset = _ring_in_order(cache, idx)
    return ops.flash_attention(q, k_pos, v_pos, causal=True, window=window,
                               q_offset=q_offset)


def _decode_context_shard(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor, cache: Pool, idx: torch.Tensor,
                          span: int, window: Optional[int],
                          shard) -> torch.Tensor:
    """:func:`attention_decode` on a ring whose ``span`` slots split over
    ``model`` (``"seq"``): the write where the slot falls, this rank's
    part with its row log-sum-exp, the merge."""
    if window is not None and window < span:
        raise ValueError(
            f"a window of {window} is shorter than the cache's span of "
            f"{span}: after a wrap its slots form a cyclic range that one "
            "device reorders (_ring_in_order) and a context-sharded cache "
            "cannot; shard the KV heads instead "
            "(ShardPolicy(shard_cache_seq=False))")
    if shard.tp > 1:                    # every head of the new token
        h, g = q.shape[2], k.shape[2]
        qkv = shard.gather_model(torch.cat([q, k, v], 2), 0)
        q, k, v = (torch.cat(parts, 2) for parts in zip(*(
            t.split([h, g, g], 2) for t in qkv.chunk(shard.tp, 0))))
    B, cl = q.shape[0], cache["k"].shape[1]
    lo = shard.model_rank * cl
    slot = (idx % span).long()
    own = ((slot >= lo) & (slot < lo + cl))[:, None, None]
    local = (slot - lo).clamp(0, cl - 1)
    lane = torch.arange(B, device=q.device)
    for name, t in (("k", k), ("v", v)):
        c = cache[name]
        c[lane, local] = torch.where(own, t[:, 0].to(c.dtype), c[lane, local])
    kv_len = ((idx + 1).clamp(max=span) - lo).clamp(0, cl).to(torch.int32)
    out, lse = ops.flash_attention(q, cache["k"], cache["v"], causal=False,
                                   kv_len=kv_len, return_lse=True)
    out = shard.merge_context(out, lse)
    if shard.tp > 1:                    # this rank's heads for its wo rows
        h = out.shape[2] // shard.tp
        out = out[:, :, shard.model_rank * h:(shard.model_rank + 1) * h]
    return out


def _ring_in_order(cache: Pool, idx: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Each lane's ring copied into position order: row ``j`` holds
    position ``base + j`` with ``base = max(idx - C + 1, 0)`` (slot
    ``(base + j) % C``; an unwrapped lane keeps its order), and the new
    token's row ``idx - base`` as the q_offset.  A copy of the whole cache:
    only :func:`attention_decode` with a window shorter than the span after
    a wrap takes it."""
    B, C = cache["k"].shape[:2]
    base = (idx - C + 1).clamp(min=0)
    order = (base[:, None] + torch.arange(C, device=idx.device)) % C
    lane = torch.arange(B, device=idx.device)[:, None]
    return cache["k"][lane, order], cache["v"][lane, order], idx - base


def _gather_lanes(pool: Pool, page_rows: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each lane's pages as a linear (B, P*psz, KV, dh) view; unassigned
    rows gather page 0 and are masked by the caller's lengths."""
    B, P = page_rows.shape
    _, psz, KV, dh = pool["k"].shape
    rows = page_rows.clamp(min=0)
    return (pool["k"][rows].reshape(B, P * psz, KV, dh),
            pool["v"][rows].reshape(B, P * psz, KV, dh))


def attention_decode_paged(p: Attention, x: torch.Tensor, pool: Pool,
                           page_rows: torch.Tensor, lengths: torch.Tensor,
                           cfg: ModelConfig, *, window: Optional[int] = None,
                           shard=None) -> torch.Tensor:
    """One-token decode against a paged KV cache; writes the new token's
    K/V into ``pool`` in place and returns the attention output (B,1,d).

    x (B,1,d).  ``page_rows`` (B, P) int32 maps each lane's logical page to
    a pool row (-1 = unassigned); ``lengths`` (B,) is each lane's context
    length, the write position of the new token.  A negative length marks
    an inactive lane: its write goes to the sink row.

    ``shard`` (``runtime/sharding.py::ShardContext``) runs it
    head-parallel under TP: the pool holds the rank's ``n_kv_heads / tp``
    KV heads (``init_page_pool(shard=)``), every page whole, the rank
    projects and attends its ``n_heads / tp`` query heads, and ``wo`` is
    row-parallel, its partial sums added over ``model``; without TP every
    rank runs the one-device arithmetic."""
    B, S, _ = x.shape
    if S != 1:
        raise ValueError(f"decode takes one token per lane, got S={S}")
    if shard is not None:
        x, cfg = shard.to_tp(x), shard.local_cfg(cfg)
    N, psz = pool["k"].shape[0] - 1, pool["k"].shape[1]
    P = page_rows.shape[1]
    L = lengths.to(torch.int32)
    q, k, v = _project_qkv(p, x, cfg, L.clamp(min=0).reshape(B, 1), shard)
    # the new token lands at (page_rows[lane, L // psz], L % psz)
    pi = (L // psz).clamp(0, P - 1).long()
    page = page_rows.gather(1, pi[:, None])[:, 0]
    page = torch.where((page < 0) | (L < 0) | (L // psz >= P),
                       N, page).long()
    off = (L % psz).clamp(0, psz - 1).long()
    pool["k"][page, off] = k[:, 0]
    pool["v"][page, off] = v[:, 0]
    gk, gv = _gather_lanes(pool, page_rows)
    # query at position L sees keys 0..L (and the window): causal with
    # q_offset = L; an inactive lane (L < 0) sees none and gives zeros
    out = ops.flash_attention(q, gk, gv, causal=True,
                              window=_kernel_window(window, gk.shape[1]),
                              q_offset=L)
    out = out.reshape(B, 1, cfg.q_dim) @ p.wo
    return out if shard is None else shard.from_tp(out)


def attention_prefill_paged(p: Attention, x: torch.Tensor, pool: Pool,
                            page_rows: torch.Tensor, base: int,
                            prompt_len: torch.Tensor, cfg: ModelConfig, *,
                            window: Optional[int] = None,
                            shard=None) -> torch.Tensor:
    """Chunked-prefill attention that captures K/V into the page pools.

    x (B,S,d): one prompt chunk covering absolute positions
    [base, base + S) for every lane.  ``prompt_len`` (B,) clips per-lane
    writes and masks shorter prompts; padding lanes use ``prompt_len = 0``.
    Writes the chunk's K/V into ``pool`` in place *first*, then attends
    over the gathered pool view, so earlier chunks of the same prompt are
    visible.  ``shard`` as :func:`attention_decode_paged`."""
    B, S, _ = x.shape
    if shard is not None:
        x, cfg = shard.to_tp(x), shard.local_cfg(cfg)
    N, psz = pool["k"].shape[0] - 1, pool["k"].shape[1]
    P = page_rows.shape[1]
    dev = x.device
    ap = base + torch.arange(S, dtype=torch.int32, device=dev)  # abs pos
    q, k, v = _project_qkv(p, x, cfg, ap.expand(B, S), shard)
    page = page_rows[:, (ap // psz).clamp(0, P - 1).long()]     # (B,S)
    in_prompt = ap[None, :] < prompt_len[:, None]
    page = torch.where((page < 0) | ~in_prompt | (ap[None, :] // psz >= P),
                       N, page).long()
    off = (ap % psz).long().expand(B, S)
    pool["k"][page, off] = k
    pool["v"][page, off] = v
    gk, gv = _gather_lanes(pool, page_rows)
    q_offset = torch.full((B,), base, dtype=torch.int32, device=dev)
    kv_len = prompt_len.clamp(max=base + S).to(torch.int32)
    out = ops.flash_attention(q, gk, gv, causal=True,
                              window=_kernel_window(window, gk.shape[1]),
                              q_offset=q_offset, kv_len=kv_len)
    out = out.reshape(B, S, cfg.q_dim) @ p.wo
    return out if shard is None else shard.from_tp(out)


def cross_attention(p: Attention, x: torch.Tensor,
                    enc_kv: Tuple[torch.Tensor, torch.Tensor],
                    cfg: ModelConfig, *, shard=None) -> torch.Tensor:
    """Decoder cross-attention over precomputed encoder K/V
    (:func:`precompute_cross_kv`), no RoPE and no mask: x (B,S,d) ->
    (B,S,d).  On the card the S queries attend the T encoder keys through
    the flash kernel (non-causal, S != T; S = 1 in decode); on the CPU its
    plain version, which computes the reference's ``sdpa_ref``.

    ``shard`` (``runtime/sharding.py::ShardContext``) runs it
    tensor-parallel: x enters the TP region, the rank projects its
    ``n_heads / tp`` query heads over ``enc_kv`` of its ``n_kv_heads / tp``
    KV heads (:func:`precompute_cross_kv` with the same ``shard``), and
    ``wo`` is row-parallel, its partial sums added over ``model``."""
    B, S, _ = x.shape
    if shard is not None:
        x, cfg = shard.to_tp(x), shard.local_cfg(cfg)
    q = (x @ p.wq).reshape(B, S, cfg.n_heads, cfg.dh)
    k, v = enc_kv
    out = ops.flash_attention(q, k, v, causal=False)
    out = out.reshape(B, S, cfg.q_dim) @ p.wo
    return out if shard is None else shard.from_tp(out)


def precompute_cross_kv(p: Attention, enc_out: torch.Tensor,
                        cfg: ModelConfig, *, shard=None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The encoder output's K and V (B, T, KV, dh) for a decoder layer's
    cross-attention; with ``shard`` under TP the rank's ``n_kv_heads /
    tp`` heads, the encoder output (replicated over ``model``) entering
    the TP region, so its gradient is summed over ``model``."""
    B, T, _ = enc_out.shape
    if shard is not None:
        enc_out, cfg = shard.to_tp(enc_out), shard.local_cfg(cfg)
    k = (enc_out @ p.wk).reshape(B, T, cfg.n_kv_heads, cfg.dh)
    v = (enc_out @ p.wv).reshape(B, T, cfg.n_kv_heads, cfg.dh)
    return k, v


def init_kv_cache(cfg: ModelConfig, batch: int, context: int, *,
                  dtype: Optional[torch.dtype] = None,
                  device: torch.device = "cuda", shard=None) -> Pool:
    """K/V cache of one layer for :func:`attention_decode`: (batch, span,
    KV, dh) zeros in ``dtype`` (the model's by default), where the span is
    ``context``, or the config's sliding window when that is shorter.
    With ``shard`` (``runtime/sharding.py::ShardContext``), the rank's
    slice by ``shard.decode_layout``: its lanes, and its slots or KV heads
    when they split over ``model``."""
    span = (context if cfg.sliding_window is None
            else min(context, cfg.sliding_window))
    shape = [batch, span, cfg.n_kv_heads, cfg.dh]
    if shard is not None:
        lay = shard.decode_layout(batch, span)
        shape[0] = lay.lanes[1] - lay.lanes[0]
        if lay.kv is not None:
            shape[1 if lay.kv == "seq" else 2] //= shard.n_model
    dev = resolve_device(device)
    dt = dtype or cfg.dtype
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev)}


def init_page_pool(cfg: ModelConfig, n_pages: int, page_size: int, *,
                   device: torch.device, shard=None) -> Pool:
    """K/V page pool for one layer: (n_pages + 1, page_size, KV, dh) in the
    model's dtype; the last row is the sink for dropped writes (see the
    module docstring).  With ``shard`` under TP, the rank's ``KV / tp``
    heads (``runtime/sharding.py::paged_state_specs``)."""
    kv = (cfg.n_kv_heads if shard is None
          else shard.local_cfg(cfg).n_kv_heads)
    shape = (n_pages + 1, page_size, kv, cfg.dh)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}
