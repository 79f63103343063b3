"""Plain PyTorch versions of the Hopper kernels.

They are the kernels' oracles: the CPU path of ``kernels/ops.py`` runs them,
the tests hold them against the JAX package, and ``chip_smoke.py`` holds
each kernel against them on the card.  Nothing on the main path calls them
when the tensors lie on a CUDA device.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


NEG_INF = -1e30     # the finite "no key yet" row max of the ring's state
State = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]     # (acc, m, l)


def attn_mask(B: int, S: int, T: int, device: torch.device, *,
              causal: bool, window: Optional[int],
              q_offset: Optional[torch.Tensor],
              kv_len: Optional[torch.Tensor]) -> torch.Tensor:
    """(B,S,T) bool: key ``t`` is admissible for query row ``s`` of lane
    ``b``, with the rules of :func:`flash_attention_ref`."""
    off = (torch.zeros(B, dtype=torch.int64, device=device)
           if q_offset is None else q_offset.to(torch.int64))
    qpos = off[:, None] + torch.arange(S, device=device)[None, :]  # (B,S)
    kpos = torch.arange(T, device=device)
    mask = torch.ones(B, S, T, dtype=torch.bool, device=device)
    if causal:
        mask &= kpos[None, None, :] <= qpos[:, :, None]
    if window is not None:
        mask &= kpos[None, None, :] > qpos[:, :, None] - window
    if kv_len is not None:
        mask &= kpos[None, None, :] < kv_len.to(torch.int64)[:, None, None]
    return mask


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        causal: bool = True, window: Optional[int] = None,
                        q_offset: Optional[torch.Tensor] = None,
                        kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """q (B,S,H,dh); k/v (B,T,KV,dh) grouped-query attention -> (B,S,H,dh).

    Query row ``s`` of lane ``b`` sits at absolute position
    ``q_offset[b] + s`` (``s`` when ``q_offset`` is None); key ``t`` is
    admissible when ``t < kv_len[b]`` (every key when None), ``t <= qpos``
    if ``causal`` and ``t > qpos - window`` if a window is given.  Rows with
    no admissible key are exact zeros.  Scores and softmax in fp32; the
    output has q's dtype.
    """
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, dh).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / (dh ** 0.5)
    m5 = attn_mask(B, S, T, q.device, causal=causal, window=window,
                   q_offset=q_offset, kv_len=kv_len)[:, None, None]
    scores = scores.masked_fill(~m5, float("-inf"))
    # rows with no admissible key: softmax over all -inf is NaN; they are
    # exact zeros, matching the kernel
    probs = torch.softmax(scores.masked_fill(~m5.any(-1, keepdim=True), 0.0),
                          dim=-1)
    probs = probs * m5.any(-1, keepdim=True)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, dh).to(q.dtype)


def flash_attention_lse_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, *, causal: bool = True,
                            window: Optional[int] = None,
                            q_offset: Optional[torch.Tensor] = None,
                            kv_len: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The row log-sum-exp of :func:`flash_attention_ref`'s scaled scores
    over its admissible keys (the same masks, ``q_offset`` and ``kv_len``
    included) -> (B,S,H) fp32, ``+inf`` on a row with no admissible key
    (so that ``exp(s - lse)`` is exactly 0 there).  ``v`` is not read; it
    keeps the attention signature."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    qg = q.reshape(B, S, KV, H // KV, dh).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()).mul_(dh ** -0.5)
    mask = attn_mask(B, S, T, q.device, causal=causal, window=window,
                     q_offset=q_offset, kv_len=kv_len)[:, None, None]
    lse = torch.logsumexp(s.masked_fill_(~mask, float("-inf")), dim=-1)
    lse = lse.masked_fill(~mask.any(-1), float("inf"))        # (B,KV,G,S)
    return lse.permute(0, 3, 1, 2).reshape(B, S, H)


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, lse: torch.Tensor, *,
                            causal: bool = True,
                            window: Optional[int] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """The gradients (dq, dk, dv) of ``sum(flash_attention_ref(q, k, v) *
    do)`` in the backward kernel's formulation, fp32 plain torch, cast to
    the inputs' dtypes: with ``P = exp(scale q k^T - lse)`` on admissible
    pairs (0 elsewhere), ``D = rowsum(do * o)``, ``dv = P^T do``,
    ``dS = P * (do v^T - D)``, ``dq = scale dS k``, ``dk = scale dS^T q``;
    dk and dv summed over the G query heads of each KV head.  ``o`` and
    ``lse`` (B,S,H) are the forward's output and row log-sum-exp.  The
    masks are the training path's, with no offsets or lengths:
    self-attention at S == T, causal or not, with or without a window, and
    cross-attention, S queries against T != S keys with no mask (K14's
    plain version; the kernels refuse a mask at S != T, the arithmetic
    here reads the two lengths apart whatever the mask).  Largest
    temporaries: two (B,H,S,T) fp32 tensors."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = dh ** -0.5
    qg = q.reshape(B, S, KV, G, dh).float()
    dog = do.reshape(B, S, KV, G, dh).float()
    kf, vf = k.float(), v.float()
    mask = attn_mask(B, S, T, q.device, causal=causal, window=window,
                     q_offset=None, kv_len=None)[:, None, None]

    def rows(t):                    # (B,S,H) -> (B,KV,G,S,1)
        return t.float().reshape(B, S, KV, G).permute(0, 2, 3, 1)[..., None]

    p = torch.einsum("bskgd,btkd->bkgst", qg, kf).mul_(scale)
    p = p.sub_(rows(lse)).exp_().masked_fill_(~mask, 0.0)
    delta = (dog * o.reshape(B, S, KV, G, dh).float()).sum(-1)
    ds = torch.einsum("bskgd,btkd->bkgst", dog, vf)
    ds = ds.sub_(delta.permute(0, 2, 3, 1)[..., None]).mul_(p)
    dv = torch.einsum("bkgst,bskgd->btkd", p, dog)
    del p
    dq = torch.einsum("bkgst,btkd->bskgd", ds, kf).mul_(scale)
    dk = torch.einsum("bkgst,bskgd->btkd", ds, qg).mul_(scale)
    return (dq.reshape(B, S, H, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_partial_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      delta: int, *, causal: bool = True,
                      window: Optional[int] = None) -> State:
    """One K/V panel visit of ring attention: the un-normalised
    online-softmax state of local q (B,S,H,dh) against a panel k/v
    (B,T,KV,dh) -> (acc (B,S,H,dh), m (B,S,H,1), l (B,S,H,1)), all fp32.

    ``delta = q_start - k_start`` places the q shard against the panel's
    global origin: the masks of :func:`flash_attention_ref` with
    ``q_offset = delta``, so key ``t`` is admissible for row ``s`` when
    ``t <= s + delta`` (causal) and ``t > s + delta - window``.  ``m`` is
    the row max of the scaled admissible scores, ``l = sum exp(s - m)`` and
    ``acc = sum exp(s - m) v``.  A row the panel rejects whole keeps
    ``(acc, m, l) = (0, NEG_INF, 0)``, which :func:`merge_partials` treats
    as an empty state.  Computed in place on the score tensor, so the
    largest temporary is one (B,H,S,T) fp32 tensor."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    G = H // KV
    qg = q.reshape(B, S, KV, G, dh).float()
    s = torch.einsum("bskgd,btkd->bkgst", qg, k.float()).mul_(dh ** -0.5)
    off = torch.full((B,), int(delta), dtype=torch.int64, device=q.device)
    mask = attn_mask(B, S, T, q.device, causal=causal, window=window,
                     q_offset=off, kv_len=None)[:, None, None]
    s.masked_fill_(~mask, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)                       # (B,KV,G,S,1)
    # exp(s - m), zero where masked (a rejected row has s == m == NEG_INF)
    p = s.sub_(m).exp_().masked_fill_(~mask, 0.0)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.einsum("bkgst,btkd->bskgd", p, v.float())

    def rows(t):                    # (B,KV,G,S,1) -> (B,S,H,1)
        return t.permute(0, 3, 1, 2, 4).reshape(B, S, H, 1)

    return acc.reshape(B, S, H, dh), rows(m), rows(l)


def merge_partials(state: State, part: State) -> State:
    """Log-sum-exp combine of two (acc, m, l) states (the JAX package's
    ``ring_attention.py::_merge``).  An empty state (m == NEG_INF, acc == 0,
    l == 0) merges as the identity: its coefficient is exp of a gap of
    about -1e30, an exact 0, and two empty states give exp(0) times zeros.
    Plain PyTorch on every device, as the JAX package computes it outside
    its kernel."""
    acc_a, m_a, l_a = state
    acc_b, m_b, l_b = part
    m_new = torch.maximum(m_a, m_b)
    ca = torch.exp(m_a - m_new)
    cb = torch.exp(m_b - m_new)
    return acc_a * ca + acc_b * cb, m_new, l_a * ca + l_b * cb


def finalize_partial(state: State, dtype: torch.dtype) -> torch.Tensor:
    """``acc / l`` where ``l > 0``, else 0, cast to ``dtype``: the attention
    output of a merged state."""
    acc, _, l = state
    pos = l > 0.0
    return torch.where(pos, acc / torch.where(pos, l, 1.0), 0.0).to(dtype)


def rmsnorm_ref(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-6) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * w`` over the last dim, in fp32, cast
    back to x's dtype."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def _to_heads(t: torch.Tensor, H: int) -> torch.Tensor:
    """(B,S,G,N) groups -> (B,S,H,N), each group repeated for its heads."""
    G = t.shape[2]
    if G == H:
        return t
    if G == 0 or H % G:
        raise ValueError(f"{G} groups do not divide {H} heads")
    return t.repeat_interleave(H // G, dim=2)


def ssd_scan_ref(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
                 Bm: torch.Tensor, Cm: torch.Tensor,
                 chunk: int = 64) -> torch.Tensor:
    """Chunked Mamba2 SSD scan with a zero initial state, in fp32 (the JAX
    package's ``models/ssm.py::ssd_chunked``).

    x (B,S,H,P) inputs per head; dt (B,S,H) positive step sizes; A (H,)
    negative decay rates; Bm/Cm (B,S,G,N) input/output projections in G
    groups, G dividing H (head h reads group h // (H // G)).  The groups
    are widened to the heads after the cast to fp32, so their gradients
    are summed over the heads in fp32.
    Returns y (B,S,H,P) in x's dtype.  A ragged tail is zero-padded to a
    whole chunk, which leaves the first S outputs unchanged (causal).
    float64 inputs are computed in float64: the oracle of the fp32 oracle."""
    Bsz, S, H, P = x.shape
    N = Bm.shape[-1]
    Q = min(chunk, S)
    if S % Q:
        pad = Q - S % Q
        padded = ssd_scan_ref(F.pad(x, (0, 0, 0, 0, 0, pad)),
                              F.pad(dt, (0, 0, 0, pad)), A,
                              F.pad(Bm, (0, 0, 0, 0, 0, pad)),
                              F.pad(Cm, (0, 0, 0, 0, 0, pad)), Q)
        return padded[:, :S]
    nc = S // Q
    acc = torch.float64 if x.dtype == torch.float64 else torch.float32
    xf = x.to(acc).reshape(Bsz, nc, Q, H, P)
    dtc = dt.to(acc).reshape(Bsz, nc, Q, H)
    Bc = _to_heads(Bm.to(acc), H).reshape(Bsz, nc, Q, H, N)
    Cc = _to_heads(Cm.to(acc), H).reshape(Bsz, nc, Q, H, N)

    dA = dtc * A.to(acc)                            # (B,nc,Q,H), negative
    cum = torch.cumsum(dA, dim=2)                   # inclusive
    # intra-chunk (attention-like) part; the exponent is masked, not the
    # product, so exp never sees a positive argument
    CB = torch.einsum("bnqhr,bnkhr->bnqkh", Cc, Bc)
    iq = torch.arange(Q, device=x.device)
    causal = (iq[:, None] >= iq[None, :])[None, None, :, :, None]
    delta = cum[:, :, :, None, :] - cum[:, :, None, :, :]   # (B,nc,Q,K,H)
    decay = torch.exp(torch.where(causal, delta,
                                  torch.full_like(delta, -1e30)))
    M = CB * decay * dtc[:, :, None, :, :]
    y_diag = torch.einsum("bnqkh,bnkhp->bnqhp", M, xf)

    # chunk-boundary states, then the recurrence across chunks
    last = cum[:, :, -1:, :]                                 # (B,nc,1,H)
    decay_to_end = torch.exp(last - cum)                     # (B,nc,Q,H)
    s_chunk = torch.einsum("bnkhr,bnkhp->bnhpr",
                           Bc * (decay_to_end * dtc)[..., None], xf)
    chunk_decay = torch.exp(last[:, :, 0, :])                # (B,nc,H)
    state = torch.zeros(Bsz, H, P, N, dtype=acc, device=x.device)
    before = []
    for c in range(nc):
        before.append(state)                                 # state BEFORE c
        state = state * chunk_decay[:, c, :, None, None] + s_chunk[:, c]
    s_before = torch.stack(before, dim=1)                    # (B,nc,H,P,N)

    y_off = torch.einsum("bnqhr,bnhpr->bnqhp",
                         Cc * torch.exp(cum)[..., None], s_before)
    return (y_diag + y_off).reshape(Bsz, S, H, P).to(x.dtype)
