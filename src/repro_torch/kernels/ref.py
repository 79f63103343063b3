"""Plain PyTorch versions of the Hopper kernels.

They are the kernels' oracles: the CPU path of ``kernels/ops.py`` runs them,
the tests hold them against the JAX package, and ``chip_smoke.py`` holds
each kernel against them on the card.  Nothing on the main path calls them
when the tensors lie on a CUDA device.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


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
    dev = q.device
    qg = q.reshape(B, S, KV, G, dh).float()
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k.float()) / (dh ** 0.5)
    off = (torch.zeros(B, dtype=torch.int64, device=dev) if q_offset is None
           else q_offset.to(torch.int64))
    qpos = off[:, None] + torch.arange(S, device=dev)[None, :]     # (B,S)
    kpos = torch.arange(T, device=dev)
    mask = torch.ones(B, S, T, dtype=torch.bool, device=dev)
    if causal:
        mask &= kpos[None, None, :] <= qpos[:, :, None]
    if window is not None:
        mask &= kpos[None, None, :] > qpos[:, :, None] - window
    if kv_len is not None:
        mask &= kpos[None, None, :] < kv_len.to(torch.int64)[:, None, None]
    m5 = mask[:, None, None]                                       # (B,1,1,S,T)
    scores = scores.masked_fill(~m5, float("-inf"))
    # rows with no admissible key: softmax over all -inf is NaN; they are
    # exact zeros, matching the kernel
    probs = torch.softmax(scores.masked_fill(~m5.any(-1, keepdim=True), 0.0),
                          dim=-1)
    probs = probs * m5.any(-1, keepdim=True)
    out = torch.einsum("bkgst,btkd->bskgd", probs, v.float())
    return out.reshape(B, S, H, dh).to(q.dtype)


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
