"""Plain fp32 reference of the Mamba2 family, from the Mamba2 description
(arXiv:2405.21060, hf:state-spaces/mamba2-370m): pre-norm blocks, each an
input projection to [z | x B C | dt], a causal depthwise convolution with
bias and SiLU over x B C, dt = softplus(dt + dt_bias), A = -exp(A_log), the
SSD recurrence

    h_t = exp(dt_t A) h_{t-1} + dt_t x_t B_t^T,   y_t = h_t C_t + D x_t

(one group of B and C for every head), the gate y * silu(z), an RMSNorm and
the output projection, added to the residual; a final RMSNorm and the tied
head.  The recurrence is computed as the paper's chunked dual (its minimal
SSD listing): within a chunk the masked products of C and B times the
segment decays, across chunks the states passed on with the chunk decays;
the chunk length changes how it is split, not what it computes."""
from __future__ import annotations

from typing import Any, Dict

import torch
import torch.nn.functional as F

from .common import rms_norm

CHUNK = 64


def n_layers(config: Dict[str, Any]) -> int:
    return config["n_layer"]


def norm_eps(config: Dict[str, Any]) -> float:
    return float(config["rms_norm_eps"])


def head_leaf(config: Dict[str, Any]) -> str:
    return "embed" if config["tie_embeddings"] else "head"


def embed(w, tokens, config):
    return w["embed"][tokens]


def segsum(a: torch.Tensor) -> torch.Tensor:
    """(..., T) -> (..., T, T): sum of a over (j, i] below the diagonal,
    -inf above it."""
    T = a.shape[-1]
    c = torch.cumsum(a, dim=-1)
    s = c[..., :, None] - c[..., None, :]
    keep = torch.ones(T, T, dtype=torch.bool, device=a.device).tril()
    return s.masked_fill(~keep, float("-inf"))


def ssd(x, dt, A, Bm, Cm, chunk: int = CHUNK):
    """x (b,S,h,p), dt (b,S,h), A (h,), Bm/Cm (b,S,n) -> y (b,S,h,p)."""
    b, S, h, p = x.shape
    l = min(chunk, S)
    c = S // l
    X = (x * dt[..., None]).view(b, c, l, h, p)
    a = (dt * A).view(b, c, l, h).permute(0, 3, 1, 2)        # b h c l
    Bc, Cc = Bm.view(b, c, l, -1), Cm.view(b, c, l, -1)
    acum = torch.cumsum(a, dim=-1)
    decay = torch.exp(segsum(a))                              # b h c l s
    cb = torch.einsum("bcln,bcsn->bcls", Cc, Bc)
    y = torch.einsum("bcls,bhcls,bcshp->bclhp", cb, decay, X)
    to_end = torch.exp(acum[..., -1:] - acum)                 # b h c l
    states = torch.einsum("bcln,bhcl,bclhp->bchpn", Bc, to_end, X)
    states = torch.cat([torch.zeros_like(states[:, :1]), states], dim=1)
    chunk_decay = torch.exp(segsum(F.pad(acum[..., -1], (1, 0))))  # b h z c
    states = torch.einsum("bhzc,bchpn->bzhpn", chunk_decay, states)[:, :-1]
    y = y + torch.einsum("bcln,bchpn,bhcl->bclhp", Cc, states,
                         torch.exp(acum))
    return y.reshape(b, S, h, p)


def causal_conv(x: torch.Tensor, w: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """Depthwise causal convolution over time: x (B,S,C), w (K,C)."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, K - 1, 0))
    return sum(xp[:, i:i + S] * w[i] for i in range(K)) + bias


def layer(w, i, x, config, mm):
    p = f"blocks.{i}.ssm."
    B, S, d = x.shape
    N, P = config["d_state"], config["headdim"]
    di = config["expand"] * d
    H = di // P
    eps = norm_eps(config)
    h = rms_norm(x, w[f"blocks.{i}.ln1"], eps)
    z, xbc, dt = torch.split(mm(h, w[p + "in_proj"]), [di, di + 2 * N, H],
                             dim=-1)
    xbc = F.silu(causal_conv(xbc, w[p + "conv_w"], w[p + "conv_b"]))
    xs, Bm, Cm = torch.split(xbc, [di, N, N], dim=-1)
    xs = xs.reshape(B, S, H, P)
    dt = F.softplus(dt + w[p + "dt_bias"])
    y = ssd(xs, dt, -torch.exp(w[p + "A_log"]), Bm, Cm)
    y = y + w[p + "D"][:, None] * xs
    y = y.reshape(B, S, di) * F.silu(z)
    return x + mm(rms_norm(y, w[p + "norm_w"], eps), w[p + "out_proj"])
