"""Mamba2 block via SSD (state-space duality, arXiv:2405.21060): the
full-sequence block that training and prefill run, and the one-token
decode step that serving runs.

The sequence transform is the chunked SSD scan (``kernels/ops.py``): the
CUDA kernels on a CUDA tensor, ``kernels/ref.py::ssd_scan_ref`` on a CPU
tensor.  The decode update (:func:`ssd_step`) is O(1) in the sequence and
plain PyTorch on both devices, as it is plain ``jnp`` in the JAX package;
:func:`ssm_block_decode` writes the layer's state (:func:`init_ssm_state`)
in place.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.device import resolve_device
from repro_torch.kernels import ops

from .common import ModelConfig
from .layers import init_dense, randn, rms_norm

SSMState = Dict[str, torch.Tensor]


class SSM(nn.Module):
    """Weights in the JAX layout: in_proj (d, 2*di + 2*N + H), conv_w
    (K, di + 2*N), conv_b (di + 2*N,), A_log/D/dt_bias (H,) in fp32,
    norm_w (di,), out_proj (di, d)."""

    def __init__(self, in_proj: torch.Tensor, conv_w: torch.Tensor,
                 conv_b: torch.Tensor, A_log: torch.Tensor, D: torch.Tensor,
                 dt_bias: torch.Tensor, norm_w: torch.Tensor,
                 out_proj: torch.Tensor):
        super().__init__()
        for name, t in dict(in_proj=in_proj, conv_w=conv_w, conv_b=conv_b,
                            A_log=A_log, D=D, dt_bias=dt_bias, norm_w=norm_w,
                            out_proj=out_proj).items():
            self.register_parameter(name, nn.Parameter(t))


def init_ssm(cfg: ModelConfig, *, generator: torch.Generator,
             device: torch.device) -> SSM:
    """The JAX package's distributions (not its numbers): one group of B/C
    shared by every head."""
    dt = cfg.dtype
    d, di = cfg.d_model, cfg.d_inner
    H, N = cfg.ssm_heads, cfg.ssm_state
    conv_dim = di + 2 * N
    kw = dict(generator=generator, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    conv_w = randn(cfg.ssm_conv, conv_dim, scale=1.0, dtype=torch.float32,
                   generator=generator, device=device)
    if torch.device(device).type == "meta":     # shapes only (layers.randn)
        conv_w, A_log = conv_w.to(dt), torch.empty(H, **f32)
    else:
        conv_w = (conv_w / math.sqrt(cfg.ssm_conv)).to(dt)
        A_log = torch.log(torch.linspace(1.0, 16.0, H, **f32))
    return SSM(
        in_proj=init_dense(d, 2 * di + 2 * N + H, dt, **kw),
        conv_w=conv_w,
        conv_b=torch.zeros(conv_dim, dtype=dt, device=device),
        A_log=A_log,
        D=torch.ones(H, **f32),
        dt_bias=torch.zeros(H, **f32),
        norm_w=torch.ones(di, dtype=dt, device=device),
        out_proj=init_dense(di, d, dt, **kw))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 b: torch.Tensor) -> torch.Tensor:
    """Depthwise causal conv then SiLU, in fp32.  x (B,S,C), w (K,C).

    Tap i reads x shifted by K-1-i.  The taps are slices of one padded fp32
    copy of x, so autograd keeps that copy once rather than once per tap."""
    K, S = w.shape[0], x.shape[1]
    xp = F.pad(x.float(), (0, 0, K - 1, 0))
    wf = w.float()
    out = xp[:, :S] * wf[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * wf[i]
    return F.silu(out + b.float()).to(x.dtype)


def ssm_tp_columns(cfg: ModelConfig, tp: int,
                   rank: int) -> List[Tuple[int, int]]:
    """The ``in_proj`` columns TP rank ``rank`` of ``tp`` computes with, as
    [start, stop) ranges of the packed ``[z (di) | x (di) | B (N) | C (N) |
    dt (H)]``: its heads' z, x and dt columns and all of B and C (one group
    that every head reads)."""
    di, N, H = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    a, b = rank * di // tp, (rank + 1) * di // tp
    dt0 = 2 * di + 2 * N
    return [(a, b), (di + a, di + b), (2 * di, dt0),
            (dt0 + rank * H // tp, dt0 + (rank + 1) * H // tp)]


def ssm_tp_conv_channels(cfg: ModelConfig, tp: int,
                         rank: int) -> List[Tuple[int, int]]:
    """The causal conv's channels (``[x (di) | B (N) | C (N)]``) of TP rank
    ``rank`` of ``tp``: its heads' x channels and all of B and C."""
    di, N = cfg.d_inner, cfg.ssm_state
    a, b = rank * di // tp, (rank + 1) * di // tp
    return [(a, b), (di, di + 2 * N)]


def _columns(t: torch.Tensor, ranges: List[Tuple[int, int]]) -> torch.Tensor:
    return torch.cat([t[..., a:b] for a, b in ranges], dim=-1)


def ssm_block(p: SSM, x: torch.Tensor, cfg: ModelConfig,
              shard=None) -> torch.Tensor:
    """Full-sequence Mamba2 block. x (B,S,d) -> (B,S,d).

    Bm/Cm go to the scan as one group for all heads, (B,S,1,N) views of
    the projection, never as copies.

    ``shard`` (``runtime/sharding.py::ShardContext``) under TP runs the
    block on the rank's ``H / tp`` heads: ``in_proj``, stored as the
    contiguous column shard of the rule table, is gathered over ``model``
    and cut to :func:`ssm_tp_columns` (a model placed for serving holds
    those columns already); the replicated conv weights to
    :func:`ssm_tp_conv_channels` and ``dt_bias``, ``A_log`` and ``D`` to
    the rank's heads, their gradients summed over ``model``; the gated
    rows are gathered over ``model`` so that the norm runs on whole
    ``d_inner`` rows, forward and backward, alike on every rank (its
    weight's gradient is whole on each), then cut to the rank's columns
    for the row-parallel ``out_proj``, whose partial sums are added over
    ``model``."""
    Bsz, S, _ = x.shape
    N, P = cfg.ssm_state, cfg.ssm_head_dim
    w, conv_w, conv_b, norm_w = p.in_proj, p.conv_w, p.conv_b, p.norm_w
    dt_bias, A_log, D = p.dt_bias, p.A_log, p.D
    tp = 1 if shard is None else shard.tp
    if tp > 1:
        r = shard.model_rank
        x = shard.to_tp(x)
        cols = ssm_tp_columns(cfg, tp, r)
        if w.shape[-1] != sum(b - a for a, b in cols):  # not a serving one
            if w.shape[-1] != 2 * cfg.d_inner + 2 * N + cfg.ssm_heads:
                w = shard.gather_tp(w)
            w = _columns(w, cols)
        conv_w, conv_b = (_columns(shard.to_tp(t), ssm_tp_conv_channels(
            cfg, tp, r)) for t in (conv_w, conv_b))
        dt_bias, A_log, D = (shard.tp_local(t) for t in (dt_bias, A_log, D))
    H = A_log.shape[0]
    di = H * P
    z, xBC, dt = torch.split(x @ w, [di, di + 2 * N, H], dim=-1)
    xBC = _causal_conv(xBC, conv_w, conv_b)
    xs, Bm, Cm = torch.split(xBC, [di, N, N], dim=-1)
    xs = xs.reshape(Bsz, S, H, P)
    Bm, Cm = Bm[:, :, None, :], Cm[:, :, None, :]
    dtp = F.softplus(dt.float() + dt_bias)
    A = -torch.exp(A_log)
    y = ops.ssd_scan(xs, dtp, A, Bm, Cm, cfg.ssm_chunk)
    y = y + (D.float()[:, None] * xs.float()).to(y.dtype)
    y = y.reshape(Bsz, S, di)
    y = y * F.silu(z.float()).to(y.dtype)
    if tp == 1:
        return rms_norm(y, norm_w, cfg.norm_eps) @ p.out_proj
    y = rms_norm(shard.gather_columns(y), norm_w, cfg.norm_eps)
    return shard.from_tp(shard.keep_columns(y) @ p.out_proj)


def init_ssm_state(cfg: ModelConfig, batch: int, *,
                   dtype: torch.dtype = torch.float32,
                   device: torch.device = "cuda", shard=None) -> SSMState:
    """One layer's decode state, zeros in ``dtype`` (fp32 by default, as in
    the JAX package): ``"ssm"`` (B, H, P, N) and ``"conv"`` (B, K-1,
    di + 2N), the last K-1 inputs of the causal conv.

    With ``shard`` (``runtime/sharding.py::ShardContext``), the rank's
    share by ``shard.decode_layout``: its lanes, and its ``H / m`` heads
    when they split over ``model``.  Under TP the conv history holds the
    rank's x channels and all of B and C
    (:func:`ssm_tp_conv_channels`), the channels it convolves; the
    reference keeps every channel on every ``model`` rank."""
    H, P, N = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * N
    if shard is not None:
        lay = shard.decode_layout(batch, 1)
        batch = lay.lanes[1] - lay.lanes[0]
        if lay.ssm_heads:
            H //= shard.n_model
        if shard.tp > 1:
            conv_dim = cfg.d_inner // shard.tp + 2 * N
    device = resolve_device(device)
    return {
        "ssm": torch.zeros(batch, H, P, N, dtype=dtype, device=device),
        "conv": torch.zeros(batch, cfg.ssm_conv - 1, conv_dim, dtype=dtype,
                            device=device),
    }


def ssd_step(state: torch.Tensor, x: torch.Tensor, dt: torch.Tensor,
             A: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Single-token SSD update, written into ``state`` in place.

    state (B,H,P,N); x (B,H,P); dt (B,H); Bm/Cm (B,H,N), or (B,1,N) for one
    group broadcast over the heads.  Returns (state, y (B,H,P) in x's
    dtype): ``state * exp(dt A) + (x dt) B^T``, then ``y = state C``."""
    dtf = dt.float()
    dA = torch.exp(dtf * A.float())                           # (B,H)
    xdt = x.float() * dtf[..., None]                          # (B,H,P)
    state.mul_(dA[:, :, None, None]).addcmul_(
        xdt[..., None], Bm.float()[:, :, None, :])
    y = (state @ Cm.float()[..., None])[..., 0]               # (B,H,P)
    return state, y.to(x.dtype)


def ssm_block_decode(p: SSM, x: torch.Tensor, state: SSMState,
                     cfg: ModelConfig, shard=None
                     ) -> Tuple[torch.Tensor, SSMState]:
    """One-token Mamba2 step. x (B,1,d) -> (B,1,d).

    ``state["conv"]`` holds the previous K-1 conv inputs: the new input is
    appended in the state's dtype, the conv reads all K, and the history
    shifts by one.  Both entries of ``state`` are written in place; the
    same dict is returned.

    ``shard`` (``runtime/sharding.py::ShardContext``) steps a rank's share
    (``init_ssm_state(shard=)``).  Under TP: the rank's ``H / tp`` heads
    through its ``in_proj`` columns (:func:`ssm_tp_columns`, taken once
    when a serving model is placed; a training shard is gathered and cut
    as :func:`ssm_block` does), its conv channels, the gated norm on whole
    rows gathered over ``model``, and the row-parallel ``out_proj``.
    Without TP on a state whose heads split over ``model``: the whole
    projection and conv on every rank, the SSD update on the rank's
    heads, their outputs gathered before the gated norm."""
    Bsz = x.shape[0]
    di, H, N, P = cfg.d_inner, cfg.ssm_heads, cfg.ssm_state, cfg.ssm_head_dim
    w, conv_w, conv_b = p.in_proj, p.conv_w, p.conv_b
    dt_bias, A_log, D = p.dt_bias, p.A_log, p.D
    tp = 1 if shard is None else shard.tp
    heads = None            # the rank's heads of a whole projection
    if tp > 1:
        r = shard.model_rank
        x = shard.to_tp(x)
        cols = ssm_tp_columns(cfg, tp, r)
        if w.shape[-1] != sum(b - a for a, b in cols):
            if w.shape[-1] != 2 * di + 2 * N + H:
                w = shard.gather_tp(w)
            w = _columns(w, cols)
        conv_w, conv_b = (_columns(shard.to_tp(t), ssm_tp_conv_channels(
            cfg, tp, r)) for t in (conv_w, conv_b))
        dt_bias, A_log, D = (shard.tp_local(t) for t in (dt_bias, A_log, D))
    elif shard is not None and state["ssm"].shape[1] < H:
        h = state["ssm"].shape[1]
        heads = slice(shard.model_rank * h, (shard.model_rank + 1) * h)
    Hl = A_log.shape[0]
    dil = Hl * P
    z, xBC, dt = torch.split(x[:, 0] @ w, [dil, dil + 2 * N, Hl], dim=-1)
    conv = state["conv"]
    hist = torch.cat([conv, xBC[:, None].to(conv.dtype)], dim=1)   # (B,K,C)
    conv_out = torch.einsum("bkc,kc->bc", hist.float(), conv_w.float())
    xBC = F.silu(conv_out + conv_b.float()).to(x.dtype)
    conv.copy_(hist[:, 1:])
    xs, Bm, Cm = torch.split(xBC, [dil, N, N], dim=-1)
    xs = xs.reshape(Bsz, Hl, P)
    dtp = F.softplus(dt.float() + dt_bias)
    A = -torch.exp(A_log)
    if heads is not None:
        xs, dtp, A, D = xs[:, heads], dtp[:, heads], A[heads], D[heads]
    _, y = ssd_step(state["ssm"], xs, dtp, A, Bm[:, None, :], Cm[:, None, :])
    y = y + (D.float()[:, None] * xs.float()).to(y.dtype)
    y = y.reshape(Bsz, 1, -1)
    if heads is not None:
        y = shard.gather_model(y, 2)
    y = y * F.silu(z.float()).to(y.dtype)[:, None, :]
    if tp == 1:
        return rms_norm(y, p.norm_w, cfg.norm_eps) @ p.out_proj, state
    y = rms_norm(shard.gather_columns(y), p.norm_w, cfg.norm_eps)
    return shard.from_tp(shard.keep_columns(y) @ p.out_proj), state
