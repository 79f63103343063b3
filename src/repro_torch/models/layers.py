"""Primitive layers: initializers, RMSNorm, LayerNorm, rotary embeddings,
SwiGLU, GELU, the cross-entropy loss."""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


def randn(*shape: int, scale: float, dtype: torch.dtype,
          generator: torch.Generator, device: torch.device) -> torch.Tensor:
    """N(0, scale^2) of ``shape`` in ``dtype``, drawn in fp32 from
    ``generator``, scaled in place (the draw's peak is one fp32 copy of
    the leaf beside its result: 5 GB for qwen2-72b's table).  On the
    ``meta`` device only the shape: a draw or an arithmetic op there runs
    PyTorch's Python references, whose first call imports
    ``torch._dynamo`` (seconds of every sharded rank's start, where
    ``abstract_params`` builds the model on meta)."""
    if torch.device(device).type == "meta":
        return torch.empty(*shape, dtype=dtype, device="meta")
    w = torch.randn(*shape, generator=generator, device=device,
                    dtype=torch.float32)
    return w.mul_(scale).to(dtype)


def init_dense(d_in: int, d_out: int, dtype: torch.dtype = torch.bfloat16, *,
               generator: torch.Generator, device: torch.device,
               scale: Optional[float] = None) -> torch.Tensor:
    """(d_in, d_out) weight, applied as ``x @ w`` (the JAX layout)."""
    s = scale if scale is not None else d_in ** -0.5
    return randn(d_in, d_out, scale=s, dtype=dtype, generator=generator,
                 device=device)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """Through the RMSNorm kernel on a CUDA tensor, its plain version on a
    CPU tensor (``kernels/ops.py``)."""
    return ops.rmsnorm(x, weight, eps)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm over the last axis in fp32 with the population variance,
    returned in x's dtype (the reference's ``layer_norm``).  A plain
    PyTorch op, as the reference's is jnp: no TPU kernel computes it."""
    y = F.layer_norm(x.float(), x.shape[-1:], weight.float(), bias.float(),
                     eps)
    return y.to(x.dtype)


def rope_freqs(dh: int, theta: float, device: torch.device) -> torch.Tensor:
    exps = torch.arange(0, dh, 2, dtype=torch.float32, device=device) / dh
    return 1.0 / (theta ** exps)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, dh); positions: (..., seq) int.  Split-halves
    rotation in fp32, cast back to x's dtype."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)          # (dh/2,)
    ang = positions[..., :, None].float() * freqs              # (..., seq, dh/2)
    cos = torch.cos(ang)[..., :, None, :]                      # (..., seq, 1, dh/2)
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    return F.silu(gate.float()).to(gate.dtype) * up


def gelu(x: torch.Tensor) -> torch.Tensor:
    """The tanh approximation, as the reference's
    ``jax.nn.gelu(approximate=True)``; a plain op."""
    return F.gelu(x, approximate="tanh")


def cross_entropy_loss(logits: torch.Tensor, labels: torch.Tensor,
                       ignore_id: int = -100, *,
                       shard=None) -> torch.Tensor:
    """Mean token cross entropy in fp32 (float64 logits in float64) over
    the labels that are not ``ignore_id``; 0 when every label is ignored.
    logits (..., V),
    labels (...).  With a sharding context ``shard``
    (``runtime/sharding.py``): this rank's share of the global batch's
    mean, the logits its vocabulary columns under TP."""
    if shard is not None:
        return shard.cross_entropy(logits, labels, ignore_id)
    lf = logits.to(torch.promote_types(logits.dtype, torch.float32))
    logz = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels.long().clamp_min(0)[..., None])[..., 0]
    mask = (labels != ignore_id).float()
    return ((logz - gold) * mask).sum() / mask.sum().clamp_min(1.0)
