"""AdamW with mixed-precision model states (``repro/optim/adamw.py``).

The same update as the JAX package, not ``torch.optim.AdamW``: the gradients
are clipped to a global norm before the moments, weight decay applies to
every leaf (norms, ``A_log``, ``D`` and ``dt_bias`` included), and the
update is taken on an fp32 master copy that the live (bf16) parameters are
cast from.  The moments are fp32, or bf16 with ``state_dtype="bf16"``; the
step uses the fp32 moments before they are stored.

The JAX update is functional; this one writes the new values into the
parameters and the state in place, which keeps one copy of each on the
card.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    # moment precision: "fp32" (16 B/param with bf16 params and grads) or
    # "bf16" (moments in bf16, master still fp32)
    state_dtype: str = "fp32"


def adamw_init(params: Sequence[torch.Tensor],
               cfg: AdamWConfig = None) -> Dict[str, Any]:
    """State for ``params`` (a sequence of tensors, in a fixed order)."""
    mdt = (torch.bfloat16 if (cfg and cfg.state_dtype == "bf16")
           else torch.float32)
    with torch.no_grad():
        return {
            "step": 0,
            "master": [p.detach().float().clone() for p in params],
            "m": [torch.zeros(p.shape, dtype=mdt, device=p.device)
                  for p in params],
            "v": [torch.zeros(p.shape, dtype=mdt, device=p.device)
                  for p in params],
        }


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(g.float().square().sum() for g in tensors))


@torch.no_grad()
def adamw_update(params: Sequence[torch.Tensor],
                 grads: Sequence[torch.Tensor], state: Dict[str, Any],
                 cfg: AdamWConfig,
                 lr_scale: float = 1.0, *,
                 grad_norm: Optional[torch.Tensor] = None
                 ) -> Dict[str, torch.Tensor]:
    """One step: updates ``params`` and ``state`` in place and returns
    ``{"grad_norm", "lr"}``.

    The gradients are clipped to their global norm, which is computed from
    ``grads`` unless ``grad_norm`` gives it: a pipeline stage holds only
    its own leaves, and passes the norm over every stage
    (``runtime/pipeline.py::pipeline_grad_norm``), as the JAX update sees
    the whole split tree."""
    state["step"] += 1
    step = torch.tensor(float(state["step"]), dtype=torch.float32)
    gnorm = global_norm(grads) if grad_norm is None else grad_norm
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    lr = cfg.lr * lr_scale
    b1c = float(1.0 - torch.tensor(cfg.beta1, dtype=torch.float32) ** step)
    b2c = float(1.0 - torch.tensor(cfg.beta2, dtype=torch.float32) ** step)
    for p, g, master, m, v in zip(params, grads, state["master"], state["m"],
                                  state["v"]):
        g = g.float() * clip
        m32 = cfg.beta1 * m.float() + (1.0 - cfg.beta1) * g
        v32 = cfg.beta2 * v.float() + (1.0 - cfg.beta2) * g.square()
        upd = (m32 / b1c) / (torch.sqrt(v32 / b2c) + cfg.eps)
        master.sub_(lr * (upd + cfg.weight_decay * master))
        m.copy_(m32)
        v.copy_(v32)
        p.copy_(master)
    return {"grad_norm": gnorm,
            "lr": torch.tensor(lr, dtype=torch.float32, device=gnorm.device)}
