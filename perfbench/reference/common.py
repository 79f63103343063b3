"""What the plain references share: the matrix product in the reference's
precision, RMSNorm, the loss over row blocks, the layer-by-layer backward
and AdamW.  Plain PyTorch in fp32 with TF32 off; nothing of the program.

A family's reference module gives ``embed(w, tokens, config)``,
``layer(w, i, x, config, mm)`` (block ``i`` of the residual stream, reading
the leaves ``blocks.<i>.*`` of the dict ``w``), ``n_layers(config)``,
``head_leaf(config)`` (``"head"``, or ``"embed"`` when tied) and
``norm_eps(config)``.  :func:`loss_and_grads` runs the forward keeping
only each layer's input, the loss and the head over blocks of rows, then
each layer again under autograd in reverse order, so the largest live
activation is one layer's.

:func:`train_readings` takes the steps that decide ``correct``: each
step's loss, every leaf's norm of the first gradient as AdamW takes it
(after clipping), and every leaf's norm of its change over the steps.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List

import torch

Mm = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def mm_fp32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a, b)


_FMAX = {torch.float8_e4m3fn: 448.0, torch.float8_e5m2: 57344.0}


def fake_fp8(x: torch.Tensor, fmt: torch.dtype) -> torch.Tensor:
    """x rounded to ``fmt`` under one per-tensor scale, back in fp32."""
    amax = x.detach().abs().max().float()
    scale = torch.where(amax > 0, amax / _FMAX[fmt], torch.ones_like(amax))
    return (x / scale).to(fmt).float() * scale


class _Fp8Matmul(torch.autograd.Function):
    """The control: a product whose operands are rounded to fp8 (e4m3) and
    whose incoming gradient is rounded to fp8 (e5m2) in the backward, each
    product then summed in fp32: what fp8 training computes."""

    @staticmethod
    def forward(ctx, a, b):
        qa = fake_fp8(a, torch.float8_e4m3fn)
        qb = fake_fp8(b, torch.float8_e4m3fn)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = fake_fp8(g, torch.float8_e5m2)
        ga = torch.matmul(qg, qb.transpose(-1, -2))
        if qb.dim() == 2:
            gb = (qa.reshape(-1, qa.shape[-1]).t()
                  @ qg.reshape(-1, qg.shape[-1]))
        else:
            gb = torch.matmul(qa.transpose(-1, -2), qg)
        return ga, gb


def mm_fp8(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _Fp8Matmul.apply(a, b)


MATMULS = {"fp32": mm_fp32, "fp8": mm_fp8}


def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * w


def _head_loss(fam, config, w, x, labels, grads, mm, rows):
    """Mean cross entropy of the final norm and head over blocks of
    ``rows`` rows; adds the norm's and head's gradients to ``grads`` and
    returns (loss, dL/dx)."""
    eps = fam.norm_eps(config)
    head = fam.head_leaf(config)
    X, Y = x.reshape(-1, x.shape[-1]), labels.reshape(-1)
    n = X.shape[0]
    dX = torch.empty_like(X)
    total = torch.zeros((), dtype=torch.float64, device=x.device)
    for a in range(0, n, rows):
        xb = X[a:a + rows].detach().requires_grad_()
        fn = w["final_norm"].detach().requires_grad_()
        hw = w[head].detach().requires_grad_()
        h = rms_norm(xb, fn, eps)
        logits = mm(h, hw if head == "head" else hw.t())
        yb = Y[a:a + rows]
        lsum = (torch.logsumexp(logits, -1)
                - logits.gather(-1, yb[:, None])[:, 0]).sum()
        gx, gfn, ghw = torch.autograd.grad(lsum / n, [xb, fn, hw])
        dX[a:a + rows] = gx
        grads["final_norm"] += gfn
        grads[head] += ghw
        total += lsum.detach().double()
    return (total / n).item(), dX.view_as(x)


def loss_and_grads(fam, config: Dict[str, Any], w: Dict[str, torch.Tensor],
                   batch: Dict[str, torch.Tensor], mm: Mm, *,
                   rows: int = 1024):
    """(mean loss, {leaf: gradient}) of ``batch`` under weights ``w``."""
    tokens, labels = batch["tokens"], batch["labels"]
    grads = {n: torch.zeros_like(t) for n, t in w.items()}
    inputs = []
    with torch.no_grad():
        x = fam.embed(w, tokens, config)
        for i in range(fam.n_layers(config)):
            inputs.append(x)
            x = fam.layer(w, i, x, config, mm)
    loss, dx = _head_loss(fam, config, w, x, labels, grads, mm, rows)
    del x
    for i in reversed(range(fam.n_layers(config))):
        xi = inputs.pop().detach().requires_grad_()
        names = [n for n in w if n.startswith(f"blocks.{i}.")]
        wl = dict(w)
        wl.update({n: w[n].detach().requires_grad_() for n in names})
        y = fam.layer(wl, i, xi, config, mm)
        g = torch.autograd.grad(y, [xi] + [wl[n] for n in names], dx)
        dx = g[0]
        for n, gn in zip(names, g[1:]):
            grads[n] += gn
        del y, g, wl
    d = dx.shape[-1]
    grads["embed"].index_add_(0, tokens.reshape(-1), dx.reshape(-1, d))
    return loss, grads


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: float
    beta1: float
    beta2: float
    eps: float
    weight_decay: float
    grad_clip: float


def train_readings(fam, config: Dict[str, Any],
                   w0: Dict[str, torch.Tensor],
                   batches: List[Dict[str, torch.Tensor]], opt: AdamW,
                   precision: str = "fp32",
                   live_dtypes: bool = False) -> Dict[str, Any]:
    """AdamW from ``w0`` (any dtype, computed in fp32) over ``batches``
    (decoupled weight decay on every leaf, the gradient clipped to its
    global norm, bias-corrected moments):
    ``{"loss": [...], "grad": {leaf: norm}, "change": {leaf: norm}}``.
    With ``live_dtypes`` the forward and backward read the weights rounded
    to ``w0``'s dtypes after each update, the fp32 weights kept as a
    master copy (a witness of what bf16 live weights do, not a
    reference)."""
    mm = MATMULS[precision]
    w = {n: t.float().clone() for n, t in w0.items()}
    m = {n: torch.zeros_like(t) for n, t in w.items()}
    v = {n: torch.zeros_like(t) for n, t in w.items()}
    losses, first = [], {}
    for step, batch in enumerate(batches, start=1):
        live = ({n: t.to(w0[n].dtype).float() for n, t in w.items()}
                if live_dtypes else w)
        loss, g = loss_and_grads(fam, config, live, batch, mm)
        del live
        losses.append(loss)
        gnorm = torch.sqrt(sum(t.double().square().sum() for t in g.values()))
        clip = torch.clamp(opt.grad_clip / (gnorm + 1e-9), max=1.0).float()
        b1c, b2c = 1.0 - opt.beta1 ** step, 1.0 - opt.beta2 ** step
        with torch.no_grad():
            for n in w:
                gn = g[n] * clip
                if step == 1:
                    first[n] = gn.norm().item()
                m[n].mul_(opt.beta1).add_(gn, alpha=1.0 - opt.beta1)
                v[n].mul_(opt.beta2).addcmul_(gn, gn, value=1.0 - opt.beta2)
                upd = (m[n] / b1c) / (torch.sqrt(v[n] / b2c) + opt.eps)
                w[n].sub_(opt.lr * (upd + opt.weight_decay * w[n]))
        del g
    change = {n: (w[n] - w0[n].float()).norm().item() for n in w}
    return {"loss": losses, "grad": first, "change": change}
