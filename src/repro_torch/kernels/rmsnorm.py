"""RMSNorm on Hopper: Triton kernels for both directions, their wrappers
and the autograd Function around them.

Replaces the TPU kernel ``repro/kernels/rmsnorm.py::rmsnorm``
(``_rmsnorm_kernel``): ``y = x * rsqrt(mean(x^2) + eps) * w`` over the last
dim with fp32 accumulation, cast back to x's dtype, over rows = the product
of the leading dims.

What bounds it on the H100: memory.  It reads each element once and writes
it once and does a handful of operations per element, far below the card's
ratio of operations to bytes.  So the design moves each byte once,
coalesced: one program per block of rows, the row padded to the next power
of two (``BLOCK_D``, masked: 2560 -> 4096 for the hidden norm, 128 for the
per-head QK-norm), the sum of squares in fp32 with ``tl.sum``, and as many
rows per program as keep a block near 4096 elements.  No shared-memory
staging and no tensor cores are needed.

The backward has no TPU counterpart (the JAX package differentiates the
plain version): ``dx = rstd * (w*dy - xhat * mean(xhat*w*dy))`` and
``dw = sum over rows of dy*xhat``, in fp32, with ``xhat = x*rstd`` and rstd
recomputed from x.  It is bound by memory too (x and dy read once, dx
written once).  Each of at most ``_BWD_PROGRAMS`` programs walks a
contiguous range of rows one row at a time, keeping its share of dw in
fp32 registers, and writes it as one row of an fp32 partials buffer; a
second kernel sums the partials over the programs, column block by column
block, in a fixed order, so dw is the same on every run.

:func:`rmsnorm_cuda` and :func:`rmsnorm_bwd_cuda` only launch kernels;
``kernels/ops.py`` routes CUDA tensors through :class:`RMSNorm` and CPU
tensors to ``kernels/ref.py::rmsnorm_ref``.  ``triton`` is imported when a
kernel is first launched, never when this module is imported.
"""
import functools

import torch

_BLOCK_ELEMS = 4096
_BWD_PROGRAMS = 512


@functools.lru_cache(maxsize=None)
def _kernel():
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_fwd(x_ptr, w_ptr, y_ptr, n_rows, d, eps,
                    BLOCK_ROWS: tl.constexpr, BLOCK_D: tl.constexpr):
        rows = tl.program_id(0) * BLOCK_ROWS + tl.arange(0, BLOCK_ROWS)
        cols = tl.arange(0, BLOCK_D)
        mask = (rows[:, None] < n_rows) & (cols[None, :] < d)
        offs = rows[:, None].to(tl.int64) * d + cols[None, :]
        x = tl.load(x_ptr + offs, mask=mask, other=0.0).to(tl.float32)
        w = tl.load(w_ptr + cols, mask=cols < d, other=0.0).to(tl.float32)
        var = tl.sum(x * x, axis=1) / d
        y = x * tl.rsqrt(var + eps)[:, None] * w[None, :]
        tl.store(y_ptr + offs, y.to(y_ptr.dtype.element_ty), mask=mask)

    return rmsnorm_fwd


def rmsnorm_cuda(x: torch.Tensor, w: torch.Tensor,
                 eps: float = 1e-6) -> torch.Tensor:
    """Launch the Triton kernel: x (..., d), w (d,) on one CUDA device.

    Raises for CPU tensors or mismatched shapes; never computes on another
    path."""
    d = x.shape[-1]
    if not (x.is_cuda and w.device == x.device):
        raise ValueError("rmsnorm_cuda needs x and w on one CUDA device; got "
                         f"{x.device}, {w.device}")
    if w.shape != (d,):
        raise ValueError(f"weight shape {tuple(w.shape)} != ({d},)")
    x2 = x.reshape(-1, d).contiguous()
    y = torch.empty_like(x2)
    n_rows = x2.shape[0]
    if n_rows:
        block_d = 1 << (d - 1).bit_length()        # next power of two
        block_rows = max(1, _BLOCK_ELEMS // block_d)
        with torch.cuda.device(x.device):
            _kernel()[(-(-n_rows // block_rows),)](
                x2, w.contiguous(), y, n_rows, d, eps,
                BLOCK_ROWS=block_rows, BLOCK_D=block_d,
                num_warps=4 if block_d <= 1024 else 8)
        rmsnorm_cuda.launches += 1
    return y.reshape(x.shape)


rmsnorm_cuda.launches = 0


@functools.lru_cache(maxsize=None)
def _bwd_kernels():
    import triton
    import triton.language as tl

    @triton.jit
    def rmsnorm_bwd(x_ptr, w_ptr, dy_ptr, dx_ptr, dw_part_ptr, n_rows, d,
                    eps, rows_per_prog, BLOCK_D: tl.constexpr):
        pid = tl.program_id(0)
        cols = tl.arange(0, BLOCK_D)
        cmask = cols < d
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0).to(tl.float32)
        dw = tl.zeros([BLOCK_D], dtype=tl.float32)
        row0 = pid * rows_per_prog
        for r in range(row0, tl.minimum(row0 + rows_per_prog, n_rows)):
            offs = r.to(tl.int64) * d + cols
            x = tl.load(x_ptr + offs, mask=cmask, other=0.0).to(tl.float32)
            dy = tl.load(dy_ptr + offs, mask=cmask, other=0.0).to(tl.float32)
            rstd = tl.rsqrt(tl.sum(x * x, axis=0) / d + eps)
            xhat = x * rstd
            wdy = w * dy
            c = tl.sum(xhat * wdy, axis=0) / d
            dx = (wdy - xhat * c) * rstd
            tl.store(dx_ptr + offs, dx.to(dx_ptr.dtype.element_ty),
                     mask=cmask)
            dw += dy * xhat
        tl.store(dw_part_ptr + pid * d + cols, dw, mask=cmask)

    @triton.jit
    def column_sum(part_ptr, out_ptr, n_parts, d, BLOCK_P: tl.constexpr,
                   BLOCK_C: tl.constexpr):
        cols = tl.program_id(0) * BLOCK_C + tl.arange(0, BLOCK_C)
        acc = tl.zeros([BLOCK_C], dtype=tl.float32)
        for p0 in range(0, n_parts, BLOCK_P):
            rows = p0 + tl.arange(0, BLOCK_P)
            mask = (rows[:, None] < n_parts) & (cols[None, :] < d)
            acc += tl.sum(tl.load(part_ptr + rows[:, None] * d
                                  + cols[None, :], mask=mask, other=0.0),
                          axis=0)
        tl.store(out_ptr + cols, acc.to(out_ptr.dtype.element_ty),
                 mask=cols < d)

    return rmsnorm_bwd, column_sum


def rmsnorm_bwd_cuda(dy: torch.Tensor, x: torch.Tensor, w: torch.Tensor,
                     eps: float = 1e-6):
    """Launch the backward kernels: the gradients (dx, dw) of
    ``sum(rmsnorm(x, w) * dy)``, dx in x's dtype and dw in w's.  Raises for
    CPU tensors or mismatched shapes."""
    d = x.shape[-1]
    if not (x.is_cuda and w.device == x.device and dy.device == x.device):
        raise ValueError("rmsnorm_bwd_cuda needs dy, x and w on one CUDA "
                         f"device; got {dy.device}, {x.device}, {w.device}")
    if w.shape != (d,) or dy.shape != x.shape:
        raise ValueError(f"shapes dy={tuple(dy.shape)} x={tuple(x.shape)} "
                         f"w={tuple(w.shape)} do not fit (..., d), (d,)")
    x2 = x.reshape(-1, d).contiguous()
    dy2 = dy.reshape(-1, d).contiguous()
    dx = torch.empty_like(x2)
    dw = torch.zeros_like(w)
    n_rows = x2.shape[0]
    if n_rows:
        rows_per_prog = -(-n_rows // _BWD_PROGRAMS)
        n_prog = -(-n_rows // rows_per_prog)
        part = torch.empty(n_prog, d, dtype=torch.float32, device=x.device)
        block_d = 1 << (d - 1).bit_length()
        block_c = min(block_d, 256)
        bwd, colsum = _bwd_kernels()
        with torch.cuda.device(x.device):
            bwd[(n_prog,)](x2, w.contiguous(), dy2, dx, part, n_rows, d, eps,
                           rows_per_prog, BLOCK_D=block_d,
                           num_warps=4 if block_d <= 1024 else 8)
            colsum[(-(-d // block_c),)](part, dw, n_prog, d, BLOCK_P=16,
                                        BLOCK_C=block_c, num_warps=4)
        rmsnorm_bwd_cuda.launches += 1
    return dx.reshape(x.shape), dw


rmsnorm_bwd_cuda.launches = 0


class RMSNorm(torch.autograd.Function):
    """rmsnorm(x, w, eps) with both directions in Triton.  Saves x and w;
    the backward recomputes rstd."""

    @staticmethod
    def forward(ctx, x, w, eps):
        ctx.save_for_backward(x, w)
        ctx.eps = eps
        return rmsnorm_cuda(x, w, eps)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        dx, dw = rmsnorm_bwd_cuda(dy, x, w, ctx.eps)
        return dx, dw, None
