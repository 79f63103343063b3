"""RMSNorm on Hopper: a Triton kernel and its wrapper.

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

:func:`rmsnorm_cuda` only launches the kernel; ``kernels/ops.py`` picks it
for CUDA tensors and ``kernels/ref.py::rmsnorm_ref`` for CPU tensors.
``triton`` is imported when the kernel is first launched, never when this
module is imported.
"""
import functools

import torch

_BLOCK_ELEMS = 4096


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
