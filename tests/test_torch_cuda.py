"""The port's kernels on the card, against their plain PyTorch versions.

Marked ``gpu``: they need a CUDA device and skip without one (the kernels
have no CPU mode).  They import neither JAX nor the JAX package, so they
run where only the port is installed:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_cuda.py

Tolerances: fp32 1e-5 (the same fp32 arithmetic in another order); bf16
attention 2e-2 (bf16 rounding of outputs of size ~1); bf16 RMSNorm one
bf16 ulp (fp32 math, one rounding at the end).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.rmsnorm import rmsnorm_cuda

torch.set_num_threads(1)

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
# (S, T, causal, window): ragged lengths, windows off the 64-row tiles
FLASH_CASES = [(5, 5, True, None), (13, 29, True, 7), (37, 37, False, None),
               (21, 21, True, 9), (130, 200, True, None)]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; the kernels do not run on the CPU")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [64, 128])
@pytest.mark.parametrize("S,T,causal,window", FLASH_CASES)
def test_flash_kernel_matches_plain_on_card(cuda_device, dtype, dh, S, T,
                                            causal, window):
    rng = np.random.default_rng(S + T + dh)
    q, k, v = (torch.from_numpy(rng.standard_normal(shape, np.float32))
               .to(cuda_device, dtype)
               for shape in ((2, S, 8, dh), (2, T, 2, dh), (2, T, 2, dh)))
    lanes = dict(q_offset=torch.tensor([0, 3], dtype=torch.int32,
                                       device=cuda_device),
                 kv_len=torch.tensor([T, T - 2], dtype=torch.int32,
                                     device=cuda_device))
    for kw in ({}, lanes):
        out = flash_attention_cuda(q, k, v, causal=causal, window=window,
                                   **kw)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, causal=causal,
                                       window=window, **kw)
        assert (out.float() - want.float()).abs().max().item() <= TOL[dtype]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(5, 2560), (3, 7, 128), (1, 100)])
def test_rmsnorm_kernel_matches_plain_on_card(cuda_device, dtype, shape):
    g = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda_device).to(dtype)
    w = torch.randn(shape[-1], generator=g, device=cuda_device).to(dtype)
    out = rmsnorm_cuda(x, w, 1e-6).float()
    torch.cuda.synchronize()
    want = ref.rmsnorm_ref(x, w, 1e-6).float()
    if dtype == torch.float32:
        tol = TOL[dtype]
    else:
        tol = torch.exp2(torch.floor(torch.log2(
            want.abs().clamp_min(1e-30))) - 7)
    assert bool(((out - want).abs() <= tol).all())
