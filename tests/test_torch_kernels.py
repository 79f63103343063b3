"""The port's kernels against the JAX package's.

On the CPU ``repro_torch.kernels.ops`` runs each kernel's plain PyTorch
version; it is held here against the JAX oracles on the same numpy inputs:
``kernels/ref.py::flash_attention_ref`` and ``models/attention.py::sdpa_ref``
for attention (the Pallas flash kernel cannot run in this JAX version), the
interpret-mode Pallas RMSNorm kernel and ``rmsnorm_ref`` for RMSNorm.
Tolerances: fp32 1e-5 for attention and 1e-6 for RMSNorm (the same
arithmetic summed in another order); bf16 2e-2 for attention (bf16
rounding of outputs of size ~1) and one bf16 ulp for RMSNorm (fp32 math,
one rounding at the end).

The CUDA kernels themselves run only on the card: ``tests/test_torch_cuda.py``
holds them against their plain versions there.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import _validate_attn_shapes as jax_validate
from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.kernels.ref import rmsnorm_ref as jax_rmsnorm_ref
from repro.kernels.rmsnorm import rmsnorm as pallas_rmsnorm
from repro.models.attention import sdpa_ref as jax_sdpa_ref
from repro_torch.device import resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import flash_attention_cuda
from repro_torch.kernels.rmsnorm import rmsnorm_cuda
from repro_torch.models.attention import sdpa_ref as port_sdpa_ref

torch.set_num_threads(1)

DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 2e-2)}


def _both(a: np.ndarray, dtype: str):
    tdt, jdt, _ = DTYPES[dtype]
    return torch.from_numpy(a).to(tdt), jnp.asarray(a, jdt)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x.astype(jnp.float32))


def _qkv(rng, B, S, T, H, KV, dh):
    return (rng.standard_normal((B, S, H, dh), np.float32),
            rng.standard_normal((B, T, KV, dh), np.float32),
            rng.standard_normal((B, T, KV, dh), np.float32))


# (S, T, causal, window): ragged lengths, windows off the 8/128 blocking
FLASH_CASES = [(5, 5, True, None), (13, 29, True, 7), (37, 37, False, None),
               (21, 21, True, 9)]


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("kv", [4, 2, 1], ids=["G1", "G2", "G4"])
@pytest.mark.parametrize("S,T,causal,window", FLASH_CASES)
def test_flash_plain_matches_jax_ref(dtype, kv, S, T, causal, window):
    rng = np.random.default_rng(S * 100 + T + kv)
    (qt, qj), (kt, kj), (vt, vj) = (
        _both(a, dtype) for a in _qkv(rng, 2, S, T, 4, kv, 16))
    out = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
    want = jax_flash_ref(qj, kj, vj, causal=causal, window=window)
    assert out.dtype == qt.dtype and out.shape == qt.shape
    np.testing.assert_allclose(_np(out), _np(want), atol=DTYPES[dtype][2],
                               rtol=0)


def test_flash_all_masked_rows_are_exact_zeros():
    """Causal with window 1 and S > T: rows past T see no key; a lane with
    kv_len 0 sees none either."""
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(a) for a in _qkv(rng, 2, 8, 4, 4, 2, 16))
    out = ops.flash_attention(q, k, v, causal=True, window=1)
    want = jax_flash_ref(*(jnp.asarray(x.numpy()) for x in (q, k, v)),
                         causal=True, window=1)
    assert torch.all(out[:, 4:] == 0)
    assert torch.all(out[:, :4].abs().sum(-1) > 0)
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)
    out = ops.flash_attention(q, k, v, causal=False,
                              kv_len=torch.tensor([4, 0], dtype=torch.int32))
    assert torch.all(out[1] == 0) and torch.all(out[0].abs().sum(-1) > 0)


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_flash_prefill_offsets_match_sdpa_ref(dtype):
    """A prefill chunk at base 8 over a gathered cache of 24 keys with
    per-lane lengths; lane 2 is padding (kv_len 0) and is not compared."""
    rng = np.random.default_rng(2)
    (qt, qj), (kt, kj), (vt, vj) = (
        _both(a, dtype) for a in _qkv(rng, 3, 8, 24, 4, 2, 16))
    kv_len = np.array([13, 16, 0], np.int32)
    base = 8
    out = ops.flash_attention(
        qt, kt, vt, causal=True,
        q_offset=torch.full((3,), base, dtype=torch.int32),
        kv_len=torch.from_numpy(kv_len))
    want = jax_sdpa_ref(qj, kj, vj, causal=True, q_offset=jnp.int32(base),
                        kv_len=jnp.asarray(kv_len))
    np.testing.assert_allclose(_np(out)[:2], _np(want)[:2],
                               atol=DTYPES[dtype][2], rtol=0)
    assert torch.all(out[2] == 0)
    # the port's sdpa_ref takes the JAX signature (one shared offset)
    plain = port_sdpa_ref(qt, kt, vt, causal=True, q_offset=base,
                          kv_len=torch.from_numpy(kv_len))
    np.testing.assert_array_equal(_np(plain), _np(out))


@pytest.mark.parametrize("window", [None, 5])
def test_flash_decode_offsets_match_sdpa_ref(window):
    """One query per lane at its own position L (the decode mask k <= L);
    the inactive lane (L = -1) gives zeros and is not compared."""
    rng = np.random.default_rng(3)
    q, k, v = _qkv(rng, 4, 1, 24, 4, 2, 16)
    L = np.array([0, 7, 23, -1], np.int32)
    out = ops.flash_attention(*(torch.from_numpy(a) for a in (q, k, v)),
                              causal=True, window=window,
                              q_offset=torch.from_numpy(L))
    for b in range(3):
        want = jax_sdpa_ref(*(jnp.asarray(a[b:b + 1]) for a in (q, k, v)),
                            causal=True, window=window,
                            q_offset=jnp.int32(L[b]))
        np.testing.assert_allclose(out[b:b + 1].numpy(), np.asarray(want),
                                   atol=1e-5, rtol=0)
    assert torch.all(out[3] == 0)


@pytest.mark.parametrize("S,T,H,KV,window", [
    (8, 8, 4, 3, None),        # H % KV != 0
    (8, 8, 4, 2, 0),           # empty window
    (8, 8, 4, 2, -3),
    (8, 8, 4, 2, 9),           # window longer than the keys
])
def test_flash_rejects_bad_shapes_like_the_tpu_kernel(S, T, H, KV, window):
    with pytest.raises(ValueError) as jax_err:
        jax_validate(S, T, H, KV, window)
    q = torch.zeros(1, S, H, 16)
    k = torch.zeros(1, T, KV, 16)
    with pytest.raises(ValueError) as port_err:
        ops.flash_attention(q, k, k, causal=True, window=window)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(ValueError):
        flash_attention_cuda(q, k, k, causal=True, window=window)


def test_flash_binding_matches_the_c_signature():
    """The ctypes argument list has one entry per parameter of the C
    launcher, pointers as c_void_p (a short list shifts every argument)."""
    import ctypes
    import re

    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ARGTYPES

    src = (_build.CSRC / "flash_attention.cu").read_text()
    sig = re.search(r'extern "C" int flash_attention_fwd\((.*?)\)', src,
                    re.S).group(1)
    params = [p.strip() for p in sig.split(",")]
    assert len(params) == len(ARGTYPES)
    for p, t in zip(params, ARGTYPES):
        want = (ctypes.c_void_p if "*" in p else
                ctypes.c_float if p.startswith("float") else ctypes.c_int)
        assert t is want, p


def _bf16_ulp(x: np.ndarray) -> np.ndarray:
    mag = np.maximum(np.abs(x), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("shape", [(4, 256), (2, 3, 64), (7, 128)])
def test_rmsnorm_plain_matches_pallas_and_ref(dtype, shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape, np.float32) * 3
    w = rng.standard_normal(shape[-1:], np.float32)
    (xt, xj), (wt, wj) = _both(x, dtype), _both(w, dtype)
    out = _np(ops.rmsnorm(xt, wt, 1e-6))
    for want in (pallas_rmsnorm(xj, wj, eps=1e-6, interpret=True),
                 jax_rmsnorm_ref(xj, wj, 1e-6)):
        want = _np(want)
        if dtype == "float32":
            np.testing.assert_allclose(out, want, atol=1e-6, rtol=0)
        else:
            assert np.all(np.abs(out - want) <= _bf16_ulp(want))


def test_cuda_route_raises_instead_of_computing(monkeypatch):
    """The kernels refuse CPU tensors, and an entry point asked for
    ``cuda`` without a card raises rather than running on the CPU."""
    from repro_torch.configs import get_config
    from repro_torch.models import init_lm

    x = torch.randn(4, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        rmsnorm_cuda(x, torch.ones(64))
    q = torch.randn(1, 4, 2, 64)
    with pytest.raises(ValueError, match="CUDA device"):
        flash_attention_cuda(q, q, q)
    assert flash_attention_cuda.launches == 0 and rmsnorm_cuda.launches == 0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        init_lm(get_config("qwen3-4b").reduced(), device="cuda")
    # with a card, "cuda" resolves to the indexed device tensors report
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device("cpu") == torch.device("cpu")
