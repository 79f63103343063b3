"""The port's SSM pieces against the JAX package's, on the CPU.

The Pallas SSD kernel does not run in this JAX version (its interpret mode
needs ``pl.load``), so the oracles are the JAX package's plain versions:
``models/ssm.py::ssd_chunked`` and its ``jax.grad`` for the scan,
``ssm_block`` (``use_kernel=False``) for the block and
``models/layers.py::cross_entropy_loss`` for the loss.  Inputs are numpy
arrays from a seed, given to both packages.

Tolerances (fp32): the scan, its five input gradients and the block within
1e-5 of the largest magnitude of each reference (the same fp32 arithmetic
summed in another order); the loss within 1e-6 relative.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.layers import cross_entropy_loss as jax_cross_entropy
from repro.models.ssm import init_ssm as jax_init_ssm
from repro.models.ssm import ssd_chunked
from repro.models.ssm import ssm_block as jax_ssm_block
from repro_torch.bridge import tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.ref import ssd_scan_ref
from repro_torch.models.layers import cross_entropy_loss
from repro_torch.models.ssm import SSM, ssm_block

torch.set_num_threads(1)

TOL = 1e-5


def _close(got, want, tol=TOL, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() / scale
    assert err <= tol, f"{what}: max|diff| / max|ref| = {err:.3e} > {tol}"


def _ssd_inputs(rng, B, S, H, P, N):
    x = rng.standard_normal((B, S, H, P)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, S, H)))).astype(np.float32)
    A = -np.exp(np.log(np.linspace(1.0, 16.0, H))).astype(np.float32)
    Bm = (0.5 * rng.standard_normal((B, S, H, N))).astype(np.float32)
    Cm = (0.5 * rng.standard_normal((B, S, H, N))).astype(np.float32)
    return x, dt, A, Bm, Cm


# (B, S, H, P, N, chunk): S a multiple of the chunk, ragged, shorter
SSD_CASES = [(2, 32, 3, 8, 4, 8), (2, 29, 3, 8, 4, 8), (1, 5, 2, 4, 3, 8),
             (1, 48, 2, 16, 16, 16)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_CASES)
def test_ssd_scan_ref_matches_ssd_chunked(B, S, H, P, N, chunk):
    rng = np.random.default_rng(S * 10 + P)
    ins = _ssd_inputs(rng, B, S, H, P, N)
    want = ssd_chunked(*map(jnp.asarray, ins), chunk)
    got = ssd_scan_ref(*map(torch.from_numpy, ins), chunk)
    _close(got.numpy(), want, what="y")
    # the CPU route of the dispatcher is the plain version
    np.testing.assert_array_equal(
        ops.ssd_scan(*map(torch.from_numpy, ins), chunk).numpy(), got.numpy())


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_CASES)
def test_ssd_scan_ref_gradients_match_jax_grad(B, S, H, P, N, chunk):
    rng = np.random.default_rng(S * 10 + P + 1)
    ins = _ssd_inputs(rng, B, S, H, P, N)
    dy = rng.standard_normal((B, S, H, P)).astype(np.float32)
    want = jax.grad(
        lambda *a: jnp.sum(ssd_chunked(*a, chunk) * dy),
        argnums=(0, 1, 2, 3, 4))(*map(jnp.asarray, ins))
    leaves = [torch.from_numpy(a).requires_grad_() for a in ins]
    got = torch.autograd.grad(ssd_scan_ref(*leaves, chunk),
                              leaves, torch.from_numpy(dy))
    for name, g, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        _close(g.numpy(), w, what=name)


def test_ssd_scan_ref_head_broadcast_view_equals_copy():
    """models/ssm.py passes B/C as one group for all heads, (B,S,1,N); the
    result and the gradient of the group equal those of a view broadcast
    over the heads and of a copy of it."""
    rng = np.random.default_rng(3)
    B, S, H, P, N = 2, 21, 4, 8, 5
    x, dt, A, _, _ = _ssd_inputs(rng, B, S, H, P, N)
    bg = rng.standard_normal((B, S, 1, N)).astype(np.float32)
    cg = rng.standard_normal((B, S, 1, N)).astype(np.float32)
    outs = []
    for form in ("copy", "view", "group"):
        b, c = (torch.from_numpy(a).requires_grad_() for a in (bg, cg))
        bv, cv = (t.expand(B, S, H, N) for t in (b, c))
        if form == "copy":
            bv, cv = bv.contiguous(), cv.contiguous()
        elif form == "group":
            bv, cv = b, c
        y = ssd_scan_ref(*map(torch.from_numpy, (x, dt, A)), bv, cv, 8)
        outs.append((y, *torch.autograd.grad(y.sum(), (b, c))))
    for got in outs[1:]:
        for a, b in zip(got, outs[0]):
            _close(a.detach().numpy(), b.detach().numpy(), tol=1e-6)


def _bridged_ssm(p_j):
    return SSM(**{k: tensor_from_numpy(np.asarray(v), torch.device("cpu"))
                  for k, v in p_j.items()})


@pytest.mark.parametrize("S", [32, 23])
def test_ssm_block_matches_jax_on_bridged_weights(S):
    cfg_j = jax_get_config("mamba2-370m").reduced().with_(dtype=jnp.float32)
    cfg_t = get_config("mamba2-370m").reduced().with_(dtype=torch.float32)
    p_j = jax_init_ssm(jax.random.PRNGKey(0), cfg_j)
    # non-trivial conv bias, D and dt_bias, so that every term counts
    rng = np.random.default_rng(S)
    for k in ("conv_b", "D", "dt_bias"):
        p_j[k] = jnp.asarray(rng.standard_normal(p_j[k].shape)
                             .astype(np.float32) * 0.3)
    x = rng.standard_normal((2, S, cfg_t.d_model)).astype(np.float32)
    want = jax_ssm_block(p_j, jnp.asarray(x), cfg_j, use_kernel=False)
    got = ssm_block(_bridged_ssm(p_j), torch.from_numpy(x), cfg_t)
    _close(got.detach().numpy(), want, what="ssm_block")


def test_cross_entropy_loss_with_ignore_id_matches_jax():
    rng = np.random.default_rng(0)
    logits = (3 * rng.standard_normal((3, 7, 50))).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    labels[0, :4] = -100
    labels[2, 6] = -100
    for lab in (labels, np.full_like(labels, -100)):
        want = float(jax_cross_entropy(jnp.asarray(logits), jnp.asarray(lab)))
        got = float(cross_entropy_loss(torch.from_numpy(logits),
                                       torch.from_numpy(lab)))
        assert got == pytest.approx(want, rel=1e-6, abs=1e-7)
