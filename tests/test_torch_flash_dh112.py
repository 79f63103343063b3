"""Flash attention at head dim 112 (kimi-k2-1t-a32b: 7168 / 64) on the CPU.

The CUDA kernels run dh 112 in tiles padded to 128 columns; what they
compute is held here through their plain versions against the JAX
package, on numpy inputs from seeded generators:

* ``flash_attention_ref``, ``flash_attention_lse_ref`` and
  ``flash_attention_bwd_ref`` at dh 112 (H 8, KV 2) against JAX
  ``sdpa_ref``, a masked ``logsumexp`` and ``jax.vjp`` of ``sdpa_ref``,
  within 1e-5 of each output's largest magnitude (fp32);
* the port's ``attention`` layer, ``decode_step`` and the paged engine on
  reduced kimi-k2-1t-a32b with ``head_dim=112`` against JAX (logits within
  1e-5, tokens identical);
* the wrapper's shape check, which takes 64, 112 and 128 and refuses
  another head dim.

``tests/test_torch_cuda.py`` holds the kernels at dh 112 against these
plain versions on the card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import serve_paged as jax_serve_paged
from repro.models import attention as jax_attn
from repro.models.transformer import decode_step as jax_decode_step
from repro.models.transformer import init_decode_state as jax_init_decode_state
from repro.models.transformer import init_lm as jax_init_lm
from repro.serving import EngineConfig as JaxEngineConfig
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.models import init_decode_state
from repro_torch.models.attention import attention
from repro_torch.runtime.executor import make_serve_step
from repro_torch.serving import EngineConfig, ServeRequest, ServingEngine

torch.set_num_threads(1)

DH, H, KV = 112, 8, 2
TOL = 1e-5
KIMI = "kimi-k2-1t-a32b"


def _close(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= TOL, f"{what}: max|diff| / max|ref| = {err:.3e}"


def _inputs(S, T, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape, np.float32)
            for shape in ((2, S, H, DH), (2, T, KV, DH), (2, T, KV, DH),
                          (2, S, H, DH))]


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 9), (False, 5)])
def test_forward_and_lse_refs_at_dh112_match_jax(causal, window):
    q, k, v, _ = _inputs(21, 37, seed=3 + 2 * causal + (window or 0))
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    kw = dict(causal=causal, window=window)
    got = ref.flash_attention_ref(qt, kt, vt, **kw)
    want = jax_attn.sdpa_ref(*map(jnp.asarray, (q, k, v)), **kw)
    _close(got.numpy(), want, "out vs sdpa_ref")
    # the row log-sum-exp against a masked logsumexp of the scaled scores
    lse = ref.flash_attention_lse_ref(qt, kt, vt, **kw)
    s = np.einsum("bskgd,btkd->bkgst",
                  q.reshape(2, 21, KV, H // KV, DH).astype(np.float64),
                  k.astype(np.float64)) / np.sqrt(DH)
    qpos, kpos = np.arange(21)[:, None], np.arange(37)[None, :]
    ok = np.ones((21, 37), bool)
    if causal:
        ok &= kpos <= qpos
    if window:
        ok &= kpos > qpos - window
    s = np.where(ok, s, -np.inf)
    m = s.max(-1, keepdims=True)
    with np.errstate(invalid="ignore", divide="ignore"):
        want_lse = (m + np.log(np.exp(s - m).sum(-1, keepdims=True)))[..., 0]
    want_lse = np.where(ok.any(-1), want_lse, np.inf)          # (b,k,g,s)
    want_lse = want_lse.transpose(0, 3, 1, 2).reshape(2, 21, H)
    fin = np.isfinite(want_lse)
    assert np.array_equal(np.isfinite(lse.numpy()), fin)
    _close(lse.numpy()[fin], want_lse[fin], "lse")


@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 7)])
def test_backward_ref_at_dh112_matches_jax_grad(causal, window):
    q, k, v, do = _inputs(20, 20, seed=11 + causal + (window or 0))
    kw = dict(causal=causal, window=window)
    qt, kt, vt = map(torch.from_numpy, (q, k, v))
    out = ref.flash_attention_ref(qt, kt, vt, **kw)
    lse = ref.flash_attention_lse_ref(qt, kt, vt, **kw)
    got = ref.flash_attention_bwd_ref(qt, kt, vt, out, torch.from_numpy(do),
                                      lse, **kw)
    _, vjp = jax.vjp(lambda a, b, c: jax_attn.sdpa_ref(a, b, c, **kw),
                     *map(jnp.asarray, (q, k, v)))
    for name, g, w in zip(("dq", "dk", "dv"), got, vjp(jnp.asarray(do))):
        assert g.shape[-1] == DH
        _close(g.numpy(), np.asarray(w), f"{name} vs jax.grad")


def _kimi(**kw):
    """Reduced kimi-k2-1t-a32b (16 experts: top-8, a shared expert, its
    first layer dense) at head dim 112, fp32, bridged from JAX."""
    cfg_j = jax_get_config(KIMI).reduced(n_experts=16).with_(
        head_dim=DH, dtype=jnp.float32, **kw)
    cfg_t = get_config(KIMI).reduced(n_experts=16).with_(
        head_dim=DH, dtype=torch.float32, **kw)
    params_j = jax.jit(lambda key: jax_init_lm(key, cfg_j))(
        jax.random.PRNGKey(0))
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def test_attention_layer_at_dh112_matches_jax():
    cfg_j, cfg_t, params_j, params_t = _kimi()
    assert cfg_t.dh == DH and cfg_t.q_dim == cfg_t.n_heads * DH
    p_j = jax.tree.map(lambda a: a[0], params_j["stacks"][0]["attn"])
    p_t = params_t.blocks[0].attn
    x = np.random.default_rng(5).standard_normal((2, 19, cfg_t.d_model),
                                                 np.float32)
    pos = np.broadcast_to(np.arange(19), (2, 19))
    got = attention(p_t, torch.from_numpy(x), torch.from_numpy(pos.copy()),
                    cfg_t)
    want = jax_attn.attention(p_j, jnp.asarray(x), jnp.asarray(pos), cfg_j)
    _close(got.detach().numpy(), want, "attention at dh 112")


def test_decode_and_paged_serving_at_dh112_match_jax():
    """``make_serve_step`` against JAX ``decode_step`` for 10 tokens
    (logits within 1e-5), and the paged engine (paged decode and chunked
    prefill at dh 112) token-identical to JAX ``serve_paged``."""
    cfg_j, cfg_t, params_j, params_t = _kimi()
    toks = np.random.default_rng(6).integers(0, cfg_t.vocab_size, (2, 10),
                                             dtype=np.int32)
    state_j = jax_init_decode_state(cfg_j, 2, 16)
    state_t = init_decode_state(cfg_t, 2, 16, device="cpu")
    step = make_serve_step(cfg_t)
    jstep = jax.jit(lambda p, s, t: jax_decode_step(p, s, t, cfg_j))
    for t in range(toks.shape[1]):
        want, state_j = jstep(params_j, state_j, jnp.asarray(toks[:, t]))
        got, state_t = step(params_t, state_t, torch.from_numpy(toks[:, t]))
        _close(got, want, f"decode logits at {t}")
    geo = dict(page_size=4, n_pages=24, decode_slots=3, max_context=24,
               prefill_batch=2, prefill_chunk=4)
    rng = np.random.default_rng(7)
    spec = [(rng.integers(0, cfg_t.vocab_size, int(rng.integers(3, 13))
                          ).tolist(), int(rng.integers(3, 7)))
            for _ in range(5)]
    reqs_j = [JaxRequest(i, list(p), n) for i, (p, n) in enumerate(spec)]
    jax_serve_paged(cfg_j, reqs_j, JaxEngineConfig(**geo), seed=0,
                    verbose=False)
    reqs_t = [ServeRequest(rid=str(i), prompt=list(p), max_new=n)
              for i, (p, n) in enumerate(spec)]
    ServingEngine(cfg_t, params_t, EngineConfig(**geo),
                  device="cpu").run(reqs_t)
    for rj, rt in zip(reqs_j, reqs_t):
        assert rt.done and rt.tokens == rj.generated, f"request {rj.rid}"


@pytest.mark.parametrize("dh", [64, 112, 128])
def test_wrapper_shape_check_takes_dh112(dh):
    q, k = torch.zeros(1, 3, 4, dh), torch.zeros(1, 5, 2, dh)
    fa.check_shapes(q, k, k)
    assert dh in fa._HEAD_DIMS


@pytest.mark.parametrize("dh", [96, 120, 256])
def test_wrapper_shape_check_refuses_another_dh(dh):
    q, k = torch.zeros(1, 3, 4, dh), torch.zeros(1, 5, 2, dh)
    with pytest.raises(ValueError, match=r"\(64, 112, 128\)"):
        fa.check_shapes(q, k, k)
