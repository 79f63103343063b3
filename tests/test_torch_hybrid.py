"""The port's zamba2 hybrid against the JAX package's.

Bridged reduced zamba2-1.2b in fp32 on the CPU, cut to 5 layers
(``attn_every`` 2): two SSM segments each followed by the weight-shared
attention block, and a tail segment of one layer with none after it.

* ``lm_forward`` and ``make_prefill_step`` against JAX ``lm_forward``
  (1e-4); per-segment remat by the JAX clamped-index rule.
* ``lm_loss`` and every gradient against ``jax.value_and_grad``: the loss
  within 1e-5 relative, each gradient within 1e-4 of its leaf's largest
  magnitude.
* ``decode_step`` against JAX ``decode_step`` (1e-4) and against the port's
  ``lm_forward`` at each position (2e-3, the tolerance of
  ``tests/test_models_numerics.py::test_decode_matches_prefill``).
* ``serve`` token-identical to JAX ``serve`` with no lane recycled, and on
  recycled lanes equal to a lane per request.
* The bridge carries ``shared_attn`` bit for bit and raises on a key it
  does not map.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import serve as jax_serve
from repro.models.transformer import decode_step as jax_decode_step
from repro.models.transformer import init_decode_state as jax_init_decode_state
from repro.models.transformer import init_lm as jax_init_lm
from repro.models.transformer import lm_forward as jax_lm_forward
from repro.models.transformer import lm_loss as jax_lm_loss
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import (build_stacks, decode_step, init_decode_state,
                                init_lm, lm_forward, lm_loss)
from repro_torch.models import transformer as tr_mod
from repro_torch.runtime.executor import make_prefill_step, make_serve_step

torch.set_num_threads(1)

ARCH, LAYERS = "zamba2-1.2b", 5


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: max|diff| / max|ref| = {err:.3e} > {tol}"


def _configs():
    cfg_j = jax_get_config(ARCH).reduced().with_(n_layers=LAYERS,
                                                 dtype=jnp.float32)
    cfg_t = get_config(ARCH).reduced().with_(n_layers=LAYERS,
                                             dtype=torch.float32)
    return cfg_j, cfg_t


def _bridged(seed=0, jit=False):
    cfg_j, cfg_t = _configs()
    init = jax.jit(lambda k: jax_init_lm(k, cfg_j)) if jit else (
        lambda k: jax_init_lm(k, cfg_j))
    params_j = init(jax.random.PRNGKey(seed))
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def _tokens(cfg, shape, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, shape,
                                                dtype=np.int32)


def _leaf_pairs(params_j, params_t):
    """(name, JAX leaf, port tensor) for every parameter of the model."""
    stack = params_j["stacks"][0]
    yield "embed", params_j["embed"], params_t.embed
    yield "final_norm", params_j["final_norm"], params_t.final_norm
    for i, blk in enumerate(params_t.blocks):
        yield f"blocks.{i}.ln1", stack["ln1"][i], blk.ln1
        for k, v in stack["ssm"].items():
            yield f"blocks.{i}.ssm.{k}", v[i], getattr(blk.ssm, k)
    sa = params_j["shared_attn"]
    yield "shared_attn.ln", sa["ln"], params_t.shared_attn.ln
    for k, v in sa["attn"].items():
        yield f"shared_attn.attn.{k}", v, getattr(params_t.shared_attn.attn, k)


def test_hybrid_layout():
    """One SSM segment of every layer (JAX ``build_stacks``), the shared
    block after layers 2 and 4, and the decode state's two K/V caches."""
    _, cfg = _configs()
    assert cfg.attn_every == 2
    assert build_stacks(cfg) == [("ssm", LAYERS)]
    assert tr_mod._segments(cfg) == [("ssm", 0, 2, True), ("ssm", 2, 4, True),
                                     ("ssm", 4, 5, False)]
    state = init_decode_state(cfg, 2, 16, device="cpu")
    assert len(state["caches"]) == LAYERS // 2
    assert len(state["ssm_states"]) == LAYERS
    assert init_lm(cfg, device="cpu").shared_attn is not None
    assert init_lm(get_config("mamba2-370m").reduced(),
                   device="cpu").shared_attn is None


def test_lm_forward_and_prefill_step_match_jax():
    cfg_j, cfg_t, params_j, params_t = _bridged()
    toks = _tokens(cfg_t, (2, 40), 0)
    want, _ = jax_lm_forward(params_j, jnp.asarray(toks), cfg_j)
    with torch.no_grad():
        got, aux = lm_forward(params_t, torch.from_numpy(toks), cfg_t)
    assert float(aux) == 0.0
    _close(got, want, 1e-4, "lm_forward")
    got = make_prefill_step(cfg_t)(params_t,
                                   {"tokens": torch.from_numpy(toks)})
    _close(got, want, 1e-4, "make_prefill_step")


def test_lm_loss_and_every_gradient_match_jax():
    cfg_j, cfg_t, params_j, params_t = _bridged(seed=1)
    toks = _tokens(cfg_t, (2, 24), 1)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -100
    batch_j = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    batch_t = {"tokens": torch.from_numpy(toks),
               "labels": torch.from_numpy(labels)}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, batch_j, cfg_j)))(params_j)
    loss_t = lm_loss(params_t, batch_t, cfg_t)
    leaves = list(params_t.parameters())
    grads_t = dict(zip(map(id, leaves), torch.autograd.grad(loss_t, leaves)))
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    pairs = list(_leaf_pairs(jax.tree.map(np.asarray, grads_j), params_t))
    assert len(pairs) == len(leaves)
    for name, g_j, p in pairs:
        _close(grads_t[id(p)].numpy(), g_j, 1e-4, name)


@pytest.mark.parametrize("remat,blocks", [([True], 5), ([False, True], 3),
                                          ([True, False, False], 2)])
def test_remat_segments_take_the_clamped_index(monkeypatch, remat, blocks):
    """Segment i is rematerialised when remat[min(i, len - 1)] is true: the
    blocks of those segments go through ``checkpoint``, and the loss and
    gradients are those of the run without remat."""
    _, cfg, _, params = _bridged(seed=2)
    toks = torch.from_numpy(_tokens(cfg, (2, 16), 2))
    batch = {"tokens": toks, "labels": toks.roll(-1, 1)}
    leaves = list(params.parameters())
    plain = torch.autograd.grad(lm_loss(params, batch, cfg), leaves)
    calls = []
    real = tr_mod.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)

    monkeypatch.setattr(tr_mod, "checkpoint", counting)
    got = torch.autograd.grad(lm_loss(params, batch, cfg,
                                      remat_segments=remat), leaves)
    assert len(calls) == blocks
    for g, want in zip(got, plain):
        torch.testing.assert_close(g, want, rtol=0, atol=0)


def test_decode_step_matches_jax():
    cfg_j, cfg_t, params_j, params_t = _bridged(seed=3)
    T = 12
    toks = _tokens(cfg_t, (2, T), T)
    state_j = jax_init_decode_state(cfg_j, 2, 32)
    state_t = init_decode_state(cfg_t, 2, 32, device="cpu")
    step = make_serve_step(cfg_t)
    for t in range(T):
        logits_j, state_j = jax_decode_step(params_j, state_j,
                                            jnp.asarray(toks[:, t]), cfg_j)
        logits_t, state_t = step(params_t, state_t,
                                 torch.from_numpy(toks[:, t]))
        _close(logits_t, logits_j, 1e-4, f"logits at t={t}")
    for a, (cj, ct) in enumerate(zip(state_j["shared_attn"],
                                     state_t["caches"])):
        for name in ("k", "v"):
            _close(ct[name], cj[name], 1e-5, f"shared cache {a} {name}")


def test_decode_step_matches_lm_forward():
    _, cfg, _, params = _bridged(seed=4)
    T = 16
    toks = torch.from_numpy(_tokens(cfg, (2, T), 4))
    with torch.no_grad():
        full, _ = lm_forward(params, toks, cfg)
        state = init_decode_state(cfg, 2, T, device="cpu")
        for t in range(T):
            logits, state = decode_step(params, state, toks[:, t], cfg)
            np.testing.assert_allclose(logits.numpy(), full[:, t].numpy(),
                                       atol=2e-3, rtol=2e-3, err_msg=f"t={t}")


def _spec(vocab, n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(1, 9))).tolist(),
             int(rng.integers(2, 7))) for _ in range(n)]


def _generated(reqs):
    for r in reqs:
        assert r.done and len(r.generated) == r.max_new, f"request {r.rid}"
    return [r.generated for r in reqs]


@pytest.mark.parametrize("port_lanes", [4, 2], ids=["no-recycling",
                                                    "recycled"])
def test_serve_token_identical_to_jax_serve(port_lanes):
    """Four requests; JAX ``serve`` on four lanes (none recycled), the port
    on four, and on two lanes, where two are recycled: the port resets a
    recycled lane's SSM state, so it gives the same tokens."""
    cfg_j, cfg_t, _, params_t = _bridged(seed=0, jit=True)
    spec = _spec(cfg_t.vocab_size, 4, 5)
    reqs_j = [JaxRequest(i, list(p), n) for i, (p, n) in enumerate(spec)]
    reqs_t = [serve_mod.Request(i, list(p), n)
              for i, (p, n) in enumerate(spec)]
    jax_serve(cfg_j, reqs_j, batch=4, context=24, seed=0, verbose=False)
    serve_mod.serve(cfg_t, reqs_t, port_lanes, 24, verbose=False,
                    device="cpu", params=params_t)
    assert _generated(reqs_t) == _generated(reqs_j)


def test_bridge_carries_shared_attn_bit_for_bit():
    cfg_j = jax_get_config(ARCH).reduced().with_(n_layers=LAYERS)
    params_j = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(1),
                                                    cfg_j))
    cfg_t = get_config(ARCH).reduced().with_(n_layers=LAYERS)
    params_t = params_from_jax(params_j, cfg_t, device="cpu")
    pairs = list(_leaf_pairs(params_j, params_t))
    assert len(pairs) == len(list(params_t.parameters()))
    assert sum(t.numel() for t in params_t.parameters()) == sum(
        a.size for a in jax.tree.leaves(params_j))
    for name, a, t in pairs:
        if a.dtype == np.float32:
            assert t.dtype == torch.float32, name
            np.testing.assert_array_equal(t.detach().numpy(), a)
        else:
            assert t.dtype == torch.bfloat16, name
            np.testing.assert_array_equal(
                t.detach().view(torch.int16).numpy(), a.view(np.int16))


@pytest.mark.parametrize("where", ["top", "shared_attn", "attention"])
def test_bridge_raises_on_a_key_it_does_not_map(where):
    cfg_j, cfg_t = _configs()
    tree = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(0), cfg_j))
    extra = np.zeros(3, np.float32)
    {"top": tree, "shared_attn": tree["shared_attn"],
     "attention": tree["shared_attn"]["attn"]}[where]["projector"] = extra
    with pytest.raises(ValueError, match="projector"):
        params_from_jax(tree, cfg_t, device="cpu")
