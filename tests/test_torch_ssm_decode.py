"""The port's SSM decode path against the JAX package's.

Inputs are made with numpy from a seed and weights come from JAX's
initialisers (bridged with ``repro_torch.bridge``), so both packages see the
same numbers; everything runs in fp32 on the CPU.

* ``ssd_step`` and ``ssm_block_decode`` against JAX, every step, the state
  and the conv history included, within 1e-5; the port writes the state in
  place.
* ``decode_step`` on bridged reduced mamba2-370m against JAX
  ``decode_step`` (logits within 1e-4 at every step) and against the port's
  own ``lm_forward`` at each position (2e-3, the tolerance of
  ``tests/test_models_numerics.py::test_decode_matches_prefill``).
* ``serve`` token-identical to JAX ``serve`` when no lane is recycled; with
  lanes recycled (2 lanes, 5 requests), each request's tokens equal JAX
  ``serve`` with a lane per request.
* The reference's leak: JAX ``serve`` resets only a recycled lane's index,
  so a request served on a lane after another differs from the same request
  served fresh; the port zeroes the lane's SSM state and conv history
  (``reset_decode_lane``) and does not.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import serve as jax_serve
from repro.models import ssm as jax_ssm
from repro.models.transformer import decode_step as jax_decode_step
from repro.models.transformer import init_decode_state as jax_init_decode_state
from repro.models.transformer import init_lm as jax_init_lm
from repro_torch.bridge import params_from_jax, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_mod
from repro_torch.models import (decode_step, init_decode_state, lm_forward,
                                reset_decode_lane)
from repro_torch.models.ssm import (SSM, init_ssm_state, ssd_step,
                                    ssm_block_decode)
from repro_torch.runtime.executor import make_serve_step

torch.set_num_threads(1)

CPU = torch.device("cpu")
ARCH = "mamba2-370m"


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


def _configs(arch=ARCH, **changes):
    return (jax_get_config(arch).reduced().with_(dtype=jnp.float32, **changes),
            get_config(arch).reduced().with_(dtype=torch.float32, **changes))


# ---------------------------------------------------------------------------
# ssd_step and ssm_block_decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("groups", ["one group", "per head"])
def test_ssd_step_matches_jax(groups):
    """Eight steps from a random state; B/C one (B,1,N) group broadcast
    over the heads (as ``ssm_block_decode`` passes them) or (B,H,N)."""
    B, H, P, N = 3, 4, 8, 16
    G = 1 if groups == "one group" else H
    rng = np.random.default_rng(G)
    state = rng.standard_normal((B, H, P, N)).astype(np.float32)
    A = -np.linspace(1.0, 16.0, H).astype(np.float32)
    state_j, state_t = jnp.asarray(state), torch.from_numpy(state.copy())
    for t in range(8):
        x = rng.standard_normal((B, H, P)).astype(np.float32)
        dt = np.log1p(np.exp(rng.standard_normal((B, H)))).astype(np.float32)
        Bm, Cm = (rng.standard_normal((B, G, N)).astype(np.float32)
                  for _ in range(2))
        state_j, y_j = jax_ssm.ssd_step(
            state_j, jnp.asarray(x), jnp.asarray(dt), jnp.asarray(A),
            *(jnp.broadcast_to(jnp.asarray(m), (B, H, N)) for m in (Bm, Cm)))
        out, y_t = ssd_step(state_t, torch.from_numpy(x), torch.from_numpy(dt),
                            torch.from_numpy(A), torch.from_numpy(Bm),
                            torch.from_numpy(Cm))
        assert out is state_t                   # written in place
        _close(y_t, y_j, 1e-5, f"y at step {t}")
        _close(state_t, state_j, 1e-5, f"state at step {t}")


def test_init_ssm_state_matches_jax_layout():
    cfg_j, cfg_t = _configs()
    want = jax_ssm.init_ssm_state(cfg_j, 3)
    got = init_ssm_state(cfg_t, 3, device="cpu")
    assert set(got) == set(want) == {"ssm", "conv"}
    for name in want:
        assert tuple(got[name].shape) == want[name].shape, name
        assert got[name].dtype == torch.float32 and not got[name].any()
    assert init_ssm_state(cfg_t, 1, dtype=torch.bfloat16,
                          device="cpu")["conv"].dtype == torch.bfloat16


def test_ssm_block_decode_matches_jax():
    """One reduced mamba2 layer, conv bias, dt bias and D randomised so
    that they matter, 10 tokens on 2 lanes: output, SSM state and conv
    history within 1e-5 at every step, the port's written in place."""
    cfg_j, cfg_t = _configs()
    p = jax.tree.map(np.asarray, jax_ssm.init_ssm(jax.random.PRNGKey(0),
                                                  cfg_j))
    rng = np.random.default_rng(0)
    for name in ("conv_b", "dt_bias", "D"):
        p[name] = (p[name] + 0.5 * rng.standard_normal(p[name].shape)
                   ).astype(np.float32)
    p_t = SSM(**{k: tensor_from_numpy(v, CPU) for k, v in p.items()})
    p_j = jax.tree.map(jnp.asarray, p)
    state_j = jax_ssm.init_ssm_state(cfg_j, 2)
    state_t = init_ssm_state(cfg_t, 2, device="cpu")
    tensors = dict(state_t)
    xs = rng.standard_normal((2, 10, cfg_t.d_model)).astype(np.float32)
    for t in range(10):
        y_j, state_j = jax_ssm.ssm_block_decode(
            p_j, jnp.asarray(xs[:, t:t + 1]), state_j, cfg_j)
        with torch.inference_mode():
            y_t, out = ssm_block_decode(
                p_t, torch.from_numpy(xs[:, t:t + 1]), state_t, cfg_t)
        assert out is state_t and all(out[k] is tensors[k] for k in out)
        _close(y_t, y_j, 1e-5, f"output at t={t}")
        for name in ("ssm", "conv"):
            _close(state_t[name], state_j[name], 1e-5, f"{name} at t={t}")


# ---------------------------------------------------------------------------
# decode_step on reduced mamba2-370m
# ---------------------------------------------------------------------------

def _bridged(arch=ARCH, seed=0, **changes):
    cfg_j, cfg_t = _configs(arch, **changes)
    params_j = jax_init_lm(jax.random.PRNGKey(seed), cfg_j)
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def test_decode_step_matches_jax():
    cfg_j, cfg_t, params_j, params_t = _bridged()
    T = 12
    toks = np.random.default_rng(T).integers(0, cfg_t.vocab_size, (2, T),
                                             dtype=np.int32)
    state_j = jax_init_decode_state(cfg_j, 2, 32)
    state_t = init_decode_state(cfg_t, 2, 32, device="cpu")
    assert state_t["caches"] == [] and len(state_t["ssm_states"]) == 2
    step = make_serve_step(cfg_t)
    for t in range(T):
        logits_j, state_j = jax_decode_step(params_j, state_j,
                                            jnp.asarray(toks[:, t]), cfg_j)
        logits_t, state_t = step(params_t, state_t,
                                 torch.from_numpy(toks[:, t]))
        _close(logits_t, logits_j, 1e-4, f"logits at t={t}")
        assert int(state_t["index"]) == t + 1
    # the states JAX stacks by layer are the port's, one a layer
    for name in ("ssm", "conv"):
        for i, st in enumerate(state_t["ssm_states"]):
            _close(st[name], state_j["stacks"][0][name][i], 1e-5,
                   f"layer {i} {name}")


def test_decode_step_matches_lm_forward():
    _, cfg, _, params = _bridged(seed=1)
    T = 16
    toks = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, T)))
    with torch.no_grad():
        full, _ = lm_forward(params, toks, cfg)
        state = init_decode_state(cfg, 2, T, device="cpu")
        for t in range(T):
            logits, state = decode_step(params, state, toks[:, t], cfg)
            _close(logits, full[:, t], 2e-3, f"t={t}")


# ---------------------------------------------------------------------------
# serve, and the recycled lane
# ---------------------------------------------------------------------------

def _serve_params(cfg_j, cfg_t, seed=0):
    """The port's copy of the weights JAX ``serve`` draws from ``seed``."""
    params_j = jax.jit(lambda k: jax_init_lm(k, cfg_j))(
        jax.random.PRNGKey(seed))
    return params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                           device="cpu")


def _spec(vocab, n, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, vocab, int(rng.integers(1, 9))).tolist(),
             int(rng.integers(2, 7))) for _ in range(n)]


def _run(serve_fn, request_cls, spec, batch, **kw):
    reqs = [request_cls(i, list(p), n) for i, (p, n) in enumerate(spec)]
    serve_fn(reqs=reqs, batch=batch, **kw)
    for r in reqs:
        assert r.done and len(r.generated) == r.max_new, f"request {r.rid}"
    return [r.generated for r in reqs]


def _jax(cfg_j, spec, batch):
    return _run(lambda reqs, batch: jax_serve(cfg_j, reqs, batch=batch,
                                              context=24, seed=0,
                                              verbose=False),
                JaxRequest, spec, batch)


def _port(cfg_t, params_t, spec, batch):
    return _run(lambda reqs, batch: serve_mod.serve(
        cfg_t, reqs, batch, 24, seed=0, verbose=False, device="cpu",
        params=params_t), serve_mod.Request, spec, batch)


def test_serve_token_identical_to_jax_serve_without_recycling():
    """Four requests on four lanes: no lane is recycled, so the two
    packages serve the same contract."""
    cfg_j, cfg_t = _configs()
    spec = _spec(cfg_t.vocab_size, 4)
    assert _port(cfg_t, _serve_params(cfg_j, cfg_t), spec, 4) == \
        _jax(cfg_j, spec, 4)


def test_serve_with_recycled_lanes_equals_a_lane_per_request():
    """Five requests on two lanes (three recycled) against JAX ``serve``
    with five lanes, where no lane is recycled."""
    cfg_j, cfg_t = _configs()
    spec = _spec(cfg_t.vocab_size, 5, seed=1)
    assert _port(cfg_t, _serve_params(cfg_j, cfg_t), spec, 2) == \
        _jax(cfg_j, spec, 5)


def test_reference_serve_leaks_ssm_state_on_a_recycled_lane():
    """One lane, the requests [5, 6, 7] then [9, 10, 11], 6 new tokens
    each.  JAX ``serve`` gives the second request other tokens than it
    gives it alone: the lane's SSM state and conv history carry the first
    request.  The port gives it the tokens it gets alone."""
    cfg_j, cfg_t = _configs()
    spec = [([5, 6, 7], 6), ([9, 10, 11], 6)]
    alone = _jax(cfg_j, spec[1:], 1)[0]
    leaked = _jax(cfg_j, spec, 1)[1]
    assert leaked != alone
    assert _port(cfg_t, _serve_params(cfg_j, cfg_t), spec, 1)[1] == alone


def test_reset_decode_lane_clears_only_that_lane():
    _, cfg = _configs()
    state = init_decode_state(cfg, 3, 8, device="cpu")
    state["index"] = torch.tensor([4, 5, 6], dtype=torch.int32)
    for st in state["ssm_states"]:
        for t in st.values():
            t.fill_(1.0)
    with torch.inference_mode():
        reset_decode_lane(state, 1)
    assert state["index"].tolist() == [4, 0, 6]
    for st in state["ssm_states"]:
        for t in st.values():
            assert not t[1].any() and bool((t[[0, 2]] == 1).all())


def test_serve_cli_dense_engine_serves_mamba2_on_cpu(capsys):
    serve_mod.main(["--engine", "dense", "--arch", ARCH, "--device", "cpu",
                    "--reduced", "--requests", "3", "--batch", "2",
                    "--context", "8", "--max-new", "5"])
    out = capsys.readouterr().out
    assert "served 3 requests, 15 tokens" in out
