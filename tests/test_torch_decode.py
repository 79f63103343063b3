"""The port's dense-cache decode path against the JAX package's.

Inputs are made with numpy from a seed and weights come from JAX's
initialisers (bridged with ``repro_torch.bridge``), so both packages see the
same numbers; everything runs in fp32 on the CPU, where the port's kernels
take their plain versions.

* ``attention_decode``: the cases of ``tests/test_attention_decode.py`` run
  on both packages (a linear cache, a ring of the window's span that wraps,
  a window shorter than the span after a wrap, a recycled lane with
  per-lane ``cache_index``): output and caches within 1e-5 at every step;
  and which route each case takes to ``ops.flash_attention``.
* ``decode_step`` on reduced qwen3-4b against JAX ``decode_step`` (logits
  within 1e-4 at every step) and against the port's own ``lm_forward``
  (2e-3, the tolerance of ``tests/test_models_numerics.py``).
* ``make_prefill_step`` against JAX ``lm_forward`` logits, reduced qwen3-4b
  and mamba2-370m, 1e-4.
* ``serve`` token-identical to JAX ``serve`` on ``tests/test_serving.py``'s
  TINY geometry with a request longer than the context, and the port's
  paged engine token-identical to the port's ``serve``.
* The CLI's ``--engine dense``, the MoE archs' NotImplementedError and the
  entry points' refusal to run without a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import serve as jax_serve
from repro.models import attention as jax_attn
from repro.models.common import ModelConfig as JaxModelConfig
from repro.models.transformer import decode_step as jax_decode_step
from repro.models.transformer import init_decode_state as jax_init_decode_state
from repro.models.transformer import init_lm as jax_init_lm
from repro.models.transformer import lm_forward as jax_lm_forward
from repro_torch.bridge import params_from_jax, tensor_from_numpy
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.launch import serve as serve_mod
from repro_torch.models import attention as attn_mod
from repro_torch.models import (decode_step, init_decode_state, init_lm,
                                lm_forward)
from repro_torch.models.attention import (Attention, attention_decode,
                                          init_kv_cache)
from repro_torch.models.common import ModelConfig
from repro_torch.runtime.executor import make_prefill_step, make_serve_step
from repro_torch.serving import EngineConfig, ServeRequest, ServingEngine

torch.set_num_threads(1)

CPU = torch.device("cpu")
# tests/test_attention_decode.py's layer, in fp32 on both sides
LAYER = dict(name="t", arch_type="dense", n_layers=1, d_model=32, n_heads=4,
             n_kv_heads=2, d_ff=64, vocab_size=64)
# tests/test_serving.py's TINY model
TINY = dict(name="tiny-serve", arch_type="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol,
                               rtol=tol, err_msg=what)


# ---------------------------------------------------------------------------
# attention_decode
# ---------------------------------------------------------------------------

class Layer:
    """One attention layer on both sides from the same JAX weights, its JAX
    and port caches of span C, and numpy inputs (B, T, d)."""

    def __init__(self, B, T, C, seed):
        self.cfg_j = JaxModelConfig(**LAYER, dtype=jnp.float32)
        self.cfg_t = ModelConfig(**LAYER, dtype=torch.float32)
        p = jax_attn.init_attention(jax.random.PRNGKey(seed), self.cfg_j)
        self.p_j = p
        w = {k: tensor_from_numpy(np.asarray(v), CPU) for k, v in p.items()}
        self.p_t = Attention(w.pop("wq"), w.pop("wk"), w.pop("wv"),
                             w.pop("wo"), **w)
        self.xs = np.random.default_rng(seed).standard_normal(
            (B, T, self.cfg_t.d_model)).astype(np.float32)
        self.cache_j = jax_attn.init_kv_cache(self.cfg_j, B, C,
                                              dtype=jnp.float32)
        self.cache_t = init_kv_cache(self.cfg_t, B, C, device="cpu")

    def step(self, x, index, window=None):
        """Both packages one step on x (B,1,d); outputs and caches held
        within 1e-5.  ``index`` is an int or a (B,) numpy array."""
        out_j, self.cache_j = jax_attn.attention_decode(
            self.p_j, jnp.asarray(x), self.cache_j, jnp.asarray(index),
            self.cfg_j, window=window)
        with torch.inference_mode():
            out_t, cache = attention_decode(
                self.p_t, torch.from_numpy(np.ascontiguousarray(x)),
                self.cache_t,
                index if isinstance(index, int) else torch.from_numpy(index),
                self.cfg_t, window=window)
        assert cache is self.cache_t        # written in place
        _close(out_t, out_j, 1e-5, f"output at index {index}")
        for name in ("k", "v"):
            _close(self.cache_t[name], self.cache_j[name], 1e-5,
                   f"cache {name} at index {index}")


@pytest.mark.parametrize("B", [1, 3])
def test_attention_decode_linear_cache_matches_jax(B):
    T = 8
    layer = Layer(B, T, C=T, seed=0)
    for t in range(T):
        layer.step(layer.xs[:, t:t + 1], t)


def test_attention_decode_ring_of_the_window_matches_jax():
    """A ring of span W = window = 8 over 14 tokens: it wraps."""
    W, T = 8, 14
    layer = Layer(2, T, C=W, seed=1)
    for t in range(T):
        layer.step(layer.xs[:, t:t + 1], t, window=W)


def test_attention_decode_window_shorter_than_span_matches_jax():
    """A window of 5 over a ring of 8 for 14 tokens: causal in place before
    the wrap, the gather into position order after it."""
    layer = Layer(2, 14, C=8, seed=2)
    for t in range(14):
        layer.step(layer.xs[:, t:t + 1], t, window=5)


def test_attention_decode_recycled_lane_matches_jax():
    """Per-lane cache_index: lane 0 restarts a new stream at position 0
    while lane 1 continues (tests/test_attention_decode.py's case)."""
    T = 6
    layer = Layer(2, T, C=8, seed=3)
    for t in range(T):
        layer.step(layer.xs[:, t:t + 1], t)
    ys = np.random.default_rng(9).standard_normal(
        (1, 4, layer.cfg_t.d_model)).astype(np.float32)
    idx = np.array([0, T], np.int32)
    for t in range(4):
        x_t = np.concatenate([ys[:, t:t + 1], layer.xs[1:2, 0:1]], 0)
        layer.step(x_t, idx)
        idx = idx + 1


@pytest.mark.parametrize("window,index,route", [
    (None, 11, "in place, kv_len"),     # a wrapped linear cache
    (8, 3, "in place, kv_len"),         # a window of the span
    (5, 6, "in place, causal"),         # shorter window, no lane wrapped
    (5, 11, "gathered, causal"),        # shorter window after a wrap
])
def test_attention_decode_route_to_the_kernel(monkeypatch, window, index,
                                              route):
    """What attention_decode hands ``ops.flash_attention``: with no window
    or one at least the span, the caches themselves (no copy), non-causal,
    with a per-lane kv_len of min(index + 1, C); a shorter window reads the
    cache in place while no lane has wrapped, and a copy in position order
    only after a wrap."""
    calls = []
    real = ops.flash_attention

    def recording(q, k, v, **kw):
        calls.append((k, v, kw))
        return real(q, k, v, **kw)

    monkeypatch.setattr(attn_mod.ops, "flash_attention", recording)
    layer = Layer(2, 1, C=8, seed=4)
    layer.step(layer.xs[:, 0:1], index, window=window)
    ((k, v, kw),) = calls
    in_place = k is layer.cache_t["k"] and v is layer.cache_t["v"]
    if route == "in place, kv_len":
        assert in_place and kw["causal"] is False
        assert kw["kv_len"].tolist() == [min(index + 1, 8)] * 2
        assert kw.get("window") is None and kw.get("q_offset") is None
    elif route == "in place, causal":
        assert in_place and kw["causal"] is True
        assert kw["q_offset"].tolist() == [index] * 2
        assert kw["window"] == window and kw.get("kv_len") is None
    else:
        assert not in_place and kw["causal"] is True
        assert kw["q_offset"].tolist() == [7, 7]
        assert kw["window"] == window


def test_init_kv_cache_span_and_dtype():
    cfg = ModelConfig(**LAYER, dtype=torch.float32)
    assert init_kv_cache(cfg, 3, 20, device="cpu")["k"].shape == (3, 20, 2, 8)
    cache = init_kv_cache(cfg.with_(sliding_window=6), 3, 20,
                          dtype=torch.bfloat16, device="cpu")
    assert cache["v"].shape == (3, 6, 2, 8)
    assert cache["v"].dtype == torch.bfloat16


# ---------------------------------------------------------------------------
# decode_step and make_prefill_step on reduced models
# ---------------------------------------------------------------------------

def _bridged(arch, seed=0, **changes):
    cfg_j = jax_get_config(arch).reduced().with_(dtype=jnp.float32, **changes)
    cfg_t = get_config(arch).reduced().with_(dtype=torch.float32, **changes)
    params_j = jax_init_lm(jax.random.PRNGKey(seed), cfg_j)
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    return cfg_j, cfg_t, params_j, params_t


# (config changes, context, T): a linear cache, and a ring of the sliding
# window's span that wraps (tests/test_models_numerics.py's two cases)
DECODE_CASES = [({}, 32, 12), ({"sliding_window": 8}, 8, 20)]


@pytest.mark.parametrize("changes,context,T", DECODE_CASES,
                         ids=["linear", "window-ring"])
def test_decode_step_matches_jax(changes, context, T):
    cfg_j, cfg_t, params_j, params_t = _bridged("qwen3-4b", **changes)
    toks = np.random.default_rng(T).integers(0, cfg_t.vocab_size, (2, T),
                                             dtype=np.int32)
    state_j = jax_init_decode_state(cfg_j, 2, context)
    state_t = init_decode_state(cfg_t, 2, context, device="cpu")
    step = make_serve_step(cfg_t)
    for t in range(T):
        logits_j, state_j = jax_decode_step(params_j, state_j,
                                            jnp.asarray(toks[:, t]), cfg_j)
        logits_t, state_t = step(params_t, state_t,
                                 torch.from_numpy(toks[:, t]))
        _close(logits_t, logits_j, 1e-4, f"logits at t={t}")
        assert int(state_t["index"]) == t + 1


@pytest.mark.parametrize("changes,context,T", DECODE_CASES,
                         ids=["linear", "window-ring"])
def test_decode_step_matches_lm_forward(changes, context, T):
    cfg = get_config("qwen3-4b").reduced().with_(dtype=torch.float32,
                                                 **changes)
    params = init_lm(cfg, seed=0, device="cpu")
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (2, T)))
    with torch.no_grad():
        full, _ = lm_forward(params, toks, cfg)
        state = init_decode_state(cfg, 2, context, device="cpu")
        for t in range(T):
            logits, state = decode_step(params, state, toks[:, t], cfg)
            _close(logits, full[:, t], 2e-3, f"t={t}")


@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-370m"])
def test_make_prefill_step_matches_jax_lm_forward(arch):
    cfg_j, cfg_t, params_j, params_t = _bridged(arch, seed=1)
    toks = np.random.default_rng(1).integers(0, cfg_t.vocab_size, (2, 32),
                                             dtype=np.int32)
    want, _ = jax_lm_forward(params_j, jnp.asarray(toks), cfg_j)
    got = make_prefill_step(cfg_t)(params_t,
                                   {"tokens": torch.from_numpy(toks)})
    assert got.shape == (2, 32, cfg_t.vocab_size)
    _close(got, want, 1e-4)


# ---------------------------------------------------------------------------
# serve
# ---------------------------------------------------------------------------

def _tiny_requests():
    """tests/test_serving.py's 7 mixed requests, as (prompt, max_new)."""
    rng = np.random.default_rng(0)
    out = []
    for _ in range(7):
        plen = int(rng.integers(1, 11))
        prompt = rng.integers(0, TINY["vocab_size"], size=plen).tolist()
        out.append((prompt, int(rng.integers(2, 8))))
    return out


def _tiny_bridged():
    """TINY in fp32 with the weights JAX ``serve`` draws from seed 0."""
    cfg_j = JaxModelConfig(**TINY, dtype=jnp.float32)
    cfg_t = ModelConfig(**TINY, dtype=torch.float32)
    params_j = jax.jit(lambda k: jax_init_lm(k, cfg_j))(jax.random.PRNGKey(0))
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    return cfg_j, cfg_t, params_t


def test_serve_token_identical_to_jax_serve():
    """Batch 3, context 24, slot recycling, and an eighth request whose
    prompt plus max_new (20 + 10) passes the context: its cache wraps."""
    cfg_j, cfg_t, params_t = _tiny_bridged()
    spec = _tiny_requests()
    spec.append((np.random.default_rng(1).integers(
        0, TINY["vocab_size"], 20).tolist(), 10))
    reqs_j = [JaxRequest(i, list(p), n) for i, (p, n) in enumerate(spec)]
    reqs_t = [serve_mod.Request(i, list(p), n)
              for i, (p, n) in enumerate(spec)]
    jax_serve(cfg_j, reqs_j, batch=3, context=24, seed=0, verbose=False)
    out = serve_mod.serve(cfg_t, reqs_t, batch=3, context=24, seed=0,
                          verbose=False, device="cpu", params=params_t)
    assert out is reqs_t
    for rj, rt in zip(reqs_j, reqs_t):
        assert rt.generated == rj.generated, f"request {rj.rid}"
        assert rt.done and len(rt.generated) == rt.max_new


def test_paged_engine_token_identical_to_dense_serve():
    """The port's two engines on the same weights and the 7 TINY requests
    (the paged engine refuses a request longer than its context, so none
    wraps): tests/test_serving.py's differential, inside the port."""
    _, cfg_t, params_t = _tiny_bridged()
    spec = _tiny_requests()
    dense = [serve_mod.Request(i, list(p), n) for i, (p, n) in enumerate(spec)]
    serve_mod.serve(cfg_t, dense, batch=3, context=24, verbose=False,
                    device="cpu", params=params_t)
    paged = [ServeRequest(rid=str(i), prompt=list(p), max_new=n)
             for i, (p, n) in enumerate(spec)]
    ServingEngine(cfg_t, params_t, EngineConfig(
        page_size=4, n_pages=24, decode_slots=3, max_context=24,
        prefill_batch=2, prefill_chunk=4), device="cpu").run(paged)
    for rd, rp in zip(dense, paged):
        assert rp.tokens == rd.generated, f"request {rd.rid}"


def test_serve_samples_from_a_seeded_generator():
    _, cfg_t, params_t = _tiny_bridged()
    runs = []
    for _ in range(2):
        reqs = [serve_mod.Request(i, list(p), n)
                for i, (p, n) in enumerate(_tiny_requests())]
        serve_mod.serve(cfg_t, reqs, batch=3, context=24, greedy=False,
                        seed=5, verbose=False, device="cpu", params=params_t)
        runs.append([r.generated for r in reqs])
    assert runs[0] == runs[1]
    assert all(0 <= t < TINY["vocab_size"] for g in runs[0] for t in g)


def test_serve_cli_dense_engine_on_cpu(capsys):
    serve_mod.main(["--engine", "dense", "--device", "cpu", "--reduced",
                    "--requests", "3", "--batch", "2", "--context", "8",
                    "--max-new", "6"])
    out = capsys.readouterr().out
    assert "served 3 requests, 18 tokens" in out
    assert out.count("req ") == 3


# ---------------------------------------------------------------------------
# what the slice refuses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("entry", ["decode_step", "make_serve_step",
                                   "init_decode_state", "serve"])
def test_moe_decode_is_refused(entry):
    """The dense-cache engine's entry points raise for an MoE model, which
    the port does not build yet; decode_step is given a dense model's
    weights, so that its own check raises."""
    dense = get_config("qwen3-4b").reduced().with_(dtype=torch.float32)
    cfg = dense.with_(n_experts=4)
    call = {
        "decode_step": lambda: decode_step(
            init_lm(dense, device="cpu"),
            init_decode_state(dense, 1, 8, device="cpu"),
            torch.zeros(1, dtype=torch.int32), cfg),
        "make_serve_step": lambda: make_serve_step(cfg),
        "init_decode_state": lambda: init_decode_state(cfg, 1, 8,
                                                       device="cpu"),
        "serve": lambda: serve_mod.serve(
            cfg, [serve_mod.Request(0, [1, 2], 2)], 1, 8, verbose=False,
            device="cpu"),
    }[entry]
    with pytest.raises(NotImplementedError,
                       match=r"MoE .*\(ROADMAP.md queue 1, item 5\)"):
        call()


def test_paged_cli_refuses_an_ssm_arch_as_the_engine_does():
    with pytest.raises(NotImplementedError,
                       match="paged serving does not support"):
        serve_mod.main(["--arch", "mamba2-370m", "--device", "cpu"])


@pytest.mark.parametrize("entry", ["init_kv_cache", "init_decode_state",
                                   "serve", "cli"])
def test_entry_points_raise_without_a_card(monkeypatch, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = ModelConfig(**TINY, dtype=torch.float32)
    call = {
        "init_kv_cache": lambda: init_kv_cache(cfg, 1, 8),
        "init_decode_state": lambda: init_decode_state(cfg, 1, 8),
        "serve": lambda: serve_mod.serve(
            cfg, [serve_mod.Request(0, [1, 2], 2)], 1, 8, verbose=False),
        "cli": lambda: serve_mod.main(["--engine", "dense"]),
    }[entry]
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        call()
