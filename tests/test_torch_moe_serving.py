"""The port's MoE decoders trained and served against the JAX package's,
in fp32 on the CPU: reduced arctic-480b and kimi-k2-1t-a32b (16 experts:
top-8, a shared expert, its first layer dense) bridged from JAX
``init_lm``.

* Three ``make_train_step`` steps against the JAX step (loss and gradient
  norm within 1e-4 relative), and ``train --arch kimi-k2-1t-a32b``.
* ``decode_step`` (MoE groups of one token, where nothing drops) against
  JAX ``decode_step`` at every step (1e-5 of the largest logit, the same
  greedy token), ``make_prefill_step`` against JAX ``lm_forward``.
* ``serve`` (the dense-cache engine, recycled lanes) and the paged engine
  token-identical to JAX ``serve`` and ``serve_paged``; ``serve --arch
  arctic-480b`` on both engines.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import serve as jax_serve
from repro.launch.serve import serve_paged as jax_serve_paged
from repro.models.transformer import decode_step as jax_decode_step
from repro.models.transformer import init_decode_state as jax_init_decode_state
from repro.models.transformer import lm_forward as jax_lm_forward
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.serving import EngineConfig as JaxEngineConfig
from repro_torch.data import DataConfig, synthetic_lm_batches
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import decode_step, init_decode_state
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.executor import (make_prefill_step, make_serve_step,
                                          make_train_step)
from repro_torch.serving import EngineConfig, ServeRequest, ServingEngine
from test_torch_moe import ARCHS, _bridged, _close

torch.set_num_threads(1)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_three_train_steps_follow_the_jax_step(arch):
    cfg_j, cfg_t, params_j, params_t = _bridged(arch, seed=2)
    opt_j_cfg, opt_t_cfg = JaxAdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)

    @jax.jit
    def jax_step(params, opt, batch):
        loss, grads = jax.value_and_grad(
            lambda p: jax_lm_loss(p, batch, cfg_j))(params)
        params, opt, metrics = jax_adamw_update(params, grads, opt, opt_j_cfg)
        metrics["loss"] = loss
        return params, opt, metrics

    opt_j = jax_adamw_init(params_j, opt_j_cfg)
    opt_t = adamw_init(list(params_t.parameters()), opt_t_cfg)
    step = make_train_step(cfg_t, opt_t_cfg)
    gen = synthetic_lm_batches(DataConfig(seq_len=24, global_batch=2,
                                          vocab_size=cfg_t.vocab_size))
    losses = []
    for _ in range(3):
        b = next(gen)
        params_j, opt_j, m_j = jax_step(
            params_j, opt_j, {k: jnp.asarray(v) for k, v in b.items()})
        m_t = step(params_t, opt_t, {k: torch.from_numpy(v)
                                     for k, v in b.items()})
        assert float(m_t["loss"]) == pytest.approx(float(m_j["loss"]),
                                                   rel=1e-4)
        assert float(m_t["grad_norm"]) == pytest.approx(
            float(m_j["grad_norm"]), rel=1e-4)
        losses.append(float(m_t["loss"]))
    assert losses[-1] < losses[0]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_decode_and_prefill_steps_match_jax(arch):
    """``decode_step`` (one K/V cache a layer, MoE groups of one token)
    against JAX ``decode_step`` for 12 tokens, and ``make_prefill_step``
    against JAX ``lm_forward``."""
    cfg_j, cfg_t, params_j, params_t = _bridged(arch)
    toks = np.random.default_rng(4).integers(0, cfg_t.vocab_size, (2, 12),
                                             dtype=np.int32)
    state_j = jax_init_decode_state(cfg_j, 2, 16)
    state_t = init_decode_state(cfg_t, 2, 16, device="cpu")
    assert len(state_t["caches"]) == cfg_t.n_layers
    step = make_serve_step(cfg_t)
    jstep = jax.jit(lambda p, s, t: jax_decode_step(p, s, t, cfg_j))
    for t in range(toks.shape[1]):
        want, state_j = jstep(params_j, state_j, jnp.asarray(toks[:, t]))
        got, state_t = step(params_t, state_t, torch.from_numpy(toks[:, t]))
        _close(got, want, 1e-5, f"decode logits at {t}")
        assert (got.argmax(-1).numpy() == np.asarray(want).argmax(-1)).all()
    with torch.no_grad():
        got, _ = decode_step(params_t, init_decode_state(
            cfg_t, 2, 16, device="cpu"), torch.from_numpy(toks[:, 0]),
            cfg_t)
    assert got.shape == (2, cfg_t.vocab_size)
    want, _ = jax_lm_forward(params_j, jnp.asarray(toks), cfg_j)
    got = make_prefill_step(cfg_t)(params_t,
                                   {"tokens": torch.from_numpy(toks)})
    _close(got, want, 1e-5, "prefill")


def _requests(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, int(rng.integers(3, 13))
                          ).tolist(), int(rng.integers(3, 7)))
            for _ in range(n)]


@pytest.mark.parametrize("arch", list(ARCHS))
def test_dense_serve_token_identical_to_jax(arch):
    """The dense-cache engine with slot recycling: 5 requests on 2 lanes
    of a 24-token cache, JAX ``serve``'s weights from seed 0."""
    cfg_j, cfg_t, _, params_t = _bridged(arch)
    spec = _requests(cfg_t, 5, 5)
    reqs_j = [JaxRequest(i, list(p), n) for i, (p, n) in enumerate(spec)]
    reqs_t = [serve_mod.Request(i, list(p), n)
              for i, (p, n) in enumerate(spec)]
    jax_serve(cfg_j, reqs_j, batch=2, context=24, seed=0, verbose=False)
    serve_mod.serve(cfg_t, reqs_t, batch=2, context=24, verbose=False,
                    device="cpu", params=params_t)
    for rj, rt in zip(reqs_j, reqs_t):
        assert rt.generated == rj.generated, f"request {rj.rid}"
        assert rt.done and len(rt.generated) == rt.max_new


@pytest.mark.parametrize("arch", list(ARCHS))
def test_paged_serve_token_identical_to_jax(arch):
    """The paged engine (chunked prefill, continuous batching) against JAX
    ``serve_paged`` on its weights (``init_lm`` seed 0 under jit)."""
    cfg_j, cfg_t, _, params_t = _bridged(arch)
    geo = dict(page_size=4, n_pages=24, decode_slots=3, max_context=24,
               prefill_batch=2, prefill_chunk=4)
    spec = _requests(cfg_t, 6, 6)
    reqs_j = [JaxRequest(i, list(p), n) for i, (p, n) in enumerate(spec)]
    jax_serve_paged(cfg_j, reqs_j, JaxEngineConfig(**geo), seed=0,
                    verbose=False)
    reqs_t = [ServeRequest(rid=str(i), prompt=list(p), max_new=n)
              for i, (p, n) in enumerate(spec)]
    ServingEngine(cfg_t, params_t, EngineConfig(**geo),
                  device="cpu").run(reqs_t)
    for rj, rt in zip(reqs_j, reqs_t):
        assert rt.tokens == rj.generated, f"request {rj.rid}"
        assert rt.done


@pytest.mark.parametrize("engine", ["paged", "dense"])
def test_serve_cli_serves_a_moe_arch_on_cpu(engine, capsys):
    reqs = serve_mod.main(["--arch", "arctic-480b", "--engine", engine,
                           "--device", "cpu", "--requests", "3",
                           "--batch", "2", "--max-new", "4"])
    assert all(r.done and len(r.generated) == 4 for r in reqs)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


def test_train_cli_trains_a_moe_arch_on_cpu(capsys):
    hist = train_mod.main(["--arch", "kimi-k2-1t-a32b", "--reduced",
                           "--device", "cpu", "--steps", "3", "--batch", "2",
                           "--seq", "16", "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert "model: kimi-k2-1t-a32b" in out
