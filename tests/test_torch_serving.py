"""The port's serving stack against the JAX package's.

* ``PageManager``: one seeded sequence of admit / ensure / advance / free on
  both sides, with exact equality of the four state arrays and of every
  ``ok`` after each operation.
* ``ServingEngine``: the port's engine on weights bridged from JAX (fp32)
  against JAX ``serve_paged`` with ``tests/test_serving.py``'s geometry and
  request mix: identical greedy tokens and identical completed / new-token
  / decode-step / prefill-chunk counts.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models.common import ModelConfig as JaxModelConfig
from repro.models.transformer import init_lm as jax_init_lm
from repro.serving.page_table import PageManager as JaxPageManager
from repro_torch.bridge import params_from_jax
from repro_torch.models.common import ModelConfig
from repro_torch.serving import (EngineConfig, PageManager, ServeRequest,
                                 ServingEngine)

torch.set_num_threads(1)

TINY = dict(name="tiny-serve", arch_type="dense", n_layers=2, d_model=32,
            n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=128)


def _assert_same_state(sj, st, what):
    for name, a, b in zip(sj._fields, sj, st):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a),
                                      err_msg=f"{name} after {what}")


@pytest.mark.parametrize("seed", [0, 1])
def test_page_manager_matches_jax(seed):
    geo = dict(n_pages=10, n_slots=4, page_size=4, pages_per_slot=5)
    pj, pt = JaxPageManager(**geo), PageManager(**geo, device="cpu")
    sj, st = pj.init(), pt.init()
    _assert_same_state(sj, st, "init")
    rng = np.random.default_rng(seed)
    for i in range(40):
        op = rng.choice(["admit", "ensure", "advance", "free"],
                        p=[0.3, 0.3, 0.25, 0.15])
        if op == "admit":
            slot, plen = int(rng.integers(0, 4)), int(rng.integers(1, 14))
            sj, okj = pj.admit(sj, slot, plen)
            st, okt = pt.admit(st, slot, plen)
        elif op == "ensure":
            want = rng.random(4) < 0.7
            sj, okj = pj.ensure_append_capacity(sj, jnp.asarray(want))
            st, okt = pt.ensure_append_capacity(st, torch.from_numpy(want))
        elif op == "advance":
            stepped = rng.random(4) < 0.6
            sj = pj.advance(sj, jnp.asarray(stepped) & sj.active)
            st = pt.advance(st, torch.from_numpy(stepped) & st.active)
            okj = okt = None
        else:
            slot = int(rng.integers(0, 4))
            sj, st = pj.free_slot(sj, slot), pt.free_slot(st, slot)
            okj = okt = None
        if okj is not None:
            np.testing.assert_array_equal(okt.numpy(), np.asarray(okj),
                                          err_msg=f"ok of {op} at step {i}")
        _assert_same_state(sj, st, f"{op} at step {i}")
        assert int(pt.free_pages(st)) == int(pj.free_pages(sj))
        assert float(pt.occupancy(st)) == pytest.approx(
            float(pj.occupancy(sj)))


def test_serving_engine_token_identical_to_jax_serve_paged():
    """Mixed-length prompts, more requests than lanes (slot recycling),
    ragged max_new — the request mix of tests/test_serving.py."""
    from repro.launch.serve import serve_paged as jax_serve_paged
    from repro.serving import EngineConfig as JaxEngineConfig
    from test_serving import _mixed_requests

    cfg_j = JaxModelConfig(**TINY, dtype=jnp.float32)
    cfg_t = ModelConfig(**TINY, dtype=torch.float32)
    geo = dict(page_size=4, n_pages=24, decode_slots=3, max_context=24,
               prefill_batch=2, prefill_chunk=4)
    reqs_j = _mixed_requests(np.random.default_rng(0), 7)
    metrics_j = jax_serve_paged(cfg_j, reqs_j, JaxEngineConfig(**geo),
                                seed=0, verbose=False)

    # serve_paged's weights: init_lm under jit with PRNGKey(seed)
    params_j = jax.jit(lambda k: jax_init_lm(k, cfg_j))(jax.random.PRNGKey(0))
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    engine = ServingEngine(cfg_t, params_t, EngineConfig(**geo),
                           device="cpu")
    reqs_t = [ServeRequest(rid=str(r.rid), prompt=list(r.prompt),
                           max_new=r.max_new) for r in reqs_j]
    metrics_t = engine.run(reqs_t)

    for rj, rt in zip(reqs_j, reqs_t):
        assert rt.tokens == rj.generated, f"request {rj.rid}"
        assert rt.done and len(rt.tokens) == rt.max_new
    sj, st = metrics_j.summary(), metrics_t.summary()
    for key in ("requests", "completed", "new_tokens", "decode_steps",
                "prefill_chunks"):
        assert st[key] == sj[key], key
    assert metrics_t.page_occupancy == pytest.approx(metrics_j.page_occupancy)


def test_engine_rejects_oversized_prompt_and_wrong_device():
    cfg = ModelConfig(**TINY, dtype=torch.float32)
    from repro_torch.models import init_lm
    params = init_lm(cfg, seed=0, device="cpu")
    ecfg = EngineConfig(page_size=4, n_pages=8, decode_slots=2,
                        max_context=8, prefill_batch=2, prefill_chunk=4)
    engine = ServingEngine(cfg, params, ecfg, device="cpu")
    with pytest.raises(ValueError, match="exceeds max_context"):
        engine.run([ServeRequest(rid="big", prompt=list(range(9)),
                                 max_new=2)])
    with pytest.raises(ValueError, match="max_context"):
        EngineConfig(page_size=4, max_context=10)
    with pytest.raises(ValueError, match="engine runs on"):
        ServingEngine(cfg, params, ecfg, device="meta")
    with pytest.raises(NotImplementedError):
        ServingEngine(dataclasses.replace(cfg, arch_type="ssm"), params,
                      ecfg, device="cpu")


def test_serve_cli_runs_on_cpu_when_asked(capsys):
    from repro_torch.launch.serve import main

    main(["--device", "cpu", "--requests", "5", "--max-new", "3",
          "--batch", "2", "--context", "20", "--page-size", "8"])
    out = capsys.readouterr().out
    assert "served 5 requests, 15 tokens" in out


# ---------------------------------------------------------------------------
# serve --plan: the engine's geometry from a searched v3 plan
# ---------------------------------------------------------------------------

SLO_PLAN = str(pathlib.Path(__file__).resolve().parent.parent / "examples"
               / "plans" / "bert-huge-32_8dev_slo30ms.plan.json")
NO_SERVING_PLAN = SLO_PLAN.replace("slo30ms", "12gb")
FLAG_SETS = {
    "plan-only": {},
    "batch": {"batch": 2},
    "context-batch": {"context": 60, "batch": 3},
    "above-plan": {"context": 4096, "batch": 1024},
    "pages-chunk-page-size": {"page_size": 16, "pages": 100,
                              "prefill_chunk": 8, "eos_id": 3},
}


def _serve_args(plan=SLO_PLAN, **flags):
    import argparse
    args = dict(plan=plan, page_size=0, pages=0, batch=0, context=0,
                prefill_chunk=0, eos_id=None)
    args.update(flags)
    return argparse.Namespace(**args)


@pytest.mark.parametrize("plan", [SLO_PLAN, None], ids=["plan", "no-plan"])
@pytest.mark.parametrize("flags", sorted(FLAG_SETS))
def test_engine_config_from_args_resolves_the_reference_fields(flags, plan):
    """Flags override the plan's fields where set, as in the reference."""
    from repro.launch.serve import engine_config_from_args as jax_resolve
    from repro_torch.launch.serve import engine_config_from_args
    args = _serve_args(plan=plan, **FLAG_SETS[flags])
    want = dataclasses.asdict(jax_resolve(args, None))
    assert dataclasses.asdict(engine_config_from_args(args)) == want


def test_serve_plan_without_a_serving_section_exits_as_the_reference():
    from repro.launch.serve import engine_config_from_args as jax_resolve
    from repro_torch.launch.serve import engine_config_from_args
    args = _serve_args(plan=NO_SERVING_PLAN)
    with pytest.raises(SystemExit) as ej:
        jax_resolve(args, None)
    with pytest.raises(SystemExit) as et:
        engine_config_from_args(args)
    assert str(et.value) == str(ej.value)
    assert "plan has no serving section" in str(et.value)


def test_serve_plan_geometry_token_identical_to_jax_serve_paged():
    """Reduced fp32 qwen3-4b on the plan's geometry (page size 8, its
    pool of 8448 pages and prefill chunk of 512; 3 lanes and a context of
    64 from the flags), bridged weights: the port's engine gives JAX
    ``serve_paged``'s tokens and counts."""
    from repro.configs import get_config as jax_get_config
    from repro.launch.serve import engine_config_from_args as jax_resolve
    from repro.launch.serve import serve_paged as jax_serve_paged
    from repro.serving import EngineConfig as JaxEngineConfig
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import engine_config_from_args
    from test_serving import _mixed_requests

    args = _serve_args(batch=3, context=64)
    ecfg = engine_config_from_args(args)
    assert (ecfg.page_size, ecfg.n_pages, ecfg.prefill_chunk,
            ecfg.decode_slots, ecfg.max_context) == (8, 8448, 512, 3, 64)
    cfg_j = jax_get_config("qwen3-4b").reduced().with_(dtype=jnp.float32)
    cfg_t = get_config("qwen3-4b").reduced().with_(dtype=torch.float32)
    reqs_j = _mixed_requests(np.random.default_rng(1), 5, max_len=20)
    metrics_j = jax_serve_paged(
        cfg_j, reqs_j, JaxEngineConfig(**dataclasses.asdict(
            jax_resolve(args, cfg_j))), seed=0, verbose=False)

    params_j = jax.jit(lambda k: jax_init_lm(k, cfg_j))(jax.random.PRNGKey(0))
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    reqs_t = [ServeRequest(rid=str(r.rid), prompt=list(r.prompt),
                           max_new=r.max_new) for r in reqs_j]
    metrics_t = ServingEngine(cfg_t, params_t, ecfg, device="cpu").run(reqs_t)
    for rj, rt in zip(reqs_j, reqs_t):
        assert rt.tokens == rj.generated, f"request {rj.rid}"
        assert rt.done and len(rt.tokens) == rt.max_new
    sj, st = metrics_j.summary(), metrics_t.summary()
    for key in ("requests", "completed", "new_tokens", "decode_steps",
                "prefill_chunks"):
        assert st[key] == sj[key], key


def test_serve_cli_takes_a_plan_on_cpu(capsys):
    from repro_torch.launch.serve import main
    reqs = main(["--device", "cpu", "--plan", SLO_PLAN, "--requests", "3",
                 "--max-new", "2", "--batch", "2", "--context", "16"])
    assert all(r.done and len(r.generated) == 2 for r in reqs)
    assert "served 3 requests, 6 tokens" in capsys.readouterr().out
