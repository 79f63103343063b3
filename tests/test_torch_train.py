"""The port's training path against the JAX package's, on the CPU.

Reduced mamba2-370m in fp32: weights from JAX ``init_lm`` are bridged into
the port (``repro_torch.bridge.params_from_jax``), batches come from the same
seeded data pipeline, and both packages run forward, loss, gradients, AdamW
and whole training steps.  Inputs are numpy arrays given to both.

Tolerances: ``lm_loss`` 1e-5 relative and logits 1e-4 of their largest
magnitude; every parameter gradient within 1e-4 of its leaf's largest
magnitude (fp32, sums over the model in another order); AdamW and the
schedule 1e-6 (fp32 elementwise arithmetic); training losses 1e-4 relative
over three steps (the updated weights feed the next step).
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.data import DataConfig as JaxDataConfig
from repro.data import synthetic_lm_batches as jax_synthetic
from repro.data import text_corpus_batches as jax_text
from repro.models.transformer import init_lm as jax_init_lm
from repro.models.transformer import lm_forward as jax_lm_forward
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.optim.schedule import cosine_schedule as jax_cosine
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, synthetic_lm_batches, text_corpus_batches
from repro_torch.models import lm_forward, lm_loss
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               cosine_schedule)
from repro_torch.runtime.executor import init_train_state, make_train_step

torch.set_num_threads(1)

SEQ, BATCH = 24, 2


def _configs():
    cfg_j = jax_get_config("mamba2-370m").reduced().with_(dtype=jnp.float32)
    cfg_t = get_config("mamba2-370m").reduced().with_(dtype=torch.float32)
    return cfg_j, cfg_t


def _batch(cfg, seed=7):
    dcfg = DataConfig(seq_len=SEQ, global_batch=BATCH,
                      vocab_size=cfg.vocab_size, seed=seed)
    return next(synthetic_lm_batches(dcfg))


def _bridged(seed=0):
    cfg_j, cfg_t = _configs()
    params_j = jax_init_lm(jax.random.PRNGKey(seed), cfg_j)
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def _leaf_pairs(params_j, params_t):
    """(name, JAX leaf, port tensor) for every parameter of the model."""
    stack = params_j["stacks"][0]
    yield "embed", params_j["embed"], params_t.embed
    yield "final_norm", params_j["final_norm"], params_t.final_norm
    for i, blk in enumerate(params_t.blocks):
        yield f"blocks.{i}.ln1", stack["ln1"][i], blk.ln1
        for k, v in stack["ssm"].items():
            yield f"blocks.{i}.ssm.{k}", v[i], getattr(blk.ssm, k)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: max|diff| / max|ref| = {err:.3e} > {tol}"


def test_bridge_covers_every_ssm_leaf_and_moves_bf16_bits():
    cfg_j = jax_get_config("mamba2-370m").reduced()
    params_j = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(1),
                                                    cfg_j))
    params_t = params_from_jax(params_j, get_config("mamba2-370m").reduced(),
                               device="cpu")
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
    assert params_t.head is None          # tied embeddings


def test_lm_forward_loss_and_every_gradient_match_jax():
    cfg_j, cfg_t, params_j, params_t = _bridged()
    batch = _batch(cfg_t)
    batch_j = {k: jnp.asarray(v) for k, v in batch.items()}
    batch_t = {k: torch.from_numpy(v) for k, v in batch.items()}
    logits_j, _ = jax_lm_forward(params_j, batch_j["tokens"], cfg_j)
    logits_t, aux = lm_forward(params_t, batch_t["tokens"], cfg_t)
    assert float(aux) == 0.0
    _close(logits_t.detach().numpy(), logits_j, 1e-4, "logits")

    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, batch_j, cfg_j)))(params_j)
    loss_t = lm_loss(params_t, batch_t, cfg_t)
    leaves = list(params_t.parameters())
    grads_t = dict(zip(map(id, leaves), torch.autograd.grad(loss_t, leaves)))
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    for name, g_j, p in _leaf_pairs(grads_j, params_t):
        _close(grads_t[id(p)].numpy(), g_j, 1e-4, name)


@pytest.mark.parametrize("state_dtype", ["fp32", "bf16"])
def test_adamw_update_matches_jax(state_dtype):
    rng = np.random.default_rng(0)
    shapes = [(7, 5), (11,), (3, 4, 2)]
    params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    cfg_j = JaxAdamWConfig(lr=1e-2, state_dtype=state_dtype, grad_clip=0.5)
    cfg_t = AdamWConfig(lr=1e-2, state_dtype=state_dtype, grad_clip=0.5)
    p_j = [jnp.asarray(p) for p in params]
    p_t = [torch.from_numpy(p.copy()) for p in params]
    s_j, s_t = jax_adamw_init(p_j, cfg_j), adamw_init(p_t, cfg_t)
    for step in range(3):
        grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        p_j, s_j, m_j = jax_adamw_update(p_j, [jnp.asarray(g) for g in grads],
                                         s_j, cfg_j, lr_scale=0.5)
        m_t = adamw_update(p_t, [torch.from_numpy(g) for g in grads], s_t,
                           cfg_t, lr_scale=0.5)
        assert float(m_t["grad_norm"]) == pytest.approx(
            float(m_j["grad_norm"]), rel=1e-6)
        assert float(m_t["lr"]) == pytest.approx(float(m_j["lr"]), rel=1e-6)
        assert s_t["step"] == int(s_j["step"]) == step + 1
        for key in ("master", "m", "v"):
            for a, b in zip(s_t[key], s_j[key]):
                assert str(a.dtype).endswith(
                    "bfloat16" if key != "master" and state_dtype == "bf16"
                    else "float32")
                np.testing.assert_allclose(a.float().numpy(),
                                           np.asarray(b, np.float32),
                                           atol=1e-6, rtol=0)
        for a, b in zip(p_t, p_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6,
                                       rtol=0)


def test_cosine_schedule_matches_jax():
    for step in [0, 1, 5, 9, 10, 11, 50, 99, 100, 150]:
        assert cosine_schedule(step, 10, 100) == pytest.approx(
            float(jax_cosine(step, 10, 100)), abs=1e-6)
        assert cosine_schedule(step, 0, 1, min_ratio=0.0) == pytest.approx(
            float(jax_cosine(step, 0, 1, min_ratio=0.0)), abs=1e-6)


def test_data_batches_identical_to_jax(tmp_path):
    kw = dict(seq_len=16, global_batch=3, vocab_size=300, seed=11)
    corpus = tmp_path / "corpus.txt"
    corpus.write_bytes(bytes(range(256)) * 7)
    for port, ref in ((synthetic_lm_batches(DataConfig(**kw)),
                       jax_synthetic(JaxDataConfig(**kw))),
                      (text_corpus_batches(corpus, DataConfig(**kw)),
                       jax_text(corpus, JaxDataConfig(**kw)))):
        for _ in range(4):
            a, b = next(port), next(ref)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                assert a[k].tobytes() == b[k].tobytes()


def test_three_train_steps_follow_the_jax_step():
    cfg_j, cfg_t, params_j, params_t = _bridged(seed=2)
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
    gen = synthetic_lm_batches(DataConfig(seq_len=SEQ, global_batch=BATCH,
                                          vocab_size=cfg_t.vocab_size))
    losses = []
    for _ in range(3):
        batch = next(gen)
        params_j, opt_j, m_j = jax_step(
            params_j, opt_j, {k: jnp.asarray(v) for k, v in batch.items()})
        m_t = step(params_t, opt_t,
                   {k: torch.from_numpy(v) for k, v in batch.items()})
        assert set(m_t) == {"loss", "grad_norm", "lr"}
        assert float(m_t["loss"]) == pytest.approx(float(m_j["loss"]),
                                                   rel=1e-4)
        assert float(m_t["grad_norm"]) == pytest.approx(
            float(m_j["grad_norm"]), rel=1e-3)
        losses.append(float(m_t["loss"]))
    assert losses[-1] < losses[0]


def test_train_cli_runs_on_cpu_and_loss_falls(capsys):
    from repro_torch.launch.train import main
    hist = main(["--device", "cpu", "--reduced", "--arch", "mamba2-370m",
                 "--steps", "6", "--batch", "2", "--seq", "32",
                 "--log-every", "3", "--lr", "3e-3"])
    out = capsys.readouterr().out
    assert len(hist) == 6 and all(np.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert "step     3  loss=" in out and "gnorm=" in out and "tok/s=" in out
    assert out.strip().endswith("done.")


def test_train_cli_defaults_to_the_reference_arch():
    """The reference's ``launch/train.py`` defaults to qwen3-4b."""
    from repro_torch.launch.train import parse_args
    assert parse_args([]).arch == "qwen3-4b"


def test_train_needs_a_card_unless_told_cpu():
    from repro_torch.launch.train import main
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        main(["--reduced", "--steps", "1"])


@pytest.mark.parametrize("arch", ["qwen3-4b"])
def test_training_an_attention_arch_raises_naming_the_kernel(arch):
    """Dense attention archs train now (``test_torch_dense_train.py``), and
    their MoE variants (below) and the hybrid (``test_torch_hybrid.py``);
    the VLM variant, which raised before the VLM slice, trains too
    (``test_torch_vlm.py``): ``make_train_step`` and ``init_train_state``
    accept it, the model holds a projector of w1 (d_vision, d), b1 (d,),
    w2 (d, d), b2 (d,), and a step on a batch with patches moves it."""
    base = get_config(arch).reduced().with_(dtype=torch.float32)
    cfg = base.with_(arch_type="vlm", vision_tokens=4, d_vision=96)
    step = make_train_step(cfg)
    params, opt = init_train_state(cfg, device="cpu")
    d = cfg.d_model
    assert {n: tuple(p.shape) for n, p in params.named_parameters()
            if n.startswith("projector.")} == {
        "projector.w1": (96, d), "projector.b1": (d,),
        "projector.w2": (d, d), "projector.b2": (d,)}
    rng = np.random.default_rng(0)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 9)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "patches": torch.from_numpy(rng.standard_normal(
                 (2, 4, 96)).astype(np.float32))}
    w1 = params.projector.w1.detach().clone()
    metrics = step(params, opt, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert not torch.equal(params.projector.w1.detach(), w1)


@pytest.mark.parametrize("arch", ["qwen3-4b"])
def test_training_the_moe_variant_of_an_attention_arch_matches_jax(arch):
    """The MoE variant of ``arch`` (4 experts, top-2), which raised before
    the MoE slice: ``init_train_state`` builds it, and two steps of
    ``make_train_step`` on weights bridged from JAX follow the JAX step
    (loss and gradient norm within 1e-4 relative, the aux loss included)."""
    cfg_j = jax_get_config(arch).reduced().with_(
        n_experts=4, top_k=2, dtype=jnp.float32)
    cfg_t = get_config(arch).reduced().with_(n_experts=4, top_k=2,
                                             dtype=torch.float32)
    params, opt = init_train_state(cfg_t, device="cpu")
    assert all(type(b).__name__ == "MoEBlock" for b in params.blocks)
    params_j = jax_init_lm(jax.random.PRNGKey(0), cfg_j)
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    opt_j_cfg, opt_t_cfg = JaxAdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)

    @jax.jit
    def jax_step(p, o, batch):
        loss, grads = jax.value_and_grad(
            lambda q: jax_lm_loss(q, batch, cfg_j))(p)
        p, o, metrics = jax_adamw_update(p, grads, o, opt_j_cfg)
        metrics["loss"] = loss
        return p, o, metrics

    opt_j = jax_adamw_init(params_j, opt_j_cfg)
    opt_t = adamw_init(list(params_t.parameters()), opt_t_cfg)
    step = make_train_step(cfg_t, opt_t_cfg)
    gen = synthetic_lm_batches(DataConfig(seq_len=16, global_batch=2,
                                          vocab_size=cfg_t.vocab_size))
    for _ in range(2):
        b = next(gen)
        params_j, opt_j, m_j = jax_step(
            params_j, opt_j, {k: jnp.asarray(v) for k, v in b.items()})
        m_t = step(params_t, opt_t, {k: torch.from_numpy(v)
                                     for k, v in b.items()})
        assert float(m_t["loss"]) == pytest.approx(float(m_j["loss"]),
                                                   rel=1e-4)
        assert float(m_t["grad_norm"]) == pytest.approx(
            float(m_j["grad_norm"]), rel=1e-4)


# ---------------------------------------------------------------------------
# train --plan / --plan-out / --strict (the JAX driver's plan flags)
# ---------------------------------------------------------------------------

def _plan_file(path, n_layers, ckpt_first, version=None):
    """A one-device plan for ``n_layers`` plus embed and head, whose first
    strategy's ``ckpt`` is ``ckpt_first`` and the others' its opposite;
    trimmed to ``version`` 0 (no format stamp, no schedule) when asked."""
    from repro_torch.core import ParallelPlan, Strategy
    n = n_layers + 2
    strategies = ([Strategy((), ckpt=ckpt_first)]
                  + [Strategy((), ckpt=not ckpt_first)] * (n - 1))
    d = ParallelPlan(n_devices=1, pp_degree=1, partition=[n],
                     strategies=strategies, global_batch=2, n_micro=1
                     ).to_json()
    if version == 0:
        for k in ("format_version", "schedule", "vpp_degree",
                  "est_iter_time", "est_throughput", "est_stage_mem",
                  "alpha_t", "alpha_m", "searched_by", "search_stats"):
            d.pop(k, None)
    path.write_text(json.dumps(d))
    return str(path)


def _plan_cli_run(cfg, argv):
    """``launch/train.py::train`` with ``argv``; returns its losses and the
    ``remat_segments`` it gave ``make_train_step``."""
    from repro_torch.launch import train as train_cli
    seen = []
    real = train_cli.make_train_step

    def spy(cfg, opt_cfg=None, *, remat_segments=None):
        seen.append(remat_segments)
        return real(cfg, opt_cfg, remat_segments=remat_segments)

    train_cli.make_train_step = spy
    try:
        hist = train_cli.train(cfg, train_cli.parse_args(argv))
    finally:
        train_cli.make_train_step = real
    assert len(seen) == 1
    return [h["loss"] for h in hist], seen[0]


@pytest.mark.parametrize("ckpt_first", [True, False])
@pytest.mark.parametrize("arch", ["qwen3-4b", "mamba2-370m"])
def test_train_plan_takes_remat_as_the_reference_and_trains_alike(
        arch, ckpt_first, tmp_path, capsys):
    """``--plan``: the plan is verified on load, ``remat_segments`` is the
    reference driver's ``[s.ckpt for s in plan.strategies[:1]]`` (the
    embed layer's), and the losses equal ``make_train_step`` with that
    ``remat_segments`` on the same weights and batches (fp32, the same
    arithmetic: equal bits)."""
    from repro.analysis import load_plan_file as jax_load_plan_file
    cfg = get_config(arch).reduced().with_(dtype=torch.float32)
    path = _plan_file(tmp_path / "p.plan.json", cfg.n_layers, ckpt_first)
    argv = ["--arch", arch, "--reduced", "--device", "cpu", "--steps", "2",
            "--batch", "2", "--seq", "16", "--lr", "1e-3", "--plan", path]
    losses, remat = _plan_cli_run(cfg, argv)
    ref_plan, _ = jax_load_plan_file(path)
    assert remat == [s.ckpt for s in ref_plan.strategies[:1]] == [ckpt_first]
    out = capsys.readouterr().out
    assert f"loaded plan {path} (verified: 0 warning(s))" in out
    assert f"remat_segments=[{ckpt_first}]" in out

    opt_cfg = AdamWConfig(lr=1e-3)
    params, opt = init_train_state(cfg, seed=0, opt_cfg=opt_cfg,
                                   device="cpu")
    step = make_train_step(cfg, opt_cfg, remat_segments=[ckpt_first])
    gen = synthetic_lm_batches(DataConfig(seq_len=16, global_batch=2,
                                          vocab_size=cfg.vocab_size))
    want = [float(step(params, opt, {k: torch.from_numpy(v)
                                     for k, v in next(gen).items()})["loss"])
            for _ in range(2)]
    assert losses == want


def test_train_plan_out_round_trips(tmp_path, capsys):
    """A searched plan written by ``--plan-out`` loads back through
    ``--plan`` to the same plan and the same bytes."""
    from repro_torch.core import ParallelPlan
    cfg = get_config("mamba2-370m").reduced().with_(dtype=torch.float32)
    base = ["--arch", "mamba2-370m", "--reduced", "--device", "cpu",
            "--steps", "1", "--batch", "2", "--seq", "16"]
    first, second = tmp_path / "first.json", tmp_path / "second.json"
    losses_a, remat_a = _plan_cli_run(cfg, base + ["--plan-out", str(first)])
    losses_b, remat_b = _plan_cli_run(
        cfg, base + ["--plan", str(first), "--plan-out", str(second)])
    assert second.read_text() == first.read_text()
    plan = ParallelPlan.loads(first.read_text())
    assert plan.n_devices == 64 and plan.searched_by
    assert (losses_b, remat_b) == (losses_a, remat_a)
    assert remat_a == [plan.strategies[0].ckpt]
    assert capsys.readouterr().out.count("plan: " + plan.summary()) == 2


def test_train_strict_rejects_a_v0_plan_with_pln001_as_the_reference(
        tmp_path, capsys):
    from repro.analysis import DiagnosticError as JaxDiagnosticError
    from repro.analysis import load_plan_file as jax_load_plan_file
    from repro_torch.analysis import DiagnosticError
    from repro_torch.launch.train import main
    cfg = get_config("mamba2-370m").reduced()
    path = _plan_file(tmp_path / "v0.plan.json", cfg.n_layers, False,
                      version=0)
    argv = ["--arch", "mamba2-370m", "--reduced", "--device", "cpu",
            "--steps", "1", "--batch", "2", "--seq", "16", "--plan", path]
    with pytest.raises(DiagnosticError) as ei:
        main(argv + ["--strict"])
    with pytest.raises(JaxDiagnosticError) as ej:
        jax_load_plan_file(path, strict=True)
    assert ei.value.rules() == ej.value.rules() == ["PLN001"]
    assert str(ei.value) == str(ej.value)
    # without --strict the v0 plan loads with its deprecation warning
    assert len(main(argv)) == 1
    out = capsys.readouterr().out
    assert "warning[PLN001]" in out and "(verified: 1 warning(s))" in out
