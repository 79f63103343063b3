"""The port's encoder-decoder training path against the JAX package's, on
the CPU.

Reduced whisper-medium (``get_config("whisper-medium").reduced()``: 2 + 2
layers, d 256, 4 heads of dh 64, 32 encoder frames) in fp32: weights from
JAX ``init_encdec`` are bridged into the port
(``repro_torch.bridge.params_from_jax``), frames, tokens and labels come
from the same seeded data pipeline, and both packages run the loss, every
gradient and whole training steps.  On the CPU every attention takes the
flash kernel's plain version (the decoder's cross-attention at S != T
included), autodiffed by torch.

Tolerances, as ``test_torch_dense_train.py``'s: ``encdec_loss`` 1e-5
relative; every parameter gradient within 1e-4 of its leaf's largest
magnitude (fp32, sums over the model in another order); training losses
1e-4 relative over three steps of JAX ``make_train_step`` on a one-device
mesh.  Also here: remat against none, the train CLI at ``--arch
whisper-medium`` with its ``frames``, checkpoints interchangeable with
JAX's both ways in bf16, bit for bit, ``--ranks 2`` taking a step, and the
pipeline's refusal (one homogeneous stack).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import restore_train_state as jax_restore
from repro.checkpointing import save_train_state as jax_save
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import batch_specs as jax_batch_specs
from repro.data.pipeline import synthetic_lm_batches as jax_batches
from repro.launch.mesh import make_local_mesh as jax_make_local_mesh
from repro.models import encdec as jax_encdec
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.runtime import executor as jax_executor
from repro.runtime.sharding import ShardPolicy as JaxShardPolicy
from repro_torch.bridge import (flat_from_leaves, params_from_jax,
                                tree_from_params)
from repro_torch.checkpointing import restore_train_state, save_train_state
from repro_torch.configs import get_config
from repro_torch.launch import train as train_cli
from repro_torch.models import EncDec, encdec_loss
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime.executor import init_train_state, make_train_step

torch.set_num_threads(1)

ARCH = "whisper-medium"
SEQ, BATCH = 24, 2


def _cfgs(dtype="float32"):
    return (jax_get_config(ARCH).reduced().with_(dtype=getattr(jnp, dtype)),
            get_config(ARCH).reduced().with_(dtype=getattr(torch, dtype)))


def _bridged(seed=0, **kw):
    cfg_j, cfg_t = _cfgs()
    params_j = jax_encdec.init_encdec(jax.random.PRNGKey(seed), cfg_j, **kw)
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def _dcfg(cfg, seed=1234):
    return JaxDataConfig(seq_len=SEQ, global_batch=BATCH,
                         vocab_size=cfg.vocab_size,
                         encoder_seq=cfg.encoder_seq, d_model=cfg.d_model,
                         seed=seed)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: max|diff| / max|ref| = {err:.3e} > {tol}"


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_encdec_loss_and_every_gradient_match_jax(remat):
    cfg_j, cfg_t, params_j, params_t = _bridged(max_dec_len=64)
    b = next(jax_batches(_dcfg(cfg_t, seed=7)))
    assert b["frames"].shape == (BATCH, cfg_t.encoder_seq, cfg_t.d_model)
    batch_j = {k: jnp.asarray(v) for k, v in b.items()}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_encdec.encdec_loss(p, batch_j, cfg_j,
                                         remat=remat)))(params_j)
    leaves = list(params_t.parameters())
    loss_t = encdec_loss(params_t, {k: torch.from_numpy(v)
                                    for k, v in b.items()}, cfg_t,
                         remat=remat)
    grads_t = torch.autograd.grad(loss_t, leaves)
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, grads_j), cfg_t,
                           device="cpu")
    named = list(want.named_parameters())
    assert len(named) == len(grads_t) == len(leaves)
    for (name, w), g in zip(named, grads_t):
        _close(g.numpy(), w.detach().numpy(), 1e-4, name)


def test_remat_gives_the_same_loss_and_gradients():
    _, cfg_t, _, params_t = _bridged(seed=1, max_dec_len=64)
    b = {k: torch.from_numpy(v)
         for k, v in next(jax_batches(_dcfg(cfg_t))).items()}
    leaves = list(params_t.parameters())
    out = []
    for remat in (False, True):
        loss = encdec_loss(params_t, b, cfg_t, remat=remat)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    (loss, grads), (loss_r, grads_r) = out
    assert torch.equal(loss, loss_r)
    for g, g_r in zip(grads, grads_r):
        assert torch.equal(g, g_r)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_three_encdec_train_steps_follow_jax_make_train_step(remat):
    """The port's ``make_train_step`` against JAX ``make_train_step`` on a
    one-device mesh, from JAX ``init_train_state``'s weights (its 4096-row
    decoder position table) bridged into the port."""
    cfg_j, cfg_t = _cfgs()
    policy = JaxShardPolicy(tp=False, zero=False,
                            remat_segments=(remat,))
    dcfg = _dcfg(cfg_t)
    ocfg_j, ocfg_t = JaxAdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)
    mesh = jax_make_local_mesh()
    with mesh:
        built = jax_executor.make_train_step(cfg_j, mesh, policy,
                                             jax_batch_specs(dcfg), ocfg_j)
        params_j, opt_j = jax_executor.init_train_state(cfg_j, mesh, policy)
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    assert params_t.dec_pos.shape[0] == 4096
    opt_t = adamw_init(list(params_t.parameters()), ocfg_t)
    step = make_train_step(cfg_t, ocfg_t, remat_segments=[remat])
    gen = jax_batches(dcfg)
    losses = []
    for _ in range(3):
        b = next(gen)
        with mesh:
            params_j, opt_j, m_j = built.fn(
                params_j, opt_j, {k: jnp.asarray(v) for k, v in b.items()})
        m_t = step(params_t, opt_t, {k: torch.from_numpy(v)
                                     for k, v in b.items()})
        assert float(m_t["loss"]) == pytest.approx(float(m_j["loss"]),
                                                   rel=1e-4)
        assert float(m_t["grad_norm"]) == pytest.approx(
            float(m_j["grad_norm"]), rel=1e-4)
        losses.append(float(m_t["loss"]))
    assert losses[-1] < losses[0]


def test_train_cli_trains_whisper_on_cpu_with_frames(monkeypatch, capsys):
    """``train --arch whisper-medium --reduced --device cpu``: its batches
    are JAX ``DataConfig``'s with ``encoder_seq`` and ``d_model`` (the
    same bytes, ``frames`` included), and every step reaches the train
    step with them."""
    args = train_cli.parse_args(["--arch", ARCH, "--reduced", "--device",
                                 "cpu", "--seq", str(SEQ), "--batch",
                                 str(BATCH)])
    cfg = train_cli.config_from_args(args)
    got = next(train_cli.batches(cfg, args))
    want = next(jax_batches(JaxDataConfig(
        seq_len=SEQ, global_batch=BATCH, vocab_size=cfg.vocab_size,
        encoder_seq=cfg.encoder_seq, d_model=cfg.d_model)))
    assert got.keys() == want.keys() == {"tokens", "labels", "frames"}
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                 want[k]), k

    seen = []
    real = train_cli.make_train_step

    def make(cfg, opt_cfg=None, *, remat_segments=None):
        step = real(cfg, opt_cfg, remat_segments=remat_segments)

        def recorded(params, opt, batch):
            seen.append((type(params), {k: tuple(v.shape)
                                        for k, v in batch.items()}))
            return step(params, opt, batch)
        return recorded

    monkeypatch.setattr(train_cli, "make_train_step", make)
    hist = train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "3", "--batch", str(BATCH), "--seq",
                           str(SEQ), "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert "model: whisper-medium" in out and out.strip().endswith("done.")
    frames = (BATCH, cfg.encoder_seq, cfg.d_model)
    assert seen == [(EncDec, {"tokens": (BATCH, SEQ), "labels": (BATCH, SEQ),
                              "frames": frames})] * 3


@pytest.mark.parametrize("argv,exc,match", [
    (["--ranks", "2", "--batch", "2", "--seq", "8"], None, None),
    (["--pipeline", "--ranks", "2"], ValueError, "one homogeneous stack"),
], ids=["ranks", "pipeline"])
def test_train_cli_refuses_sharded_and_pipelined_whisper(argv, exc, match,
                                                         monkeypatch):
    """``--pipeline`` is refused before any plan is searched or rank
    spawned (both stubbed to fail the test).  ``--ranks`` is not refused:
    it spawns its ranks and takes a sharded step on batches with
    ``frames``."""
    if exc is None:
        hist = train_cli.main(["--arch", ARCH, "--reduced", "--device",
                               "cpu", "--steps", "1", *argv])
        assert len(hist) == 1 and np.isfinite(hist[0]["loss"])
        assert hist[0]["gloo_bytes_sent"] > 0
        return

    def never(*a, **k):
        raise AssertionError("reached past the refusal")

    for name in ("plan_from_args", "_spawn"):
        monkeypatch.setattr(train_cli, name, never)
    with pytest.raises(exc, match=match):
        train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                        "--steps", "1", *argv])


def _bf16_state(seed):
    """Reduced bf16 whisper: JAX ``init_encdec`` and an AdamW state after
    one update with random gradients."""
    cfg_j, cfg_t = _cfgs("bfloat16")
    params = jax_encdec.init_encdec(jax.random.PRNGKey(seed), cfg_j,
                                    max_dec_len=64)
    ocfg = JaxAdamWConfig(lr=1e-2)
    opt = jax_adamw_init(params, ocfg)
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32), p.dtype), params)
    params, opt, _ = jax_adamw_update(params, grads, opt, ocfg)
    return cfg_j, cfg_t, params, opt


def test_jax_checkpoint_restores_into_the_port_encdec(tmp_path):
    cfg_j, cfg_t, params, opt = _bf16_state(0)
    jax_save(1, params, opt, tmp_path, extra={"arch": ARCH})
    model = params_from_jax(jax.tree.map(np.asarray, jax_encdec.init_encdec(
        jax.random.PRNGKey(5), cfg_j, max_dec_len=64)), cfg_t, device="cpu")
    state = adamw_init(list(model.parameters()))
    _, _, step = restore_train_state(model, state, tmp_path)
    assert step == 1 and state["step"] == 1
    want = params_from_jax(jax.tree.map(np.asarray, params), cfg_t,
                           device="cpu")
    for (name, p), q in zip(model.named_parameters(), want.parameters()):
        assert p.dtype == q.dtype == torch.bfloat16, name
        assert torch.equal(p.detach().view(torch.int16),
                           q.detach().view(torch.int16)), name
    for k in ("master", "m", "v"):
        ref = params_from_jax(jax.tree.map(np.asarray, opt[k]), cfg_t,
                              device="cpu")
        for t, q in zip(state[k], ref.parameters()):
            assert t.dtype == torch.float32 and torch.equal(t, q), k


def test_port_checkpoint_restores_through_jax_encdec(tmp_path):
    cfg_j, cfg_t = _cfgs("bfloat16")
    model = params_from_jax(jax.tree.map(np.asarray, jax_encdec.init_encdec(
        jax.random.PRNGKey(2), cfg_j, max_dec_len=64)), cfg_t, device="cpu")
    state = adamw_init(list(model.parameters()))
    leaves = list(model.parameters())
    rng = np.random.default_rng(1)
    grads = [torch.from_numpy(rng.standard_normal(tuple(p.shape))
                              .astype(np.float32)).to(p.dtype)
             for p in leaves]
    adamw_update(leaves, grads, state, AdamWConfig(lr=1e-2))
    save_train_state(1, model, state, tmp_path)

    tmpl = jax_encdec.init_encdec(jax.random.PRNGKey(7), cfg_j,
                                  max_dec_len=64)
    params, opt, step = jax_restore(tmpl, jax_adamw_init(tmpl), tmp_path)
    assert step == 1 and int(opt["step"]) == 1
    flat_j = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(
        tree_from_params(model))[0])
    assert flat_j.keys() == flat_t.keys()
    for k, a in flat_j.items():
        assert a.dtype == flat_t[k].dtype and np.array_equal(
            np.asarray(a).view(np.uint8), flat_t[k].view(np.uint8)), k
    for key in ("master", "m", "v"):
        want = flat_from_leaves(model, state[key])
        got = jax.tree_util.tree_flatten_with_path(opt[key])[0]
        assert len(got) == len(want)
        for path, a in got:
            k = "/".join(str(getattr(x, "key", getattr(x, "idx", x)))
                         for x in path)
            assert np.array_equal(np.asarray(a), want[k].numpy()), (key, k)


def test_save_restore_resume_repeats_an_unbroken_run(tmp_path):
    """Two steps, save, restore into a freshly drawn model, one more step:
    the same loss as three unbroken steps, bit for bit."""
    cfg = get_config(ARCH).reduced()
    gen = jax_batches(_dcfg(cfg))
    bs = [{k: torch.from_numpy(v) for k, v in next(gen).items()}
          for _ in range(3)]
    ocfg = AdamWConfig(lr=1e-3)
    step = make_train_step(cfg, ocfg)
    model, state = init_train_state(cfg, seed=0, opt_cfg=ocfg, device="cpu")
    unbroken = [float(step(model, state, b)["loss"]) for b in bs]
    model, state = init_train_state(cfg, seed=0, opt_cfg=ocfg, device="cpu")
    for b in bs[:2]:
        step(model, state, b)
    save_train_state(2, model, state, tmp_path)
    fresh, fresh_state = init_train_state(cfg, seed=3, opt_cfg=ocfg,
                                          device="cpu")
    _, _, s = restore_train_state(fresh, fresh_state, tmp_path)
    assert s == 2 and fresh_state["step"] == 2
    assert float(step(fresh, fresh_state, bs[2])["loss"]) == unbroken[2]
