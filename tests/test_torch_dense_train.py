"""The port's dense training path against the JAX package's, on the CPU.

Reduced qwen3-4b in fp32 (2 layers, d 256, 4/4 heads of 64, QK-norm,
untied head): weights from JAX ``init_lm`` are bridged into the port
(``repro_torch.bridge.params_from_jax``), batches come from the same seeded
data pipeline, and both packages run the loss, every gradient and whole
training steps.  Both take the plain attention their ``impl="auto"`` picks
on the CPU: ``ref`` below 1024 tokens, ``chunked`` from 1024.  Also here:
remat against none, the train CLI on a dense arch, and fault F2 (a window
longer than the sequence on the full-sequence ``impl="flash"`` path).

Tolerances, as ``test_torch_train.py``'s: ``lm_loss`` 1e-5 relative; every
parameter gradient within 1e-4 of its leaf's largest magnitude (fp32, sums
over the model in another order); training losses 1e-4 relative over three
steps; the attention layer's output within 1e-5 of its largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.attention import attention as jax_attention
from repro.models.transformer import init_lm as jax_init_lm
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, synthetic_lm_batches
from repro_torch.models import lm_loss
from repro_torch.models.attention import attention
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.executor import make_train_step

torch.set_num_threads(1)


def _bridged(seed=0, **changes):
    cfg_j = jax_get_config("qwen3-4b").reduced().with_(dtype=jnp.float32,
                                                        **changes)
    cfg_t = get_config("qwen3-4b").reduced().with_(dtype=torch.float32,
                                                   **changes)
    params_j = jax_init_lm(jax.random.PRNGKey(seed), cfg_j)
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def _leaf_pairs(params_j, params_t):
    """(name, JAX leaf, port tensor) for every parameter of the model."""
    stack = params_j["stacks"][0]
    yield "embed", params_j["embed"], params_t.embed
    yield "final_norm", params_j["final_norm"], params_t.final_norm
    yield "head", params_j["head"], params_t.head
    for i, blk in enumerate(params_t.blocks):
        yield f"blocks.{i}.ln1", stack["ln1"][i], blk.ln1
        yield f"blocks.{i}.ln2", stack["ln2"][i], blk.ln2
        for k, v in stack["attn"].items():
            yield f"blocks.{i}.attn.{k}", v[i], getattr(blk.attn, k)
        for k, v in stack["mlp"].items():
            yield f"blocks.{i}.mlp.{k}", v[i], getattr(blk.mlp, k)


def _close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: max|diff| / max|ref| = {err:.3e} > {tol}"


def _batch(cfg, seq, batch, seed=7):
    dcfg = DataConfig(seq_len=seq, global_batch=batch,
                      vocab_size=cfg.vocab_size, seed=seed)
    return next(synthetic_lm_batches(dcfg))


def _grads(params_t, batch_t, cfg_t, remat_segments=None):
    loss = lm_loss(params_t, batch_t, cfg_t, remat_segments=remat_segments)
    leaves = list(params_t.parameters())
    return loss, dict(zip(map(id, leaves), torch.autograd.grad(loss, leaves)))


@pytest.mark.parametrize("seq,batch,window", [
    (24, 2, None),          # both packages' "ref" attention
    (24, 2, 16),            # the config's sliding window, shorter than S
    (1024, 1, None),        # both packages' "chunked" attention
], ids=["S24", "S24-window16", "S1024"])
def test_dense_lm_loss_and_every_gradient_match_jax(seq, batch, window):
    cfg_j, cfg_t, params_j, params_t = _bridged(sliding_window=window)
    assert cfg_t.sliding_window == window and cfg_t.head_dim == 64
    b = _batch(cfg_t, seq, batch)
    batch_j = {k: jnp.asarray(v) for k, v in b.items()}
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, batch_j, cfg_j)))(params_j)
    loss_t, grads_t = _grads(params_t, {k: torch.from_numpy(v)
                                        for k, v in b.items()}, cfg_t)
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    pairs = list(_leaf_pairs(grads_j, params_t))
    assert len(pairs) == len(grads_t) == 3 + 11 * cfg_t.n_layers
    for name, g_j, p in pairs:
        _close(grads_t[id(p)].numpy(), g_j, 1e-4, name)


def test_remat_gives_the_same_loss_and_gradients():
    _, cfg_t, _, params_t = _bridged(seed=1)
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg_t, 24, 2).items()}
    loss, grads = _grads(params_t, b, cfg_t)
    loss_r, grads_r = _grads(params_t, b, cfg_t, remat_segments=[True])
    assert torch.equal(loss, loss_r)
    for key, g in grads.items():
        assert torch.equal(g, grads_r[key])


def test_three_dense_train_steps_follow_the_jax_step():
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
    step = make_train_step(cfg_t, opt_t_cfg, remat_segments=[True])
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


def test_train_cli_trains_a_dense_arch_on_cpu(capsys):
    from repro_torch.launch.train import main
    hist = main(["--device", "cpu", "--reduced", "--arch", "qwen3-4b",
                 "--steps", "3", "--batch", "2", "--seq", "32",
                 "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert "model: qwen3-4b" in out and out.strip().endswith("done.")


@pytest.mark.parametrize("window", [8, 32])
def test_flash_impl_takes_a_window_longer_than_the_sequence(window):
    """F2: ``attention(impl="flash")`` over S = 24 tokens with windows 8 and
    32 against JAX ``attention(impl="auto")`` on the bridged layer; the
    kernel refuses a window longer than its keys, so the layer passes None
    for a window of at least S."""
    cfg_j, cfg_t, params_j, params_t = _bridged(seed=3)
    seq = 24
    x = np.random.default_rng(window).standard_normal(
        (2, seq, cfg_t.d_model), np.float32)
    pos = np.broadcast_to(np.arange(seq), (2, seq))
    layer_j = jax.tree.map(lambda a: a[0], params_j["stacks"][0]["attn"])
    want = jax_attention(layer_j, jnp.asarray(x), jnp.asarray(pos), cfg_j,
                         causal=True, window=window, impl="auto")
    with torch.no_grad():
        got = attention(params_t.blocks[0].attn, torch.from_numpy(x),
                        torch.from_numpy(pos.copy()), cfg_t, causal=True,
                        window=window, impl="flash")
    _close(got.numpy(), want, 1e-5, f"attention, window {window}")
