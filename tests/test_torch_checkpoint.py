"""The port's checkpoints against the JAX package's, on the CPU.

Checkpoints are interchangeable both ways: a directory written by JAX
``save_train_state`` restores into the port's model and AdamW state, and
one written by the port restores through JAX ``restore_train_state``, on
reduced qwen3-4b, mamba2-370m and zamba2-1.2b (with its shared attention
block) in bf16, bit for bit (bf16 leaves travel as float32 under
``@bf16``, which is exact).  The port's own cases mirror
``tests/test_substrates.py::test_checkpoint_roundtrip`` and
``tests/test_system.py::test_train_checkpoint_restore_resume``: k steps,
save, restore into a freshly built model, more steps, the same losses as an
unbroken run, bit for bit.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import restore_train_state as jax_restore
from repro.checkpointing import save_train_state as jax_save
from repro.configs import get_config as jax_get_config
from repro.models.transformer import init_lm as jax_init_lm
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro_torch.bridge import (flat_from_leaves, params_from_jax,
                                tree_from_params)
from repro_torch.checkpointing import (load_pytree, restore_train_state,
                                       save_pytree, save_train_state)
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, synthetic_lm_batches
from repro_torch.launch.train import main as train_main
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime.executor import init_train_state, make_train_step

torch.set_num_threads(1)

ARCHS = ["qwen3-4b", "mamba2-370m", "zamba2-1.2b"]


def _reduced(arch):
    n = 5 if arch == "zamba2-1.2b" else 2       # a shared block and a tail
    return (jax_get_config(arch).reduced(n_layers=n),
            get_config(arch).reduced(n_layers=n))


def _random_like(rng, tree):
    return jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32), p.dtype), tree)


def _same(t: torch.Tensor, a) -> bool:
    """Bit for bit, bf16 included."""
    a = np.asarray(a)
    if t.dtype == torch.bfloat16:
        return a.dtype.name == "bfloat16" and np.array_equal(
            t.detach().view(torch.int16).numpy(), a.view(np.int16))
    return a.dtype == t.detach().numpy().dtype and np.array_equal(
        t.detach().numpy(), a)


@pytest.mark.parametrize("arch", ARCHS)
def test_jax_checkpoint_restores_into_the_port(arch, tmp_path):
    cfg_j, cfg_t = _reduced(arch)
    params = jax_init_lm(jax.random.PRNGKey(0), cfg_j)
    ocfg = JaxAdamWConfig(lr=1e-2)
    opt = jax_adamw_init(params, ocfg)
    grads = _random_like(np.random.default_rng(0), params)
    params, opt, _ = jax_adamw_update(params, grads, opt, ocfg)
    jax_save(1, params, opt, tmp_path, extra={"arch": arch})

    model, state = init_train_state(cfg_t, seed=5, device="cpu")
    got_m, got_s, step = restore_train_state(model, state, tmp_path)
    assert got_m is model and got_s is state and step == 1
    assert state["step"] == 1
    want = params_from_jax(jax.tree.map(np.asarray, params), cfg_t,
                           device="cpu")
    for (name, p), q in zip(model.named_parameters(), want.parameters()):
        assert p.dtype == q.dtype and torch.equal(p, q), name
    for k in ("master", "m", "v"):
        ref = params_from_jax(jax.tree.map(np.asarray, opt[k]), cfg_t,
                              device="cpu")
        for t, q in zip(state[k], ref.parameters()):
            assert t.dtype == torch.float32 and torch.equal(t, q), k
    meta = json.loads((tmp_path / "step_00000001" / "meta.json").read_text())
    assert meta == {"step": 1, "arch": arch}


@pytest.mark.parametrize("arch", ARCHS)
def test_port_checkpoint_restores_through_jax(arch, tmp_path):
    cfg_j, cfg_t = _reduced(arch)
    model, state = init_train_state(cfg_t, seed=0, device="cpu")
    leaves = list(model.parameters())
    rng = np.random.default_rng(1)
    grads = [torch.from_numpy(rng.standard_normal(tuple(p.shape))
                              .astype(np.float32)).to(p.dtype)
             for p in leaves]
    adamw_update(leaves, grads, state, AdamWConfig(lr=1e-2))
    d = save_train_state(1, model, state, tmp_path)
    assert sorted(x.name for x in d.iterdir()) == [
        "meta.json", "opt_state.npz", "params.npz"]

    tmpl = jax_init_lm(jax.random.PRNGKey(7), cfg_j)
    params, opt, step = jax_restore(tmpl, jax_adamw_init(tmpl), tmp_path)
    assert step == 1 and int(opt["step"]) == 1
    tree = tree_from_params(model)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    assert flat_j.keys() == flat_t.keys()
    for k, a in flat_j.items():
        assert a.dtype == flat_t[k].dtype and np.array_equal(
            np.asarray(a).view(np.uint8), flat_t[k].view(np.uint8)), k
    for key in ("master", "m", "v"):
        want = flat_from_leaves(model, state[key])
        for path, a in jax.tree_util.tree_flatten_with_path(opt[key])[0]:
            k = "/".join(str(getattr(x, "key", getattr(x, "idx", x)))
                         for x in path)
            assert np.array_equal(np.asarray(a), want[k].numpy()), (key, k)


def test_tree_from_params_inverts_params_from_jax():
    cfg_j, cfg_t = _reduced("zamba2-1.2b")
    tree = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(2), cfg_j))
    back = tree_from_params(params_from_jax(tree, cfg_t, device="cpu"))
    a, b = (dict(jax.tree_util.tree_flatten_with_path(t)[0])
            for t in (tree, back))
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
        assert a[k].tobytes() == b[k].tobytes(), k


def test_pytree_roundtrip(tmp_path):
    """The port's mirror of ``test_checkpoint_roundtrip``: a bf16 leaf
    comes back bf16 with the same values, in place."""
    tree = {"w": torch.arange(6, dtype=torch.bfloat16).reshape(2, 3),
            "nested": {"b": torch.ones(4), "l": [torch.full((2,), 3.0)]}}
    save_pytree(tree, tmp_path / "t.npz")
    with np.load(tmp_path / "t.npz") as f:
        assert sorted(f.files) == ["nested/b", "nested/l/0", "w@bf16"]
    tmpl = {"w": torch.zeros(2, 3, dtype=torch.bfloat16),
            "nested": {"b": torch.zeros(4), "l": [torch.zeros(2)]}}
    out = load_pytree(tmpl, tmp_path / "t.npz")
    assert out["w"] is tmpl["w"] and out["w"].dtype == torch.bfloat16
    assert torch.equal(out["w"], tree["w"])
    assert torch.equal(out["nested"]["l"][0], tree["nested"]["l"][0])
    with pytest.raises(ValueError, match="not in the template"):
        load_pytree({"w": tmpl["w"]}, tmp_path / "t.npz")


def test_restore_rejects_an_unmapped_leaf_and_a_missing_directory(tmp_path):
    cfg = get_config("qwen3-4b").reduced()
    model, state = init_train_state(cfg, seed=0, device="cpu")
    with pytest.raises(FileNotFoundError):
        restore_train_state(model, state, tmp_path)
    d = save_train_state(3, model, state, tmp_path)
    with np.load(d / "params.npz") as f:
        leaves = {k: f[k] for k in f.files}
    leaves["stacks/0/attn/extra"] = np.zeros(3, np.float32)
    np.savez(d / "params.npz", **leaves)
    with pytest.raises(ValueError, match="does not map"):
        restore_train_state(model, state, tmp_path, step=3)


@pytest.mark.parametrize("arch,dtype", [("qwen3-4b", torch.float32),
                                        ("mamba2-370m", torch.bfloat16)])
def test_save_restore_resume_repeats_an_unbroken_run(arch, dtype, tmp_path):
    """The port's mirror of ``test_train_checkpoint_restore_resume``: 2
    steps, save, restore into a freshly built model and AdamW state, 2
    more steps: the losses of 4 unbroken steps, bit for bit."""
    cfg = get_config(arch).reduced().with_(dtype=dtype)
    ocfg = AdamWConfig(lr=1e-3)
    step = make_train_step(cfg, ocfg)

    def batches():
        gen = synthetic_lm_batches(DataConfig(seq_len=16, global_batch=2,
                                              vocab_size=cfg.vocab_size))
        return [{k: torch.from_numpy(v) for k, v in next(gen).items()}
                for _ in range(4)]

    model, state = init_train_state(cfg, seed=0, opt_cfg=ocfg, device="cpu")
    unbroken = [float(step(model, state, b)["loss"]) for b in batches()]

    bs = batches()
    model, state = init_train_state(cfg, seed=0, opt_cfg=ocfg, device="cpu")
    losses = [float(step(model, state, b)["loss"]) for b in bs[:2]]
    save_train_state(2, model, state, tmp_path)
    fresh, fresh_state = init_train_state(cfg, seed=9, opt_cfg=ocfg,
                                          device="cpu")
    _, _, s = restore_train_state(fresh, fresh_state, tmp_path)
    assert s == 2 and fresh_state["step"] == 2
    for a, b in zip(fresh.parameters(), model.parameters()):
        assert torch.equal(a, b)
    losses += [float(step(fresh, fresh_state, b)["loss"]) for b in bs[2:]]
    assert losses == unbroken


def test_train_cli_writes_checkpoints(tmp_path, capsys):
    ck = tmp_path / "ckpt"
    hist = train_main(["--device", "cpu", "--reduced", "--arch",
                       "mamba2-370m", "--steps", "4", "--batch", "2",
                       "--seq", "16", "--ckpt-dir", str(ck),
                       "--ckpt-every", "2"])
    assert len(hist) == 4
    assert sorted(p.name for p in ck.iterdir()) == ["step_00000002",
                                                    "step_00000004"]
    assert f"checkpoint -> {ck / 'step_00000004'}" in capsys.readouterr().out
    cfg = get_config("mamba2-370m").reduced()
    model, state = init_train_state(cfg, seed=3, device="cpu")
    _, _, step = restore_train_state(model, state, ck)
    assert step == 4 and state["step"] == 4
