"""Checkpoints of the port's sharded executor against the JAX package's
layout, on the CPU.

A module fixture starts 4 gloo ranks (``launch/mesh.py::run_ranks``,
spawn, a ``file://`` rendezvous under a temporary directory, one thread
each, a 240 s limit).  For each case the ranks draw their shards of a
reduced bf16 model (``init_train_state(mesh=)``), take 2 sharded AdamW
steps, save with ``save_sharded_train_state`` and gather the whole state
(``gather_tensor``: the reference every file is held against), take 2
more steps (the unbroken run), then draw fresh shards from another seed,
restore into them with ``restore_sharded_train_state`` and take the same
2 steps.  Cases: reduced mamba2-370m on (data 2, model 2) with TP and
ZeRO, whose gathers cross both axes, and reduced qwen3-4b on (4, 1) with
ZeRO.

Everything is bit for bit: the files restore through JAX
``restore_train_state`` into JAX templates and through the port's
``restore_train_state`` to the gathered state; each rank's restored leaves
are its ``shard_tensor`` slices of it; the resumed losses are the unbroken
run's.  ``train --ranks 4 --ckpt-dir`` writes ``step_XXXXXXXX/``.
"""
import json
import pathlib
import types

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.checkpointing import restore_train_state as jax_restore
from repro.configs import get_config as jax_get_config
from repro.models.transformer import init_lm as jax_init_lm
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.bridge import flat_from_leaves, tree_from_params
from repro_torch.checkpointing import (restore_sharded_train_state,
                                       restore_train_state,
                                       save_sharded_train_state)
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, synthetic_lm_batches
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import (init_distributed, make_local_mesh,
                                     run_ranks)
from repro_torch.models.transformer import init_lm
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import (ShardPolicy, init_train_state,
                                 make_train_step)

torch.set_num_threads(1)

WORLD = 4
TIMEOUT_S = 240
SAVE_AT, STEPS = 2, 4
# (name, arch, (data, model), policy)
CASES = [("mamba2-2x2-tp-zero", "mamba2-370m", (2, 2),
          dict(tp=True, zero=True)),
         ("qwen3-4x1-zero", "qwen3-4b", (4, 1), dict(tp=False, zero=True))]
CASE_NAMES = [c[0] for c in CASES]
OPT = ("master", "m", "v")


def _cfg(arch):
    return get_config(arch).reduced(n_layers=2)


def _batches(cfg):
    gen = synthetic_lm_batches(DataConfig(seq_len=16, global_batch=4,
                                          vocab_size=cfg.vocab_size))
    return [{k: torch.from_numpy(v) for k, v in next(gen).items()}
            for _ in range(STEPS)]


def _ckpt_worker(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{init_file}", timeout_s=TIMEOUT_S)
    try:
        out = {}
        for name, arch, shape, pk in CASES:
            cfg, pol = _cfg(arch), ShardPolicy(**pk)
            mesh = make_local_mesh(shape[1], device_type="cpu")
            ocfg = AdamWConfig(lr=1e-3)
            step = make_train_step(cfg, ocfg, mesh=mesh, policy=pol)
            ctx = step.shard
            batches = _batches(cfg)
            params, opt = init_train_state(cfg, mesh=mesh, policy=pol,
                                           seed=0, opt_cfg=ocfg, device="cpu")
            unbroken = [float(step(params, opt, b)["loss"])
                        for b in batches[:SAVE_AT]]
            d = save_sharded_train_state(SAVE_AT, params, opt, ctx,
                                         f"{out_dir}/{name}",
                                         extra={"case": name})
            named = list(params.named_parameters())
            # a copy: a replicated leaf is gathered as the leaf itself
            whole = {"params": {n: ctx.gather_tensor(n, p).clone()
                                for n, p in named},
                     **{k: {n: ctx.gather_tensor(n, t).clone()
                            for (n, _), t in zip(named, opt[k])}
                        for k in OPT}}
            unbroken += [float(step(params, opt, b)["loss"])
                         for b in batches[SAVE_AT:]]
            fresh, fresh_opt = init_train_state(cfg, mesh=mesh, policy=pol,
                                                seed=1, opt_cfg=ocfg,
                                                device="cpu")
            _, _, s = restore_sharded_train_state(fresh, fresh_opt, ctx,
                                                  f"{out_dir}/{name}")
            shards_ok = (s == SAVE_AT and fresh_opt["step"] == SAVE_AT
                         and all(torch.equal(p, ctx.shard_tensor(
                             n, whole["params"][n]))
                             for n, p in fresh.named_parameters())
                         and all(torch.equal(t, ctx.shard_tensor(
                             n, whole[k][n]))
                             for k in OPT for (n, _), t in zip(
                                 named, fresh_opt[k])))
            resumed = [float(step(fresh, fresh_opt, b)["loss"])
                       for b in batches[SAVE_AT:]]
            oks = [None] * world
            dist.all_gather_object(oks, shards_ok)
            if rank == 0:
                torch.save(whole, f"{out_dir}/{name}.whole.pt")
                out[name] = {"dir": str(d), "unbroken": unbroken,
                             "resumed": resumed, "shards_ok": oks}
        if rank == 0:
            pathlib.Path(f"{out_dir}/results.json").write_text(
                json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("sharded_ckpt")
    run_ranks(_ckpt_worker, (WORLD, str(tmp / "rendezvous"), str(tmp)),
              WORLD, timeout_s=TIMEOUT_S)
    res = json.loads((tmp / "results.json").read_text())
    whole = {name: torch.load(tmp / f"{name}.whole.pt")
             for name in CASE_NAMES}
    return types.SimpleNamespace(res=res, whole=whole)


def _template(arch, whole, seed=5):
    """A port model of the case's config holding ``whole`` (or, with
    ``whole`` None, seed ``seed``'s weights)."""
    model = init_lm(_cfg(arch), seed=seed, device="cpu")
    if whole is not None:
        with torch.no_grad():
            for n, p in model.named_parameters():
                p.copy_(whole[n])
    return model


@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_sharded_checkpoint_restores_through_jax(runs, case):
    """JAX ``restore_train_state`` into JAX templates gives the gathered
    parameters and AdamW state, bit for bit."""
    name, arch = case[:2]
    whole = runs.whole[name]
    tmpl = jax_init_lm(jax.random.PRNGKey(7),
                       jax_get_config(arch).reduced(n_layers=2))
    params, opt, step = jax_restore(tmpl, jax_adamw_init(tmpl),
                                    pathlib.Path(runs.res[name]["dir"]).parent)
    assert step == SAVE_AT and int(opt["step"]) == SAVE_AT
    model = _template(arch, whole["params"])
    flat_j = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(
        tree_from_params(model))[0])
    assert flat_j.keys() == flat_t.keys()
    for k, a in flat_j.items():
        assert a.dtype == flat_t[k].dtype and np.array_equal(
            np.asarray(a).view(np.uint8), flat_t[k].view(np.uint8)), k
    names = [n for n, _ in model.named_parameters()]
    for key in OPT:
        want = flat_from_leaves(model, [whole[key][n] for n in names])
        for path, a in jax.tree_util.tree_flatten_with_path(opt[key])[0]:
            k = "/".join(str(getattr(x, "key", getattr(x, "idx", x)))
                         for x in path)
            assert np.array_equal(np.asarray(a), want[k].numpy()), (key, k)


@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_sharded_checkpoint_restores_through_the_port(runs, case):
    """The port's one-process ``restore_train_state`` gives the gathered
    state, bit for bit, and the files are the one-process layout."""
    name, arch = case[:2]
    whole = runs.whole[name]
    d = pathlib.Path(runs.res[name]["dir"])
    assert sorted(x.name for x in d.iterdir()) == [
        "meta.json", "opt_state.npz", "params.npz"]
    assert json.loads((d / "meta.json").read_text()) == {
        "step": SAVE_AT, "case": name}
    model = _template(arch, None)
    opt = adamw_init(list(model.parameters()))
    _, _, step = restore_train_state(model, opt, d.parent)
    assert step == SAVE_AT and opt["step"] == SAVE_AT
    for i, (n, p) in enumerate(model.named_parameters()):
        assert p.dtype == whole["params"][n].dtype
        assert torch.equal(p, whole["params"][n]), n
        for k in OPT:
            assert torch.equal(opt[k][i], whole[k][n]), (k, n)


@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_restore_sharded_gives_each_rank_its_shards(runs, case):
    """Fresh ranks drawn from another seed hold, after
    ``restore_sharded_train_state``, exactly their ``shard_tensor`` slices
    of the saved state, and its step."""
    assert runs.res[case[0]]["shards_ok"] == [True] * WORLD


@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_resume_repeats_the_unbroken_run(runs, case):
    """Save at step 2, restore, 2 more steps: the unbroken run's losses,
    bit for bit."""
    res = runs.res[case[0]]
    assert len(res["unbroken"]) == STEPS
    assert res["resumed"] == res["unbroken"][SAVE_AT:]


def test_train_cli_ranks_ckpt_dir_writes_a_checkpoint(tmp_path):
    """``train --ranks 4 --device cpu --reduced --ckpt-dir DIR
    --ckpt-every 2`` saves the sharded run's state at step 2 in the JAX
    layout, which one process restores: AdamW's step is 2 and every bf16
    parameter is its fp32 master rounded."""
    hist = train_cli.main(["--device", "cpu", "--reduced", "--ranks", "4",
                           "--steps", "3", "--batch", "4", "--seq", "32",
                           "--log-every", "1", "--ckpt-dir", str(tmp_path),
                           "--ckpt-every", "2"])
    assert len(hist) == 3
    assert sorted(x.name for x in tmp_path.iterdir()) == ["step_00000002"]
    cfg = get_config("qwen3-4b").reduced(n_layers=2)
    model = init_lm(cfg, seed=5, device="cpu")
    opt = adamw_init(list(model.parameters()))
    _, _, step = restore_train_state(model, opt, tmp_path)
    assert step == 2 and opt["step"] == 2
    for p, m in zip(model.parameters(), opt["master"]):
        assert torch.equal(p, m.to(p.dtype))
    assert all(v.abs().max() > 0 for v in opt["v"])
