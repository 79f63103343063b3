"""The port's sharded executor against the single-process port and the JAX
package, on the CPU.

The ranks are real processes: a module fixture starts 4 gloo ranks with
``launch/mesh.py::run_ranks`` (spawn, a ``file://`` rendezvous under a
temporary directory, one thread each, a 240 s limit) and runs every case
on a ``make_local_mesh`` of its shape.  Each case bridges JAX ``init_lm``
weights into a full port model, keeps the rank's shards
(``shard_train_state``), runs ``make_sharded_loss`` on one batch and
gathers every gradient leaf, then trains three sharded AdamW steps from
the same weights.  Beside the ranks, ``conftest.run_subprocess`` runs the
JAX ``make_train_step`` on a (4, 1) mesh of fake devices with
``tp=False, zero=False``, the JAX executor's only policy that runs here
(with ZeRO it raises a ``ShardingTypeError``, ``ROADMAP.md`` §3).

Models: reduced fp32 qwen3-4b (2 layers, d 256, 4 heads; a GQA variant
with 2 KV heads), reduced mamba2-370m (8 SSM heads) and zamba2-1.2b (8 SSM
heads, 4 attention heads in its shared block), with DP, ZeRO and TP (an
SSM block on its rank's heads, ``models/ssm.py::ssm_block``).  Batches of
4 x 32 tokens.  The SSM and hybrid TP cases run the port's model in
float64 (the JAX model stays fp32): their ``A_log``, ``dt_bias`` and conv
gradients move by 3e-6 to 9e-6 of their largest magnitude when the weights
move by 1e-7 (measured in float64 on these models), so the fp32 sums TP
must reorder (the vocab-parallel loss, the row-parallel ``out_proj``, the
B and C gradients summed over ranks) leave them about 1e-5 from the
single process in fp32, as far as the single process itself lies from
float64; in float64 the gates below check the algebra.

Tolerances (fp32, sums in another order): loss within 1e-5 relative and
every gathered gradient leaf within 1e-5 of its largest magnitude of the
single-process port, within 1e-4 of JAX ``jax.value_and_grad(lm_loss)``;
three AdamW steps' losses within 1e-5 relative of the single-process
``make_train_step`` (and of JAX ``make_train_step`` on 4 fake devices for
DP); ``seq_shard`` on against off within the JAX test's 2e-4.
"""
import dataclasses
import json
import pathlib
import types
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from conftest import run_subprocess

from repro.configs import get_config as jax_get_config
from repro.models.transformer import init_lm as jax_init_lm
from repro.models.transformer import lm_loss as jax_lm_loss
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, synthetic_lm_batches
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import (init_distributed, make_local_mesh,
                                     run_ranks)
from repro_torch.models.transformer import init_lm, lm_loss
from repro_torch.optim import global_norm
from repro_torch.runtime import (ShardContext, ShardPolicy, gather_params,
                                 init_train_state, make_sharded_loss,
                                 make_train_step, shard_train_state)
from repro_torch.runtime import sharding

torch.set_num_threads(1)

WORLD = 4
TIMEOUT_S = 240
B, S, STEPS = 4, 32, 3
RTOL, GRAD_TOL, JAX_TOL, SEQ_TOL = 1e-5, 1e-5, 1e-4, 2e-4


def _cfgs(arch):
    """(JAX config, port config) of a case's model, fp32: ``mamba2-h2``
    has 2 SSM heads of 256, ``zamba2-kv2`` 2 KV heads in its shared
    block; ``-f64`` runs the port's model in float64 (JAX's stays fp32)."""
    f64 = arch.endswith("-f64")
    arch = arch.removesuffix("-f64")
    if arch.startswith("mamba2"):
        cj = jax_get_config("mamba2-370m").reduced(n_layers=2)
        ct = get_config("mamba2-370m").reduced(n_layers=2)
        if arch == "mamba2-h2":
            cj, ct = cj.with_(ssm_head_dim=256), ct.with_(ssm_head_dim=256)
    elif arch.startswith("zamba2"):
        cj = jax_get_config("zamba2-1.2b").reduced(n_layers=4)
        ct = get_config("zamba2-1.2b").reduced(n_layers=4)
        if arch == "zamba2-kv2":
            cj, ct = cj.with_(n_kv_heads=2), ct.with_(n_kv_heads=2)
    else:
        cj = jax_get_config("qwen3-4b").reduced(n_layers=2, d_model=256)
        ct = get_config("qwen3-4b").reduced(n_layers=2, d_model=256)
        if arch == "gqa":
            cj, ct = cj.with_(n_kv_heads=2), ct.with_(n_kv_heads=2)
    return cj.with_(dtype=jnp.float32), ct.with_(
        dtype=torch.float64 if f64 else torch.float32)


_NP = {torch.float32: np.float32, torch.float64: np.float64}
R = (True,)
# (name, arch, (data, model), policy)
CASES = [
    ("2x2-tp-zero-remat", "qwen", (2, 2),
     dict(tp=True, zero=True, remat_segments=R)),
    ("2x2-tp-zero-remat-seq", "qwen", (2, 2),
     dict(tp=True, zero=True, remat_segments=R, seq_shard=True)),
    ("2x2-tp-dp", "qwen", (2, 2), dict(tp=True, zero=False)),
    ("2x2-gqa-tp-zero", "gqa", (2, 2), dict(tp=True, zero=True)),
    ("2x2-gqa-tp-zero-seq", "gqa", (2, 2),
     dict(tp=True, zero=True, seq_shard=True)),
    ("2x2-replicated-model-zero-seq", "qwen", (2, 2),
     dict(tp=False, zero=True, seq_shard=True)),
    ("4x1-dp", "qwen", (4, 1), dict(tp=False, zero=False)),
    ("4x1-zero-remat", "qwen", (4, 1),
     dict(tp=False, zero=True, remat_segments=R)),
    ("1x4-tp-remat", "qwen", (1, 4),
     dict(tp=True, zero=True, remat_segments=R)),
    ("1x4-tp-remat-seq", "qwen", (1, 4),
     dict(tp=True, zero=True, remat_segments=R, seq_shard=True)),
    ("mamba2-4x1-dp", "mamba2", (4, 1), dict(tp=False, zero=False)),
    ("mamba2-4x1-zero", "mamba2", (4, 1),
     dict(tp=False, zero=True, remat_segments=R)),
    ("zamba2-2x2-zero", "zamba2", (2, 2), dict(tp=False, zero=True)),
    ("mamba2-2x2-tp-zero-remat", "mamba2-f64", (2, 2),
     dict(tp=True, zero=True, remat_segments=R)),
    ("mamba2-2x2-tp-zero-remat-seq", "mamba2-f64", (2, 2),
     dict(tp=True, zero=True, remat_segments=R, seq_shard=True)),
    ("mamba2-1x4-tp", "mamba2-f64", (1, 4), dict(tp=True)),
    ("zamba2-2x2-tp-zero-remat", "zamba2-f64", (2, 2),
     dict(tp=True, zero=True, remat_segments=R)),
    ("zamba2-1x4-tp", "zamba2-f64", (1, 4), dict(tp=True)),
]
CASE_NAMES = [c[0] for c in CASES]
SEQ_PAIRS = [("2x2-tp-zero-remat", "2x2-tp-zero-remat-seq"),
             ("2x2-gqa-tp-zero", "2x2-gqa-tp-zero-seq"),
             ("1x4-tp-remat", "1x4-tp-remat-seq"),
             ("mamba2-2x2-tp-zero-remat", "mamba2-2x2-tp-zero-remat-seq")]
# (arch, (data, model), policy, the leaf its ValueError names)
REFUSED = [("mamba2-h2", (1, 4), dict(tp=True), "blocks.*.ssm.in_proj"),
           ("zamba2-kv2", (1, 4), dict(tp=True, zero=False),
            "shared_attn.attn.wk"),
           ("gqa", (1, 4), dict(tp=True), "blocks.*.attn.wk")]
INIT_CASES = [("qwen", (2, 2), dict(tp=True, zero=True)),
              ("qwen", (1, 4), dict(tp=True, zero=False)),
              ("mamba2", (4, 1), dict(tp=False, zero=True))]
# the train CLI's geometry (reduced bf16 qwen3-4b, its default plan)
CLI_ARGV = ["--device", "cpu", "--reduced", "--ranks", "4", "--steps", "3",
            "--batch", "4", "--seq", "32", "--log-every", "1"]


def _mesh(meshes, shape):
    if shape not in meshes:     # a collective: the same order everywhere
        meshes[shape] = make_local_mesh(shape[1], device_type="cpu")
    return meshes[shape]


def _batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _shard_worker(rank, world, init_file, out_dir, trees, batches,
                  cli_policy):
    """One rank: every case, the refusals, the init checks and the CLI's
    steps; rank 0 saves."""
    torch.set_num_threads(1)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{init_file}", timeout_s=TIMEOUT_S)
    try:
        meshes, out = {}, {}
        for name, arch, shape, pk in CASES:
            cfg, mesh, pol = _cfgs(arch)[1], _mesh(meshes, shape), \
                ShardPolicy(**pk)
            params, _ = shard_train_state(
                params_from_jax(trees[arch], cfg, device="cpu"), mesh, pol,
                cfg=cfg)
            loss_fn = make_sharded_loss(cfg, mesh, pol)
            loss, grads = loss_fn(params, _batch(batches[arch][0]))
            ctx = loss_fn.shard
            named = list(params.named_parameters())
            gnorm = ctx.grad_norm(named, grads)
            full = {n: ctx.gather_tensor(n, g).numpy()
                    for (n, _), g in zip(named, grads)}
            params, opt = shard_train_state(
                params_from_jax(trees[arch], cfg, device="cpu"), mesh, pol,
                cfg=cfg)
            step = make_train_step(cfg, mesh=mesh, policy=pol)
            losses = [float(step(params, opt, _batch(b))["loss"])
                      for b in batches[arch]]
            allranks = [None] * world
            dist.all_gather_object(allranks, [loss.item()] + losses)
            if rank == 0:
                np.savez(f"{out_dir}/{name}.npz", **full)
                out[name] = {"loss": loss.item(), "gnorm": gnorm.item(),
                             "losses": losses, "ranks": allranks}
        for i, (arch, shape, pk, _) in enumerate(REFUSED):
            try:
                ShardContext(_cfgs(arch)[1], _mesh(meshes, shape),
                             ShardPolicy(**pk))
                out[f"refused{i}"] = None
            except ValueError as e:
                out[f"refused{i}"] = str(e)
        for i, (arch, shape, pk) in enumerate(INIT_CASES):
            cfg, mesh, pol = _cfgs(arch)[1], _mesh(meshes, shape), \
                ShardPolicy(**pk)
            drawn, opt = init_train_state(cfg, mesh=mesh, policy=pol,
                                          device="cpu")
            whole = init_lm(cfg, seed=0, device="cpu")
            sliced, _ = shard_train_state(init_lm(cfg, seed=0, device="cpu"),
                                          mesh, pol, cfg=cfg)
            back = gather_params(drawn, mesh, pol, cfg=cfg)
            ok = all(torch.equal(a, b) for a, b in
                     zip(drawn.parameters(), sliced.parameters()))
            ok_back = all(torch.equal(a, b) for a, b in
                          zip(back.parameters(), whole.parameters()))
            ok_opt = all(torch.equal(m, p.float()) for m, p in
                         zip(opt["master"], drawn.parameters()))
            res = [None] * world
            dist.all_gather_object(res, (ok, ok_back, ok_opt))
            out[f"init{i}"] = res
        # the train CLI's steps, run as make_train_step with its policy
        cfg = get_config("qwen3-4b").reduced(n_layers=2, d_model=256)
        mesh = _mesh(meshes, (WORLD, 1))
        params, opt = init_train_state(cfg, mesh=mesh, policy=cli_policy,
                                       seed=0, device="cpu")
        step = make_train_step(cfg, train_cli.AdamWConfig(lr=3e-4),
                               mesh=mesh, policy=cli_policy)
        gen = synthetic_lm_batches(DataConfig(seq_len=32, global_batch=4,
                                              vocab_size=cfg.vocab_size))
        out["cli"] = [float(step(params, opt, _batch(next(gen)))["loss"])
                      for _ in range(3)]
        if rank == 0:
            pathlib.Path(f"{out_dir}/results.json").write_text(
                json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


JAX_DP = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.runtime import ShardPolicy, make_train_step, init_train_state
from repro.data import DataConfig, batch_specs
cfg = get_config("qwen3-4b").reduced(n_layers=2, d_model=256).with_(
    dtype=jnp.float32)
mesh = jax.make_mesh((4, 1), ("data", "model"), devices=jax.devices()[:4])
pol = ShardPolicy(tp=False, zero=False)
dcfg = DataConfig(seq_len=32, global_batch=4, vocab_size=cfg.vocab_size)
batches = np.load("BATCHES")
with mesh:
    step = make_train_step(cfg, mesh, pol, batch_specs(dcfg))
    params, opt = init_train_state(cfg, mesh, pol)
    losses = []
    for i in range(3):
        b = {"tokens": jnp.asarray(batches["tokens"][i]),
             "labels": jnp.asarray(batches["labels"][i])}
        params, opt, m = step.fn(params, opt, b)
        losses.append(float(m["loss"]))
print("LOSSES", losses)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on 4 gloo ranks; the single-process port and JAX
    references; JAX DP on 4 fake devices (run beside the ranks)."""
    tmp = tmp_path_factory.mktemp("sharding")
    rng = np.random.default_rng(0)
    trees, batches, refs = {}, {}, {}
    for arch in ("qwen", "gqa", "mamba2", "zamba2", "mamba2-f64",
                 "zamba2-f64"):
        cj, ct = _cfgs(arch)
        params = jax_init_lm(jax.random.PRNGKey(0), cj)
        trees[arch] = jax.tree.map(
            lambda a: np.asarray(a).astype(_NP[ct.dtype]), params)
        batches[arch] = [
            {k: rng.integers(0, cj.vocab_size, (B, S), dtype=np.int32)
             for k in ("tokens", "labels")} for _ in range(STEPS)]
        b0 = batches[arch][0]
        b0["labels"][1, :5] = -100          # ignored labels weigh as one
        jl, jg = jax.jit(jax.value_and_grad(lambda p: jax_lm_loss(
            p, {k: jnp.asarray(v) for k, v in b0.items()}, cj)))(params)
        port = params_from_jax(trees[arch], ct, device="cpu")
        pl = lm_loss(port, _batch(b0), ct)
        pg = torch.autograd.grad(pl, list(port.parameters()))
        jgrads = params_from_jax(jax.tree.map(np.asarray, jg), ct,
                                 device="cpu").named_parameters()
        params_p = params_from_jax(trees[arch], ct, device="cpu")
        from repro_torch.optim import adamw_init
        opt = adamw_init(list(params_p.parameters()))
        step = make_train_step(ct)
        refs[arch] = {
            "loss": pl.item(), "jax_loss": float(jl),
            "grads": {n: g.numpy() for (n, _), g in
                      zip(port.named_parameters(), pg)},
            "jax_grads": {n: g.detach().numpy() for n, g in jgrads},
            "gnorm": global_norm(pg).item(),
            "losses": [float(step(params_p, opt, _batch(b))["loss"])
                       for b in batches[arch]]}
    np.savez(tmp / "batches.npz",
             tokens=np.stack([b["tokens"] for b in batches["qwen"]]),
             labels=np.stack([b["labels"] for b in batches["qwen"]]))
    cli_cfg = get_config("qwen3-4b").reduced(n_layers=2, d_model=256)
    cli_policy = train_cli.middle_strategy_policy(
        train_cli.search_plan(cli_cfg, 32))
    code = JAX_DP.replace("BATCHES", str(tmp / "batches.npz"))
    with ThreadPoolExecutor(1) as pool:     # beside the ranks
        jax_run = pool.submit(run_subprocess, code, devices=4,
                              timeout=TIMEOUT_S)
        run_ranks(_shard_worker, (WORLD, str(tmp / "rendezvous"), str(tmp),
                                  trees, batches, cli_policy), WORLD,
                  timeout_s=TIMEOUT_S)
        jax_out = jax_run.result()
    res = json.loads((tmp / "results.json").read_text())
    grads = {}
    for name in CASE_NAMES:
        with np.load(tmp / f"{name}.npz") as f:
            grads[name] = {k: f[k] for k in f.files}
    line = [x for x in jax_out.splitlines() if x.startswith("LOSSES")][0]
    return types.SimpleNamespace(
        res=res, grads=grads, refs=refs, cli_policy=cli_policy,
        jax_dp=json.loads(line[len("LOSSES "):]))


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_sharded_loss_and_grads_match_the_single_process(runs, case):
    name, arch = case[:2]
    res, ref = runs.res[name], runs.refs[arch]
    assert res["loss"] == pytest.approx(ref["loss"], rel=RTOL)
    assert set(runs.grads[name]) == set(ref["grads"])
    for k, g in runs.grads[name].items():
        assert _rel(g, ref["grads"][k]) <= GRAD_TOL, (name, k)
    # every rank reports the same loss and step losses
    assert all(r == res["ranks"][0] for r in res["ranks"])


@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_sharded_loss_and_grads_match_jax(runs, case):
    name, arch = case[:2]
    ref = runs.refs[arch]
    assert runs.res[name]["loss"] == pytest.approx(ref["jax_loss"],
                                                   rel=JAX_TOL)
    for k, g in runs.grads[name].items():
        assert _rel(g, ref["jax_grads"][k]) <= JAX_TOL, (name, k)


@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_grad_norm_counts_each_leaf_once(runs, case):
    name, arch = case[:2]
    assert runs.res[name]["gnorm"] == pytest.approx(runs.refs[arch]["gnorm"],
                                                    rel=RTOL)


@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_three_adamw_steps_match_the_single_process(runs, case):
    name, arch = case[:2]
    got, want = runs.res[name]["losses"], runs.refs[arch]["losses"]
    assert got == pytest.approx(want, rel=RTOL)


def test_data_parallel_steps_match_jax_make_train_step(runs):
    """(4, 1) DP against the JAX executor on 4 fake devices."""
    assert runs.res["4x1-dp"]["losses"] == pytest.approx(runs.jax_dp,
                                                         rel=JAX_TOL)


@pytest.mark.parametrize("off,on", SEQ_PAIRS, ids=[p[1] for p in SEQ_PAIRS])
def test_seq_shard_on_and_off_agree(runs, off, on):
    assert runs.res[on]["loss"] == pytest.approx(runs.res[off]["loss"],
                                                 rel=SEQ_TOL)
    for k, g in runs.grads[on].items():
        assert _rel(g, runs.grads[off][k]) <= SEQ_TOL, k


def test_ssm_seq_shard_gives_the_same_bits(runs):
    """Under SSM TP the stash-only sequence slices are exact copies and no
    sum is reordered: the same loss and gradients as off, bit for bit."""
    off, on = "mamba2-2x2-tp-zero-remat", "mamba2-2x2-tp-zero-remat-seq"
    assert runs.res[on]["loss"] == runs.res[off]["loss"]
    assert runs.res[on]["losses"] == runs.res[off]["losses"]
    for k, g in runs.grads[on].items():
        assert np.array_equal(g, runs.grads[off][k]), k


@pytest.mark.parametrize("i", range(len(REFUSED)),
                         ids=["tp-splits-ssm-heads", "tp-splits-shared-kv",
                              "tp-splits-kv"])
def test_unsplittable_tp_raises(runs, i):
    """A TP degree that does not split the heads raises a ValueError that
    names the leaf (no TP is refused as such: SSM and hybrid models run
    TP)."""
    msg = runs.res[f"refused{i}"]
    assert msg is not None
    assert f"does not split {REFUSED[i][3]}:" in msg


@pytest.mark.parametrize("i", range(len(INIT_CASES)),
                         ids=["2x2", "1x4", "mamba2-4x1"])
def test_init_train_state_draws_the_single_process_numbers(runs, i):
    """Each rank's drawn shards are its slices of ``init_lm(seed=0)``, and
    ``gather_params`` puts the whole model back; AdamW's master is the
    shards."""
    assert all(all(r) for r in runs.res[f"init{i}"])


def test_train_cli_ranks_runs_the_sharded_step(runs, capsys):
    """``train --ranks 4 --device cpu --reduced`` prints the plan's policy
    and its losses are the sharded step's under that policy."""
    hist = train_cli.main(CLI_ARGV)
    out = capsys.readouterr().out
    assert f"policy={runs.cli_policy}" in out
    assert "not applied" not in out
    assert [h["loss"] for h in hist] == runs.res["cli"]
    assert all(h["gloo_bytes_sent"] >= 0 for h in hist)


@pytest.mark.parametrize("backend", ["nccl", "mpi"])
def test_collectives_need_a_gloo_group(monkeypatch, backend):
    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    with pytest.raises(ValueError, match="over gloo"):
        sharding.check_gloo(object(), "the sharded executor")


def test_sharded_step_refuses_a_mesh_of_other_axes():
    mesh = types.SimpleNamespace(mesh_dim_names=("pipe", "data"))
    with pytest.raises(ValueError, match="'data', 'model'"):
        ShardContext(_cfgs("qwen")[1], mesh, ShardPolicy())


def test_one_device_path_unchanged_without_a_mesh():
    """``make_train_step`` without a mesh is the one-device step: the same
    bits as ``lm_loss`` and its gradients taken directly."""
    cfg = _cfgs("qwen")[1]
    params, opt = init_train_state(cfg, seed=0, device="cpu")
    ref = init_lm(cfg, seed=0, device="cpu")
    b = _batch({k: np.random.default_rng(1).integers(
        0, cfg.vocab_size, (B, S), dtype=np.int32)
        for k in ("tokens", "labels")})
    loss = lm_loss(ref, b, cfg)
    m = make_train_step(cfg)(params, opt, b)
    assert m["loss"].item() == loss.item()
    with pytest.raises(ValueError, match="policy.remat_segments"):
        make_train_step(cfg, remat_segments=[True], mesh=object())
    assert dataclasses.asdict(ShardPolicy()) == dataclasses.asdict(
        ShardPolicy(tp=True, zero=True))
