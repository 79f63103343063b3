"""The port's pipeline runtime against the JAX package, on the CPU.

The ranks are real processes: a module fixture starts 4 gloo ranks with
``launch/mesh.py::run_ranks`` (spawn, a ``file://`` rendezvous under a
temporary directory, one thread each, a 180 s limit so that a hung
rendezvous fails) and runs every case on a (pipe 4, data 1) and a (pipe 2,
data 2) mesh; each
rank saves its loss, its grad norm, its tick counts and its stage's
gradients by parameter name.  Beside them, ``conftest.run_subprocess``
runs the JAX ``make_pipeline_loss`` on a (4, 2) mesh of 8 fake devices for
``1f1b-interleaved`` (V 2).

The geometry is the JAX package's own pipeline test
(``tests/test_distributed.py::test_pipeline_all_schedules_match_reference_8dev``):
reduced qwen3-4b at 8 layers and d 128 in fp32, m 6 micro-batches of 4 x 16
tokens, weights from JAX ``init_lm(PRNGKey(0))`` bridged into the port;
also a tied-embedding variant and reduced mamba2-370m at 4 layers.

Tolerances (fp32, sums in another order): the loss within 1e-5 relative
of JAX ``lm_loss``; every gradient leaf within 1e-4 of its leaf's largest
magnitude against ``jax.grad``; the global grad norm within 1e-5 relative;
``gpipe``, ``1f1b`` and ``zb-h1`` (one forward order, remat recomputing the
same bits) identical bit for bit.
"""
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
from repro.runtime.pipeline import stage_split_params as jax_stage_split
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch.mesh import (init_distributed, make_pipeline_mesh,
                                     run_ranks)
from repro_torch.launch.train import main as train_main
from repro_torch.launch.train import pipeline_layout
from repro_torch.models.transformer import init_lm
from repro_torch.optim import (AdamWConfig, adamw_init, adamw_update,
                               global_norm)
from repro_torch.runtime.pipeline import (init_stage, make_pipeline_loss,
                                          pipeline_grad_norm, stage_layers,
                                          stage_split_params)

torch.set_num_threads(1)

WORLD = 4
TIMEOUT_S = 180
M, BM, S = 6, 4, 16
LOSS_RTOL, GRAD_TOL, NORM_RTOL = 1e-5, 1e-4, 1e-5


def _cfgs(arch):
    """(JAX config, port config) of a case's model, fp32."""
    if arch == "mamba2":
        cj = jax_get_config("mamba2-370m").reduced(n_layers=4)
        ct = get_config("mamba2-370m").reduced(n_layers=4)
    else:
        cj = jax_get_config("qwen3-4b").reduced(n_layers=8, d_model=128)
        ct = get_config("qwen3-4b").reduced(n_layers=8, d_model=128)
        if arch == "tied":
            cj, ct = (c.with_(tie_embeddings=True) for c in (cj, ct))
    return cj.with_(dtype=jnp.float32), ct.with_(dtype=torch.float32)


# (name, arch, P, n_data, schedule, V)
CASES = [
    *[(f"{s}-4x1", "qwen", 4, 1, s, v) for s, v in (
        ("gpipe", 1), ("1f1b", 1), ("1f1b-interleaved", 2), ("zb-h1", 1))],
    *[(f"{s}-2x2", "qwen", 2, 2, s, v) for s, v in (
        ("gpipe", 1), ("1f1b", 1), ("1f1b-interleaved", 2), ("zb-h1", 1))],
    ("tied-1f1b-4x1", "tied", 4, 1, "1f1b", 1),
    ("tied-interleaved-2x2", "tied", 2, 2, "1f1b-interleaved", 2),
    ("mamba2-gpipe-4x1", "mamba2", 4, 1, "gpipe", 1),
    ("mamba2-1f1b-2x2", "mamba2", 2, 2, "1f1b", 1),
]
CASE_NAMES = [c[0] for c in CASES]


def _pipe_worker(rank, world, init_file, out_dir, cases, trees, batches):
    """One rank: every case on its stage; the data-rank-0 ranks save."""
    torch.set_num_threads(1)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{init_file}", timeout_s=TIMEOUT_S)
    try:
        meshes = {}
        for name, arch, P, n_data, sched, V in cases:
            if (P, n_data) not in meshes:   # collective: same order everywhere
                meshes[(P, n_data)] = make_pipeline_mesh(P, n_data,
                                                         device_type="cpu")
            mesh = meshes[(P, n_data)]
            cfg = _cfgs(arch)[1]
            i = mesh.get_local_rank("pipe")
            stage = stage_split_params(
                params_from_jax(trees[arch], cfg, device="cpu"), P, V)[i]
            loss_fn = make_pipeline_loss(cfg, mesh, M, schedule=sched,
                                         n_chunks=V)
            batch = {k: torch.from_numpy(v) for k, v in batches[arch].items()}
            loss, grads = loss_fn(stage, batch)
            gnorm = pipeline_grad_norm(stage, grads, mesh)
            if mesh.get_local_rank("data") == 0:
                np.savez(f"{out_dir}/{name}-{i}.npz", **{
                    n: g.numpy() for (n, _), g in zip(stage.named_parameters(),
                                                      grads)})
                pathlib.Path(f"{out_dir}/{name}-{i}.json").write_text(
                    json.dumps({"loss": loss.item(), "gnorm": gnorm.item(),
                                "stats": loss_fn.stats}))
        dist.barrier()
    finally:
        dist.destroy_process_group()


JAX_PIPELINE = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.models import init_lm
from repro.runtime.pipeline import make_pipeline_loss, stage_split_params
out, toks, labels = "OUT", np.load("TOKS"), np.load("LABELS")
mesh = jax.make_mesh((4, 2), ("pipe", "data"))
cfg = get_config("qwen3-4b").reduced(n_layers=8, d_model=128).with_(
    dtype=jnp.float32)
params = init_lm(jax.random.PRNGKey(0), cfg)
with mesh:
    ps = stage_split_params(params, 4, 2)
    fn = make_pipeline_loss(cfg, mesh, n_micro=6, schedule="1f1b-interleaved",
                            n_chunks=2)
    loss, grads = jax.jit(fn)(ps, {"tokens": jnp.asarray(toks),
                                   "labels": jnp.asarray(labels)})
flat = {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p):
        np.asarray(v) for p, v in jax.tree_util.tree_flatten_with_path(grads)[0]}
np.savez(out, loss=np.asarray(loss), **flat)
print("OK")
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on 4 gloo ranks, the JAX references, and the JAX
    pipeline on 8 fake devices (run at the same time)."""
    tmp = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    trees, batches, refs = {}, {}, {}
    for arch in ("qwen", "tied", "mamba2"):
        cj, ct = _cfgs(arch)
        params = jax_init_lm(jax.random.PRNGKey(0), cj)
        trees[arch] = jax.tree.map(np.asarray, params)
        toks = rng.integers(0, cj.vocab_size, (M, BM, S), dtype=np.int32)
        labels = rng.integers(0, cj.vocab_size, (M, BM, S), dtype=np.int32)
        batches[arch] = {"tokens": toks, "labels": labels}
        flat = {"tokens": jnp.asarray(toks.reshape(M * BM, S)),
                "labels": jnp.asarray(labels.reshape(M * BM, S))}
        loss, grads = jax.jit(jax.value_and_grad(
            lambda p: jax_lm_loss(p, flat, cj)))(params)
        named = params_from_jax(jax.tree.map(np.asarray, grads), ct,
                                device="cpu").named_parameters()
        refs[arch] = {"loss": float(loss),
                      "grads": {n: g.detach().numpy() for n, g in named}}
    np.save(tmp / "toks.npy", batches["qwen"]["tokens"])
    np.save(tmp / "labels.npy", batches["qwen"]["labels"])
    code = (JAX_PIPELINE.replace("OUT", str(tmp / "jax.npz"))
            .replace("TOKS", str(tmp / "toks.npy"))
            .replace("LABELS", str(tmp / "labels.npy")))
    with ThreadPoolExecutor(1) as pool:     # beside the ranks
        jax_run = pool.submit(run_subprocess, code, devices=8,
                              timeout=TIMEOUT_S)
        run_ranks(_pipe_worker, (WORLD, str(tmp / "rendezvous"), str(tmp),
                                 CASES, trees, batches), WORLD,
                  timeout_s=TIMEOUT_S)
        assert "OK" in jax_run.result()
    results = {}
    for name, arch, P, n_data, sched, V in CASES:
        grads, meta = {}, []
        for i in range(P):
            with np.load(tmp / f"{name}-{i}.npz") as f:
                for k in f.files:
                    assert k not in grads or np.array_equal(grads[k], f[k]), k
                    grads[k] = f[k]
            meta.append(json.loads((tmp / f"{name}-{i}.json").read_text()))
        results[name] = {"grads": grads, "meta": meta}
    with np.load(tmp / "jax.npz") as f:
        jax_pipe = {k: f[k] for k in f.files}
    return types.SimpleNamespace(results=results, refs=refs,
                                 jax_pipe=jax_pipe, trees=trees)


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_pipeline_loss_and_grads_match_jax_lm_loss(runs, case):
    """Loss and every gradient leaf against JAX ``lm_loss`` and
    ``jax.grad`` on the bridged params and the flattened batch."""
    name, arch = case[:2]
    res, ref = runs.results[name], runs.refs[arch]
    assert set(res["grads"]) == set(ref["grads"])   # every leaf, once
    for meta in res["meta"]:
        assert meta["loss"] == pytest.approx(ref["loss"], rel=LOSS_RTOL)
    for k, g in res["grads"].items():
        assert _rel(g, ref["grads"][k]) <= GRAD_TOL, (name, k)


@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_pipeline_grad_norm_is_the_single_process_norm(runs, case):
    """Every rank's ``pipeline_grad_norm`` equals the norm of the whole
    model's gradients, each leaf once (a tied embedding too)."""
    name, arch = case[:2]
    want = np.sqrt(sum(np.square(g.astype(np.float64)).sum()
                       for g in runs.refs[arch]["grads"].values()))
    pipe = np.sqrt(sum(np.square(g.astype(np.float64)).sum()
                       for g in runs.results[name]["grads"].values()))
    for meta in runs.results[name]["meta"]:
        assert meta["gnorm"] == pytest.approx(want, rel=NORM_RTOL)
        assert meta["gnorm"] == pytest.approx(pipe, rel=1e-6)


@pytest.mark.parametrize("mesh", ["4x1", "2x2"])
def test_flush_schedules_agree_bit_for_bit(runs, mesh):
    """gpipe, 1f1b and zb-h1 run one forward order; remat recomputes the
    same bits, so loss and gradients are identical."""
    base = runs.results[f"gpipe-{mesh}"]
    for sched in ("1f1b", "zb-h1"):
        other = runs.results[f"{sched}-{mesh}"]
        assert [m["loss"] for m in other["meta"]] == \
            [m["loss"] for m in base["meta"]]
        for k, g in base["grads"].items():
            assert np.array_equal(other["grads"][k], g), (sched, k)


@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_pipeline_works_no_bubble_slot(runs, case):
    """Deliberate difference (a): each rank works m·V ticks of the
    program's T and idles the program's bubble ticks."""
    name, _, P, _, _, V = case
    for meta in runs.results[name]["meta"]:
        st = meta["stats"]
        assert st["work_ticks"] == M * V
        assert st["bubble_ticks"] == st["program_bubble_ticks"]


def test_interleaved_matches_jax_make_pipeline_loss_on_8_devices(runs):
    """1f1b-interleaved (V 2) on pipe 4 against the JAX runtime on a (4, 2)
    mesh of fake devices: the loss, and each stage-split leaf, undoing the
    (P, V, Lc) round-robin placement."""
    jp, res = runs.jax_pipe, runs.results["1f1b-interleaved-4x1"]
    for meta in res["meta"]:
        assert meta["loss"] == pytest.approx(float(jp["loss"]),
                                             rel=LOSS_RTOL)
    P, V = 4, 2
    n_seen = 0
    for k, g in res["grads"].items():
        if k.startswith("blocks."):
            _, layer, *rest = k.split(".")
            leaf = jp["stacks/0/" + "/".join(rest)]
            lc = leaf.shape[2]
            s, j = divmod(int(layer), lc)
            want = leaf[s % P, s // P, j]
        else:
            want = jp[k]
        assert _rel(g, want) <= GRAD_TOL, k
        n_seen += 1
    assert n_seen == len(res["grads"])


@pytest.mark.parametrize("P,V", [(4, 1), (4, 2), (2, 2), (2, 1), (1, 1)])
def test_placement_matches_jax_stage_split_params(P, V):
    cj, ct = _cfgs("qwen")
    params = jax_init_lm(jax.random.PRNGKey(3), cj)
    split = jax_stage_split(params, P, V)["stacks"][0]
    stages = stage_split_params(
        params_from_jax(jax.tree.map(np.asarray, params), ct, device="cpu"),
        P, V)
    assert len(stages) == P
    for i, stage in enumerate(stages):
        assert stage.chunks == stage_layers(8, P, V, i)
        for v in range(V):
            for j, blk in enumerate(stage.chunk_blocks(v)):
                np.testing.assert_array_equal(
                    blk.attn.wq.detach().numpy(),
                    np.asarray(split["attn"]["wq"][i, v, j]))
                np.testing.assert_array_equal(
                    blk.mlp.w_down.detach().numpy(),
                    np.asarray(split["mlp"]["w_down"][i, v, j]))
        assert (stage.embed is not None) == (i == 0)
        assert (stage.head is not None) == (stage.final_norm is not None) \
            == (i == P - 1)


@pytest.mark.parametrize("arch,P,V", [("qwen", 4, 2), ("tied", 2, 1),
                                      ("mamba2", 4, 1)])
def test_init_stage_holds_init_lm_numbers(arch, P, V):
    """Each rank's drawn stage is its share of ``init_lm(seed=0)``."""
    ct = _cfgs(arch)[1]
    whole = stage_split_params(init_lm(ct, seed=0, device="cpu"), P, V)
    for i in range(P):
        drawn = init_stage(ct, P, V, i, seed=0, device="cpu")
        want = dict(whole[i].named_parameters())
        got = dict(drawn.named_parameters())
        assert got.keys() == want.keys()
        for k, t in got.items():
            assert torch.equal(t, want[k]), (i, k)


def test_hybrid_and_indivisible_depths_raise():
    cfg = get_config("zamba2-1.2b").reduced(n_layers=4)
    with pytest.raises(ValueError, match="homogeneous stack"):
        stage_split_params(init_lm(cfg, device="cpu"), 2)
    with pytest.raises(ValueError, match="homogeneous stack"):
        init_stage(cfg, 2, 1, 0, device="cpu")
    with pytest.raises(ValueError, match="not divisible"):
        stage_layers(8, 4, 3, 0)


@pytest.mark.parametrize("backend", ["nccl", "mpi"])
def test_hand_offs_and_sums_need_a_gloo_group(monkeypatch, backend):
    """Hand-offs and the sums over ``pipe`` and ``data`` carry host
    tensors over gloo only: a group of another backend raises before any
    message."""
    from repro_torch.runtime import pipeline

    monkeypatch.setattr(dist, "get_backend", lambda group=None: backend)
    with pytest.raises(ValueError, match="over gloo"):
        pipeline._host_sum(torch.zeros(()), object())
    with pytest.raises(ValueError, match="over gloo"):
        pipeline._Link(object(), 0, 2, torch.device("cpu"))


def _plan(pp, sched, vpp, m):
    return types.SimpleNamespace(pp_degree=pp, schedule=sched,
                                 vpp_degree=vpp, n_micro=m)


@pytest.mark.parametrize("plan,ranks,L,batch,want", [
    (_plan(4, "zb-h1", 1, 16), 4, 16, 4, ("zb-h1", 4, 1, 4, 1)),
    (_plan(4, "1f1b-interleaved", 2, 6), 8, 8, 12,
     ("1f1b-interleaved", 4, 2, 6, 2)),
    (_plan(4, "1f1b-interleaved", 2, 4), 4, 4, 8, ("1f1b", 4, 1, 4, 1)),
    (_plan(4, "1f1b-interleaved", 4, 16), 4, 16, 4,
     ("1f1b-interleaved", 4, 4, 4, 1)),
    (_plan(4, "1f1b", 1, 8), 6, 8, 8, ("1f1b", 2, 1, 8, 1)),
    (_plan(8, "gpipe", 1, 4), 4, 2, 6, ("gpipe", 2, 1, 2, 1)),
    (_plan(2, "1f1b", 1, 3079), 4, 4, 4, ("1f1b", 2, 1, 1, 2)),
    (_plan(4, "1f1b", 1, 8), 1, 16, 8, ("1f1b", 1, 1, 8, 1)),
], ids=["zb-h1", "interleaved-dp2", "interleave-degenerates", "v4",
        "six-ranks", "shallow", "one-micro-batch", "one-rank"])
def test_pipeline_layout_follows_the_jax_driver(plan, ranks, L, batch, want):
    lay = pipeline_layout(plan, ranks, L, batch)
    assert (lay.schedule, lay.n_stages, lay.n_chunks, lay.n_micro,
            lay.n_data) == want


def test_adamw_with_a_given_norm_is_adamw():
    """``grad_norm`` given as the norm of the grads changes nothing."""
    rng = np.random.default_rng(1)
    shapes = [(5, 3), (4,)]
    ps = [[torch.from_numpy(rng.standard_normal(s).astype(np.float32))
           for s in shapes]]
    ps.append([p.clone() for p in ps[0]])
    cfg = AdamWConfig(lr=1e-2, grad_clip=0.3)
    states = [adamw_init(p, cfg) for p in ps]
    for _ in range(2):
        g = [torch.from_numpy(rng.standard_normal(s).astype(np.float32))
             for s in shapes]
        a = adamw_update(ps[0], g, states[0], cfg)
        b = adamw_update(ps[1], g, states[1], cfg, grad_norm=global_norm(g))
        assert torch.equal(a["grad_norm"], b["grad_norm"])
    for x, y in zip(*ps):
        assert torch.equal(x, y)


def test_train_cli_pipeline_on_four_cpu_ranks(tmp_path, capsys):
    """``train --pipeline --ranks 4 --device cpu --reduced`` with a plan
    the port's search gives (pp 4, zb-h1, m 16): the JAX driver's rules
    give P 4, V 1, m 4; the first loss is the single-process loss of the
    same weights and batch."""
    from repro_torch.data import DataConfig, synthetic_lm_batches
    from repro_torch.launch import search as search_cli
    from repro_torch.models.transformer import lm_loss

    plan = tmp_path / "pp4.plan.json"
    assert search_cli.main([
        "--arch", "qwen3-4b", "--seq", "4096", "--cluster",
        "8x-h100-sxm-nvlink", "--devices", "4", "--budget", "24",
        "--max-pp", "4", "--schedules", "1f1b,zb-h1", "--batch-grid", "16",
        "--out", str(plan)]) == 0
    argv = ["--pipeline", "--ranks", "4", "--device", "cpu", "--reduced",
            "--layers", "4", "--d-model", "64", "--steps", "2", "--batch",
            "4", "--seq", "16", "--plan", str(plan), "--log-every", "1"]
    hist = train_main(argv)
    out = capsys.readouterr().out
    assert ("pipeline runtime: schedule=zb-h1 P=4 V=1 m=4 (plan asked zb-h1 "
            "P=4 V=1 m=16)") in out
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    cfg = get_config("qwen3-4b").reduced(n_layers=4, d_model=64)
    b = next(synthetic_lm_batches(DataConfig(seq_len=16, global_batch=4,
                                             vocab_size=cfg.vocab_size)))
    with torch.no_grad():
        want = lm_loss(init_lm(cfg, seed=0, device="cpu"),
                       {k: torch.from_numpy(v) for k, v in b.items()}, cfg)
    assert hist[0]["loss"] == pytest.approx(float(want), rel=2e-2)
