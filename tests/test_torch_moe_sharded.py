"""Whole MoE models through the port's sharded executor, its sharded
checkpoints and its pipeline runtime, against the single-process port, in
fp32 on the CPU.

A module fixture starts 4 gloo ranks (``launch/mesh.py::run_ranks``) and
runs reduced arctic-480b (4 experts, top-2, the dense residual branch) and
reduced kimi-k2-1t-a32b (16 experts, top-8, a shared expert, its first
layer dense), from ``init_lm`` seed 0 on every rank (each rank drawing
only its experts, ``init_train_state``), under:

* TP on (data 2, model 2), with and without ZeRO;
* EP on (data 1, expert 4) and, with ZeRO, on (data 2, expert 2)
  (``make_expert_mesh``; the batch over data x expert);
* DP on (data 4, model 1).

Training: the loss of one batch of 4 x 32 tokens within 1e-5 relative of
the single process's ``lm_loss`` (the aux included) and every gathered
gradient leaf within 1e-5 of its largest magnitude, the router's leaf on
its own; then two ``make_train_step`` steps, each loss within 1e-5
relative.  Serving, greedy tokens identical to the single process's: the
dense-cache ``serve`` (recycled lanes) under DP, TP and EP, and
``serve_paged`` under DP and TP; the paged engine on an expert mesh raises
NotImplementedError.  Checkpoints: kimi's TP ranks and EP ranks each save
after their two steps (``save_sharded_train_state``); one process restores
each save and the ranks restore each into the other layout, every
parameter and AdamW leaf bit for bit.  The pipeline runtime: reduced
arctic at 4 layers on a (pipe 2, data 2) mesh, each schedule of
``test_torch_pipeline.py``, its loss within 1e-5 relative of the single
process's ``lm_loss`` with ``router_aux_coef`` 0 (the pipeline drops the
aux loss, as the reference's does) and every gradient leaf within 1e-5
of its largest magnitude; kimi-k2, two segments, is refused as the
reference's assert refuses it.

The CLIs on reduced arctic, which they run in bf16: ``train --ranks 2``
(the searched plan's policy on ``make_local_mesh()``) gives the
one-process CLI's first loss within 1e-5 relative (the same forward on
each rank's rows) and its second within 2e-3, the bf16 sharded-training
gate of ``PERF.md`` §2 (the bf16 gradients summed over ranks round
otherwise); ``serve --ranks 2`` gives its tokens on both engines.
"""
import copy
import types

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.checkpointing import (restore_sharded_train_state,
                                       restore_train_state,
                                       save_sharded_train_state)
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, synthetic_lm_batches
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import (init_distributed, make_expert_mesh,
                                     make_local_mesh, make_pipeline_mesh,
                                     run_ranks)
from repro_torch.models import init_lm, lm_loss
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime import (ShardPolicy, init_serving_params,
                                 init_train_state, make_sharded_loss,
                                 make_train_step)
from repro_torch.runtime.pipeline import (init_stage, make_pipeline_loss,
                                          stage_split_params)
from repro_torch.serving import EngineConfig, ServingEngine

torch.set_num_threads(1)

WORLD = 4
TIMEOUT_S = 300
B, S, STEPS = 4, 32, 2
TOL = 1e-5
BF16_RTOL = 2e-3
ARCHS = {"arctic": ("arctic-480b", {}),
         "kimi": ("kimi-k2-1t-a32b", {"n_experts": 16})}
TP, REP = dict(tp=True, zero=False), dict(tp=False, zero=False)
# (name, mesh kind, (data, second axis), policy)
MESHES = [("tp", "model", (2, 2), TP),
          ("tp-zero", "model", (2, 2), dict(tp=True, zero=True)),
          ("ep", "expert", (1, 4), REP),
          ("ep-zero", "expert", (2, 2), dict(tp=False, zero=True)),
          ("dp", "model", (4, 1), REP)]
TRAIN = [(f"{a}-{m[0]}", a, m) for a in ARCHS for m in MESHES]
SERVE = [(f"{a}-{m}-{e}", a, m, e) for a in ARCHS
         for m, e in (("dp", "dense"), ("tp", "dense"), ("ep", "dense"),
                      ("dp", "paged"), ("tp", "paged"))]
SCHEDULES = [("gpipe", 1), ("1f1b", 1), ("zb-h1", 1),
             ("1f1b-interleaved", 2)]
PIPE_M, PIPE_BM, PIPE_S = 4, 2, 16
LANES, CONTEXT = 4, 32
ECFG = EngineConfig(page_size=4, n_pages=32, decode_slots=4, max_context=32,
                    prefill_batch=2, prefill_chunk=8)


def _cfg(arch, **kw):
    name, red = ARCHS[arch]
    return get_config(name).reduced(**red, **kw).with_(dtype=torch.float32)


def _batches(cfg):
    it = synthetic_lm_batches(DataConfig(seq_len=S, global_batch=B,
                                         vocab_size=cfg.vocab_size, seed=3))
    return [{k: torch.from_numpy(v) for k, v in next(it).items()}
            for _ in range(STEPS)]


def _requests(cfg):
    rng = np.random.default_rng(4)
    return [serve_cli.Request(i, rng.integers(0, cfg.vocab_size, n).tolist(),
                              5) for i, n in enumerate([3, 7, 5, 9, 4, 11])]


def _serve(cfg, engine, **kw):
    reqs = _requests(cfg)
    if engine == "dense":
        mesh = kw.pop("mesh", None)
        params = init_serving_params(cfg, mesh=mesh, device="cpu", **kw)
        serve_cli.serve(cfg, reqs, LANES, CONTEXT, verbose=False,
                        device="cpu", params=params, mesh=mesh, **kw)
    else:
        serve_cli.serve_paged(cfg, reqs, ECFG, verbose=False, device="cpu",
                              **kw)
    return [r.generated for r in reqs]


def _pipe_batch(cfg):
    rng = np.random.default_rng(5)
    shape = (PIPE_M, PIPE_BM, PIPE_S)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, shape,
                                             dtype=np.int32))
            for k in ("tokens", "labels")}


def _whole(ctx, named, leaves):
    return {n: ctx.gather_tensor(n, t).numpy()
            for (n, _), t in zip(named, leaves)}


def _state(ctx, params, opt):
    """Every parameter and AdamW leaf gathered whole."""
    named = list(params.named_parameters())
    return {"params": _whole(ctx, named, [p for _, p in named]),
            **{k: _whole(ctx, named, opt[k]) for k in ("master", "m", "v")}}


def _worker(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{init_file}", timeout_s=TIMEOUT_S)
    try:
        meshes, out = {}, {}
        for name, kind, shape, _ in MESHES:   # collectives: same order
            if (kind, shape) not in meshes:
                meshes[(kind, shape)] = (
                    make_local_mesh(shape[1], device_type="cpu")
                    if kind == "model" else
                    make_expert_mesh(shape[1], shape[0], device_type="cpu"))
        mesh_of = {n: (meshes[(k, s)], ShardPolicy(**pk))
                   for n, k, s, pk in MESHES}
        opt_cfg = AdamWConfig(lr=1e-3)
        for name, arch, (m, *_) in TRAIN:
            cfg = _cfg(arch)
            mesh, pol = mesh_of[m]
            batches = _batches(cfg)
            params, opt = init_train_state(cfg, mesh=mesh, policy=pol,
                                           seed=0, opt_cfg=opt_cfg,
                                           device="cpu")
            fn = make_sharded_loss(cfg, mesh, pol)
            loss, grads = fn(params, batches[0])
            named = list(params.named_parameters())
            res = {"loss": float(loss),
                   "grads": _whole(fn.shard, named, grads)}
            step = make_train_step(cfg, opt_cfg, mesh=mesh, policy=pol)
            res["losses"] = [float(step(params, opt, b)["loss"])
                             for b in batches]
            if arch == "kimi" and m in ("tp", "ep"):
                save_sharded_train_state(STEPS, params, opt, step.shard,
                                         f"{out_dir}/ckpt-{m}")
                res["state"] = _state(step.shard, params, opt)
            out[name] = res
        # each save restored into the other layout
        cfg = _cfg("kimi")
        for saved, into in (("tp", "ep"), ("ep", "tp")):
            mesh, pol = mesh_of[into]
            params, opt = init_train_state(cfg, mesh=mesh, policy=pol,
                                           seed=9, device="cpu")
            step = make_train_step(cfg, mesh=mesh, policy=pol)
            _, _, at = restore_sharded_train_state(
                params, opt, step.shard, f"{out_dir}/ckpt-{saved}")
            out[f"restore-{saved}-into-{into}"] = {
                "step": at, "state": _state(step.shard, params, opt)}
        for name, arch, m, engine in SERVE:
            mesh, pol = mesh_of[m]
            out[name] = _serve(_cfg(arch), engine, mesh=mesh, policy=pol)
        mesh, pol = mesh_of["ep"]
        try:
            ServingEngine(_cfg("arctic"), init_lm(_cfg("arctic"),
                                                  device="cpu"),
                          ECFG, device="cpu", mesh=mesh, policy=pol)
            out["paged-ep"] = None
        except NotImplementedError as e:
            out["paged-ep"] = str(e)
        # the pipeline: arctic's one MoE stack on (pipe 2, data 2)
        pipe = make_pipeline_mesh(2, 2, device_type="cpu")
        cfg = _cfg("arctic", n_layers=4)
        i = pipe.get_local_rank("pipe")
        for sched, V in SCHEDULES:
            stage = init_stage(cfg, 2, V, i, seed=0, device="cpu")
            fn = make_pipeline_loss(cfg, pipe, PIPE_M, schedule=sched,
                                    n_chunks=V)
            loss, grads = fn(stage, _pipe_batch(cfg))
            gathered = [None] * world
            dist.all_gather_object(gathered, {
                n: g.numpy() for (n, _), g in zip(stage.named_parameters(),
                                                  grads)})
            merged = {}
            for g in gathered:
                merged.update(g)
            out[f"pipe-{sched}"] = {"loss": float(loss), "grads": merged}
        if rank == 0:
            np.save(f"{out_dir}/results.npy", out, allow_pickle=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _reference(arch):
    """The single process: loss and gradients of the first batch, two
    train steps' losses, and the serving engines' tokens."""
    cfg = _cfg(arch)
    batches = _batches(cfg)
    params = init_lm(cfg, seed=0, device="cpu")
    loss = lm_loss(params, batches[0], cfg)
    named = list(params.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    ref = {"loss": float(loss.detach()),
           "grads": {n: g.numpy() for (n, _), g in zip(named, grads)}}
    opt_cfg = AdamWConfig(lr=1e-3)
    params, opt = init_train_state(cfg, seed=0, opt_cfg=opt_cfg,
                                   device="cpu")
    step = make_train_step(cfg, opt_cfg)
    ref["losses"] = [float(step(params, opt, b)["loss"]) for b in batches]
    ref["dense"] = _serve(cfg, "dense")
    ref["paged"] = _serve(cfg, "paged")
    return ref


def _pipe_reference():
    cfg = _cfg("arctic", n_layers=4).with_(router_aux_coef=0.0)
    b = _pipe_batch(cfg)
    flat = {k: v.reshape(PIPE_M * PIPE_BM, PIPE_S) for k, v in b.items()}
    params = init_lm(cfg, seed=0, device="cpu")
    loss = lm_loss(params, flat, cfg)
    named = list(params.named_parameters())
    grads = torch.autograd.grad(loss, [p for _, p in named])
    return {"loss": float(loss.detach()),
            "grads": {n: g.numpy() for (n, _), g in zip(named, grads)}}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_sharded")
    refs = {arch: _reference(arch) for arch in ARCHS}
    refs["pipe"] = _pipe_reference()
    run_ranks(_worker, (WORLD, str(tmp / "rendezvous"), str(tmp)), WORLD,
              timeout_s=TIMEOUT_S)
    return types.SimpleNamespace(
        res=np.load(tmp / "results.npy", allow_pickle=True).item(),
        refs=refs, tmp=tmp)


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("run", TRAIN, ids=[t[0] for t in TRAIN])
def test_sharded_moe_loss_and_gradients_match_the_single_process(runs, run):
    """Every leaf on its own, the routers' included: under TP a router's
    combine part is summed over ``model`` and its aux part counted once;
    under EP the aux is the mean over data x expert."""
    name, arch = run[:2]
    res, ref = runs.res[name], runs.refs[arch]
    assert res["loss"] == pytest.approx(ref["loss"], rel=TOL)
    assert set(res["grads"]) == set(ref["grads"])
    for leaf, g in res["grads"].items():
        assert _rel(g, ref["grads"][leaf]) <= TOL, leaf


@pytest.mark.parametrize("run", TRAIN, ids=[t[0] for t in TRAIN])
def test_sharded_moe_train_steps_match_the_single_process(runs, run):
    name, arch = run[:2]
    got, want = runs.res[name]["losses"], runs.refs[arch]["losses"]
    assert got == pytest.approx(want, rel=TOL)


@pytest.mark.parametrize("run", SERVE, ids=[s[0] for s in SERVE])
def test_sharded_moe_serving_gives_the_single_process_tokens(runs, run):
    name, arch, _, engine = run
    assert runs.res[name] == runs.refs[arch][engine]
    assert all(len(t) == 5 for t in runs.res[name])


def test_the_paged_engine_refuses_an_expert_mesh(runs):
    msg = runs.res["paged-ep"]
    assert msg is not None and "expert mesh" in msg


@pytest.mark.parametrize("saved", ["tp", "ep"])
def test_sharded_moe_checkpoint_restores_in_one_process(runs, saved):
    """kimi's saved state restored by one process is every rank's
    gathered state, bit for bit."""
    want = runs.res[f"kimi-{saved}"]["state"]
    cfg = _cfg("kimi")
    params = init_lm(cfg, seed=7, device="cpu")
    opt = adamw_init(list(params.parameters()), AdamWConfig())
    _, _, step = restore_train_state(params, opt,
                                     runs.tmp / f"ckpt-{saved}")
    assert step == STEPS
    named = list(params.named_parameters())
    got = {"params": {n: p.detach().numpy() for n, p in named},
           **{k: {n: t.numpy() for (n, _), t in zip(named, opt[k])}
              for k in ("master", "m", "v")}}
    for part, leaves in want.items():
        for n, w in leaves.items():
            assert np.array_equal(got[part][n], w), (part, n)


@pytest.mark.parametrize("saved,into", [("tp", "ep"), ("ep", "tp")])
def test_sharded_moe_checkpoint_restores_in_the_other_layout(runs, saved,
                                                             into):
    got = runs.res[f"restore-{saved}-into-{into}"]
    want = runs.res[f"kimi-{saved}"]["state"]
    assert got["step"] == STEPS
    for part, leaves in want.items():
        for n, w in leaves.items():
            assert np.array_equal(got["state"][part][n], w), (part, n)


@pytest.mark.parametrize("sched", [s for s, _ in SCHEDULES])
def test_pipelined_arctic_matches_the_single_process_without_aux(runs,
                                                                 sched):
    res, ref = runs.res[f"pipe-{sched}"], runs.refs["pipe"]
    assert res["loss"] == pytest.approx(ref["loss"], rel=TOL)
    assert set(res["grads"]) == set(ref["grads"])
    for leaf, g in res["grads"].items():
        assert _rel(g, ref["grads"][leaf]) <= TOL, leaf


@pytest.mark.parametrize("call", ["stage_split_params", "init_stage"])
def test_the_pipeline_refuses_kimis_two_segments(call):
    cfg = _cfg("kimi")
    with pytest.raises(ValueError, match="homogeneous stack"):
        if call == "stage_split_params":
            stage_split_params(init_lm(cfg, device="cpu"), 2)
        else:
            init_stage(cfg, 2, 1, 0, device="cpu")


def test_arctic_stages_split_its_moe_stack():
    """arctic's one MoE stack splits into stages holding the same
    tensors."""
    cfg = _cfg("arctic", n_layers=4)
    whole = init_lm(cfg, seed=0, device="cpu")
    stages = stage_split_params(copy.deepcopy(whole), 2)
    for i, st in enumerate(stages):
        drawn = init_stage(cfg, 2, 1, i, seed=0, device="cpu")
        for (n, a), (m, b) in zip(st.named_parameters(),
                                  drawn.named_parameters()):
            assert n == m and torch.equal(a, b), n


# --------------------------------------------------------------------------
# the CLIs
# --------------------------------------------------------------------------

def test_train_cli_ranks_trains_moe(capsys):
    argv = ["--arch", "arctic-480b", "--reduced", "--device", "cpu",
            "--steps", "2", "--batch", "4", "--seq", "16", "--log-every",
            "1"]
    many = train_cli.main(argv + ["--ranks", "2"])
    assert "mesh={'data': 2, 'model': 1}" in capsys.readouterr().out
    one = train_cli.main(argv + ["--ranks", "1"])
    assert many[0]["loss"] == pytest.approx(one[0]["loss"], rel=TOL)
    assert many[1]["loss"] == pytest.approx(one[1]["loss"], rel=BF16_RTOL)


@pytest.mark.parametrize("engine", ["paged", "dense"])
def test_serve_cli_ranks_serves_moe(engine):
    argv = ["--arch", "arctic-480b", "--device", "cpu", "--engine", engine,
            "--requests", "5", "--batch", "4", "--max-new", "4",
            "--context", "32"]
    many = serve_cli.main(argv + ["--ranks", "2"])
    one = serve_cli.main(argv + ["--ranks", "1"])
    assert [r.generated for r in many] == [r.generated for r in one]
    assert all(len(r.generated) == 4 for r in many)
