"""The dry run (``launch/dryrun.py``): one rank's step on the ``meta``
device over a mesh given as a mapping (``runtime/dry.py::DryMesh``),
held against the port's own real runs (the JAX dry run cannot be a live
oracle here: it compiles on 512 fake devices).

(i) and (ii): a module fixture starts 4 gloo ranks (``launch/mesh.py::
run_ranks``, spawn, a ``file://`` rendezvous under a temporary directory,
one thread each, a 240 s limit) that run one step of each case on the
CPU, in fp32, and count what each rank sent (``Traffic``: in all and by
opcode) and the bytes of its parameters, AdamW state, its rows of the
batch and its decode state.  The dry run of the same config, batch and
policy on the mapping of the same mesh must give every rank's numbers to
the byte.  The cases: reduced qwen3-4b (2 layers, d 128) training under
(data 2, model 2) TP + ZeRO-3 + remat; reduced kimi-k2 (2 layers, one
dense and one MoE, 16 experts) training under EP on (data 2, expert 2)
with ZeRO-3 and remat, whose all-to-all must carry bytes; reduced kimi-k2
training under (2, 2) TP + ZeRO-3 with ``seq_shard`` (the fault found by
the dry run's grid: ``ShardContext.block`` took a MoE block's ``(x,
aux)`` for a tensor; the loss with ``seq_shard`` must be the loss
without it within 1e-5); qwen3-4b's sharded prefill under TP; and its
decode step on a 16-slot cache whose context splits over ``model``.
Batches of 4 x 16 tokens from numpy with a seed.

(iii) On ``{"data": 1, "model": 1}`` the dry run's aten FLOPs equal
``FlopCounterMode``'s count of the same step on CPU tensors, exactly, with
the plain kernel versions (and the CPU path's ``sdpa_ref``/
``sdpa_chunked``) run outside the counter; the kernel charges equal the
formulas of ``PERF.md`` §6 at the test's shapes.

(iv) A multi-pod mapping ``{"pod": 2, "data": 2, "model": 2}`` (its rule
table drawn on the three axes, ``("pod", "data")`` entries) gives the
per-rank bytes of ``{"data": 4, "model": 2}``.

(v) Every (arch, shape) pair builds and counts on the production mesh (one
pod and two) at ``probe_depths``' first depth, or raises the reason
recorded in ``REFUSED`` (none is refused).

(vi) ``python -m repro_torch.launch.dryrun --arch mamba2-370m --shape
decode_32k`` prints ``dry-run: 1 ok, 0 failed``.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.utils._python_dispatch import _disable_current_modes

from repro_torch.configs import get_config
from repro_torch.kernels import meta, ops
from repro_torch.launch import dryrun
from repro_torch.launch.inputs import config_for_shape
from repro_torch.launch.mesh import (init_distributed, make_expert_mesh,
                                     make_local_mesh, make_production_mesh,
                                     run_ranks)
from repro_torch.models import attention
from repro_torch.models import init_decode_state
from repro_torch.models.common import INPUT_SHAPES, InputShape
from repro_torch.runtime import (ShardPolicy, init_serving_params,
                                 init_train_state, make_prefill_step,
                                 make_serve_step, make_sharded_loss,
                                 make_train_step)
from repro_torch.runtime.sharding import COLLECTIVES, Traffic

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
WORLD = 4
TIMEOUT_S = 240
B, S, CONTEXT = 4, 16, 16
SEQ_TOL = 1e-5
R1, R2 = (True,), (True, True)
# (name, model, mesh kind, (data, second axis), policy, mode)
CASES = [
    ("dense-tp-zero-remat", "dense", "model", (2, 2),
     dict(tp=True, zero=True, remat_segments=R1), "train"),
    ("moe-ep-zero-remat", "moe", "expert", (2, 2),
     dict(tp=False, zero=True, remat_segments=R2), "train"),
    ("moe-tp-zero-seq", "moe", "model", (2, 2),
     dict(tp=True, zero=True, seq_shard=True), "train"),
    ("dense-prefill-tp", "dense", "model", (2, 2),
     dict(tp=True, zero=False), "prefill"),
    ("dense-decode-ctx", "dense", "model", (2, 2),
     dict(tp=True, zero=False), "decode"),
]
CASE_NAMES = [c[0] for c in CASES]
# (arch, shape) pairs the port refuses, with the reason it raises
REFUSED = {}


def _cfg(model):
    if model == "dense":
        cfg = get_config("qwen3-4b").reduced(n_layers=2, d_model=128)
    else:
        cfg = get_config("kimi-k2-1t-a32b").reduced(n_layers=2,
                                                    n_experts=16)
    return cfg.with_(dtype=torch.float32)


def _shape(mode):
    return InputShape(mode, CONTEXT if mode == "decode" else S, B, mode)


def _axes(kind, dims):
    return {"data": dims[0], kind: dims[1]}


def _batch(cfg, mode):
    rng = np.random.default_rng(7)
    out = {"tokens": torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))}
    if mode == "train":
        out["labels"] = torch.from_numpy(
            rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32))
    return out


def _nbytes(ts):
    seen, n = set(), 0
    for t in ts:
        if id(t) not in seen:
            seen.add(id(t))
            n += t.numel() * t.element_size()
    return n


def _state_tensors(state):
    out = []
    for v in state.values():
        if isinstance(v, torch.Tensor):
            out.append(v)
        elif isinstance(v, list):
            for d in v:
                out += list(d.values()) if isinstance(d, dict) else list(d)
    return out


def _real(case, rank_mesh):
    """One step of ``case`` on this rank: what it sent and holds."""
    name, model, kind, dims, pk, mode = case
    cfg, pol = _cfg(model), ShardPolicy(**pk)
    batch = _batch(cfg, mode)
    out = {}
    state, opt = {}, {"master": [], "m": [], "v": []}
    if mode == "train":
        params, opt = init_train_state(cfg, mesh=rank_mesh, policy=pol,
                                       device="cpu")
        step = make_train_step(cfg, mesh=rank_mesh, policy=pol)
        local = step.shard.local_batch(batch, torch.device("cpu"))
        if pk.get("seq_shard"):         # the loss with and without it
            for seq in (True, False):
                fn = make_sharded_loss(cfg, rank_mesh, ShardPolicy(
                    **{**pk, "seq_shard": seq}))
                out[f"loss_seq{int(seq)}"] = fn(params, batch)[0].item()
        run = lambda: step(params, opt, batch)  # noqa: E731
    elif mode == "prefill":
        params = init_serving_params(cfg, mesh=rank_mesh, policy=pol,
                                     device="cpu")
        step = make_prefill_step(cfg, mesh=rank_mesh, policy=pol)
        lo, hi = step.shard.lane_range(B)
        local = {k: v[lo:hi] for k, v in batch.items()}
        run = lambda: step(params, batch)  # noqa: E731
    else:
        params = init_serving_params(cfg, mesh=rank_mesh, policy=pol,
                                     device="cpu")
        step = make_serve_step(cfg, mesh=rank_mesh, policy=pol)
        state = init_decode_state(cfg, B, CONTEXT, device="cpu",
                                  shard=step.shard)
        token = batch["tokens"][:, 0].contiguous()
        local = {"tokens": token}
        run = lambda: step(params, state, token)  # noqa: E731
    step.shard.traffic = Traffic()
    run()
    t = step.shard.traffic
    out.update(
        bytes_sent=t.bytes_sent, per_op=dict(t.per_op),
        param_bytes=_nbytes(list(params.parameters())),
        optimizer_bytes=_nbytes(opt["master"] + opt["m"] + opt["v"]),
        input_bytes=_nbytes(list(local.values())),
        state_bytes=_nbytes(_state_tensors(state)))
    return out


def _worker(rank, world, init_file, out_dir):
    torch.set_num_threads(1)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{init_file}", timeout_s=TIMEOUT_S)
    try:
        meshes, res = {}, {}
        for case in CASES:
            kind, dims = case[2], case[3]
            if (kind, dims) not in meshes:      # a collective: same order
                meshes[(kind, dims)] = (
                    make_local_mesh(dims[1], device_type="cpu")
                    if kind == "model" else
                    make_expert_mesh(dims[1], dims[0], device_type="cpu"))
            res[case[0]] = _real(case, meshes[(kind, dims)])
        allranks = [None] * world
        dist.all_gather_object(allranks, res)
        if rank == 0:
            (pathlib.Path(out_dir) / "ranks.json").write_text(
                json.dumps(allranks))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dryrun_ranks")
    run_ranks(_worker, (WORLD, str(tmp / "rendezvous"), str(tmp)), WORLD,
              timeout_s=TIMEOUT_S)
    return json.loads((tmp / "ranks.json").read_text())


def _dry(case):
    name, model, kind, dims, pk, mode = case
    return dryrun.dry_step(_cfg(model), _shape(mode), _axes(kind, dims),
                           policy=ShardPolicy(**pk))


@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_collective_bytes_equal_the_ranks(ranks, case):
    dry = _dry(case)
    assert dry.traffic.bytes_sent > 0
    assert set(dry.traffic.per_op) == set(COLLECTIVES)
    for r, res in enumerate(ranks):
        got = res[case[0]]
        assert got["bytes_sent"] == dry.traffic.bytes_sent, r
        assert got["per_op"] == dry.traffic.per_op, r
    if case[2] == "expert":
        assert dry.traffic.per_op["all-to-all"] > 0
    if case[5] == "train":
        assert dry.traffic.per_op["reduce-scatter"] > 0
        assert dry.traffic.per_op["all-reduce"] > 0
    if case[5] == "decode":         # the context merge gathers the parts
        assert dry.traffic.per_op["all-gather"] > 0


@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_argument_bytes_equal_the_ranks(ranks, case):
    dry = _dry(case)
    for r, res in enumerate(ranks):
        got = res[case[0]]
        for k in ("param_bytes", "optimizer_bytes", "input_bytes",
                  "state_bytes"):
            assert got[k] == getattr(dry, k), (r, k)
        assert dry.argument_bytes == sum(
            got[k] for k in ("param_bytes", "optimizer_bytes",
                             "input_bytes", "state_bytes"))
    if case[5] == "train":
        # fp32 parameters: the master copy and two fp32 moments, 3x
        assert dry.optimizer_bytes == 3 * dry.param_bytes
    if case[5] == "decode":
        assert dry.state_bytes > 0


def test_seq_shard_on_a_moe_model_keeps_the_loss(ranks):
    for res in ranks:
        got = res["moe-tp-zero-seq"]
        assert got["loss_seq1"] == pytest.approx(got["loss_seq0"],
                                                  rel=SEQ_TOL)


# --------------------------------------------------------------------------
# (iii) aten FLOPs against a CPU run; the kernels' formulas
# --------------------------------------------------------------------------

def _uncounted(plain):
    """``plain`` run outside every dispatch mode (no FLOP counter sees it),
    its backward too."""
    def run(*args, **kw):
        ts = [a for a in args if isinstance(a, torch.Tensor)]
        rest = [a for a in args if not isinstance(a, torch.Tensor)]

        class Fn(torch.autograd.Function):
            @staticmethod
            def forward(ctx, *tensors):
                ctx.save_for_backward(*tensors)
                with _disable_current_modes():
                    return plain(*tensors, *rest, **kw)

            @staticmethod
            def backward(ctx, *grads):
                xs = [t.detach().requires_grad_(t.is_floating_point())
                      for t in ctx.saved_tensors]
                with _disable_current_modes(), torch.enable_grad():
                    out = plain(*xs, *rest, **kw)
                    outs = out if isinstance(out, tuple) else (out,)
                    need = [x for x in xs if x.requires_grad]
                    gs = iter(torch.autograd.grad(outs, need, grads,
                                                  allow_unused=True))
                return tuple(next(gs) if x.requires_grad else None
                             for x in xs)

        return Fn.apply(*ts)
    return run


def _counts(cfg, shape, device, monkeypatch=None):
    if monkeypatch is not None:
        for mod, name in ((ops, "flash_attention_ref"),
                          (ops, "rmsnorm_ref"), (ops, "ssd_scan_ref"),
                          (attention, "sdpa_ref"),
                          (attention, "sdpa_chunked")):
            monkeypatch.setattr(mod, name, _uncounted(getattr(mod, name)))
    return dryrun.dry_step(cfg, shape, {"data": 1, "model": 1},
                           device=device)


@pytest.mark.parametrize("mode", ["train", "prefill"])
def test_aten_flops_equal_a_cpu_step(mode, monkeypatch):
    cfg = _cfg("dense")
    shape = InputShape(mode, S, 2, mode)
    dry = _counts(cfg, shape, "meta")
    cpu = _counts(cfg, shape, "cpu", monkeypatch)
    assert dry.aten_flops > 0
    assert dry.aten_flops == cpu.aten_flops
    assert dry.traffic.bytes_sent == cpu.traffic.bytes_sent == 0
    assert cpu.kernels.by_kernel == {}      # no meta call on the CPU
    assert dry.argument_bytes == cpu.argument_bytes


def test_kernel_charges_are_the_formulas():
    cfg = _cfg("dense")
    Bt, L = 2, cfg.n_layers
    H, KV, dh, d = cfg.n_heads, cfg.n_kv_heads, cfg.dh, cfg.d_model
    dry = _counts(cfg, InputShape("train", S, Bt, "train"), "meta")
    k = dry.kernels.by_kernel
    es = 4                                  # fp32
    pairs = S * (S + 1) // 2                # causal, no window
    q_b, kv_b = es * Bt * S * H * dh, es * Bt * S * KV * dh
    # remat: the forward runs again in the backward
    assert k["flash_attention"]["launches"] == 2 * L
    assert k["flash_attention"]["ops"] == 2 * L * 4 * Bt * pairs * H * dh
    assert k["flash_attention"]["bytes"] == 2 * L * (
        2 * q_b + 2 * kv_b + 4 * Bt * S * H)
    assert k["flash_attention_bwd"]["launches"] == L
    assert k["flash_attention_bwd"]["ops"] == L * 10 * Bt * pairs * H * dh
    assert k["flash_attention_bwd"]["bytes"] == L * (
        4 * q_b + 4 * kv_b + 4 * Bt * S * H)
    # RMSNorm: ln1, ln2 and the QK norms a layer (twice under remat), the
    # final norm once; 4 operations an element forward, 10 backward
    rows = Bt * S
    layer = 2 * rows * d + rows * H * dh + rows * KV * dh
    fwd, bwd = 2 * L * layer + rows * d, L * layer + rows * d
    assert k["rmsnorm"]["ops"] == 4 * fwd
    assert k["rmsnorm_bwd"]["ops"] == 10 * bwd
    assert k["rmsnorm"]["launches"] == 2 * L * 4 + 1
    assert k["rmsnorm_bwd"]["launches"] == L * 4 + 1
    assert dry.flops == dry.aten_flops + sum(v["ops"] for v in k.values())


def test_meta_kernel_formulas_one_call():
    """Each entry on ``meta`` charges its bound's formula: the decode's
    full cache, a window, the panel visit at its delta, the SSD scan."""
    c = meta.KernelCharges()
    e = torch.empty
    with meta.charge_kernels(c):
        q, kv = e(3, 1, 8, 64, device="meta"), e(3, 40, 2, 64, device="meta")
        ops.flash_attention(q, kv, kv, causal=False,
                            kv_len=e(3, dtype=torch.int32, device="meta"))
        q = e(1, 32, 4, 128, device="meta", dtype=torch.bfloat16)
        kv = e(1, 32, 2, 128, device="meta", dtype=torch.bfloat16)
        ops.flash_attention(q, kv, kv, causal=True, window=8)
        with torch.no_grad():
            ops.flash_partial(q, kv, kv, 32, causal=True)
        x = e(2, 64, 4, 16, device="meta")
        ops.ssd_scan(x, e(2, 64, 4, device="meta"), e(4, device="meta"),
                     e(2, 64, 1, 8, device="meta"),
                     e(2, 64, 1, 8, device="meta"), 16)
    k = c.by_kernel
    win = sum(min(s + 1, 8) for s in range(32))
    assert k["flash_attention"]["ops"] == (4 * 3 * 40 * 8 * 64
                                           + 4 * 1 * win * 4 * 128)
    assert k["flash_partial"]["ops"] == 4 * 32 * 32 * 4 * 128
    assert meta.admitted_pairs(32, 32, causal=True, window=None,
                               offset=32) == 32 * 32
    fwd, _ = meta.ssd_ops(2, 64, 4, 16, 8, 16)
    assert k["ssd_scan"]["ops"] == fwd
    assert k["ssd_scan"]["bytes"] == 4 * (2 * 2 * 64 * 4 * 16 + 2 * 64 * 4
                                          + 4 + 2 * 2 * 64 * 8)


# --------------------------------------------------------------------------
# (iv) the multi-pod mapping
# --------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_multi_pod_per_rank_bytes(mode):
    cfg, pol = _cfg("dense"), ShardPolicy(tp=True, zero=mode == "train",
                                          remat_segments=R1)
    shape = InputShape(mode, CONTEXT if mode == "decode" else S, 8, mode)
    pod = dryrun.dry_step(cfg, shape, {"pod": 2, "data": 2, "model": 2},
                          policy=pol)
    flat = dryrun.dry_step(cfg, shape, {"data": 4, "model": 2}, policy=pol)
    assert pod.traffic.per_op == flat.traffic.per_op
    assert pod.traffic.bytes_sent == flat.traffic.bytes_sent > 0
    assert pod.argument_bytes == flat.argument_bytes
    assert pod.aten_flops == flat.aten_flops


def test_multi_pod_rule_table_has_pod_entries():
    from repro_torch.runtime.dry import DryMesh
    from repro_torch.runtime.sharding import ShardContext
    ctx = ShardContext(get_config("qwen3-4b"), DryMesh(make_production_mesh(
        multi_pod=True)), ShardPolicy())
    assert ctx.n_batch == 64 and ctx.tp == 8
    assert any(("pod", "data") in spec for spec in ctx.specs.values())
    assert make_production_mesh() == {"data": 32, "model": 8}


# --------------------------------------------------------------------------
# (v) every pair on the production mesh; (vi) the CLI
# --------------------------------------------------------------------------

GRID = [(a, s, mp) for a in dryrun.ASSIGNED for s in dryrun.SHAPES
        for mp in (False, True)]


@pytest.mark.parametrize("arch,shape,multi_pod", GRID,
                         ids=[f"{a}-{s}-{'pod2' if mp else 'pod1'}"
                              for a, s, mp in GRID])
def test_every_pair_builds_on_the_production_mesh(arch, shape, multi_pod):
    st = INPUT_SHAPES[shape]
    cfg = config_for_shape(get_config(arch), st)
    cfg = dryrun.depth_scaled(cfg, dryrun.probe_depths(cfg)[0])
    axes = make_production_mesh(multi_pod=multi_pod)
    if (arch, shape) in REFUSED:
        with pytest.raises(Exception, match=REFUSED[(arch, shape)]):
            dryrun.dry_step(cfg, st, axes)
        return
    c = dryrun.dry_step(cfg, st, axes)
    assert c.flops > 0 and c.param_bytes > 0
    assert c.traffic.bytes_sent > 0
    if st.mode == "train":
        assert c.optimizer_bytes >= 3 * c.param_bytes   # 3 x fp32
        assert c.kernels.by_kernel     # every arch runs a kernel
    if st.mode == "decode":
        assert c.state_bytes > 0


def test_cli_prints_one_ok(tmp_path):
    out = tmp_path / "rows.jsonl"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "mamba2-370m", "--shape", "decode_32k", "--out", str(out)],
        capture_output=True, text=True, timeout=300,
        env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert res.returncode == 0, res.stderr
    assert "dry-run: 1 ok, 0 failed" in res.stdout
    row = json.loads(out.read_text())
    for key in ("argument_bytes", "output_bytes", "temp_bytes"):
        assert key in row["memory"]
    for key in ("t_compute_s", "t_memory_s", "t_collective_s",
                "t_memory_unfused_s", "modeled_fits_80g", "bottleneck",
                "per_op_collectives", "hlo_flops", "useful_flops_ratio"):
        assert key in row
    assert row["mesh"] == "32x8" and row["chips"] == 256
