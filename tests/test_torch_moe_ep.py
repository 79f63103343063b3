"""Expert parallelism for the port's MoE layer against the JAX package, in
fp32 on the CPU.

* The gate: ``models/moe.py::expert_axis_usable`` against the reference's
  on a table of meshes (an ``expert`` axis of 1, none, an expert count it
  does not divide, a batch that does not split over data x expert).
* Gloo ranks: a module fixture starts 4 ranks with
  ``launch/mesh.py::run_ranks`` (spawn, a ``file://`` rendezvous, one
  thread each) and runs ``moe_ffn(shard=)`` on ``make_expert_mesh`` meshes
  of (data 2, expert 2) and (data 1, expert 4), on the reference test's
  cases (``tests/test_moe.py::test_ep_token_identical_on_8_device_mesh``):
  top-2 and top-1, drops at capacity factor 0.5, the shared and residual
  branches, 16 experts over fewer ranks, and 6 experts, which 4 ranks do
  not divide (the gate stays closed and the experts whole) and 2 ranks
  do.  JAX ``init_moe`` weights and inputs of 8 groups of 16 tokens.
  Each rank keeps its experts and its 8 / (data x expert) groups; the
  gathered output is held against JAX ``moe_ffn(dispatch="sort")`` on one
  device within atol = rtol = 2e-5 with the same argmax, the aux shares
  summed over the ranks within 2e-5, and the gradients of ``sum(out²) +
  aux`` (x gathered, every leaf summed over the ranks as the executor's
  ``reduce_grads`` sums them, then gathered) within 1e-5 of each leaf's
  largest magnitude of the single-process port's.  (Not JAX's: at top-1
  the router's gradient is the aux loss's alone, the combine weight v / v
  having none, and the two packages' rounding of that zero differs by
  1.8e-4 of it on one device.)  Beside the ranks, the first case runs
  through JAX ``_moe_ep`` itself on a (data 2, expert 4) mesh of 8 fake
  CPU devices in a subprocess, and the ranks' output is held against it.
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
from jax.sharding import AbstractMesh

from repro.models import moe as jax_moe
from repro_torch.launch.mesh import (init_distributed, make_expert_mesh,
                                     make_local_mesh, run_ranks)
from repro_torch.models.moe import expert_axis_usable, moe_ffn
from repro_torch.runtime import ShardContext, ShardPolicy
from test_torch_moe import _layer_cfgs, _port_moe

torch.set_num_threads(1)

WORLD = 4
TIMEOUT_S = 240
G, T, D = 8, 16, 16
TOL, GRAD_TOL = 2e-5, 1e-5

# (name, E, top_k, capacity factor, branches): the reference test's cases
# and its indivisible expert count
CASES = [("k2", 8, 2, 1.25, {}), ("k1", 8, 1, 1.25, {}),
         ("k2-drops", 8, 2, 0.5, {}),
         ("branches", 8, 2, 1.25, {"shared_expert_ff": 24,
                                   "dense_residual_ff": 16}),
         ("e16", 16, 2, 1.25, {}), ("e6", 6, 2, 1.25, {})]
# (name, (data, expert))
MESHES = [("2x2", (2, 2)), ("1x4", (1, 4))]
RUNS = [(f"{c[0]}-{m}", c, shape) for c in CASES for m, shape in MESHES]
RUN_NAMES = [r[0] for r in RUNS]
# the layer is called on its weights directly, so no ZeRO shard (which the
# executor gathers around a whole block)
POLICY = ShardPolicy(zero=False)


# --------------------------------------------------------------------------
# the gate
# --------------------------------------------------------------------------

GATE = [
    ("no-mesh", None, 8, 8),
    ("ep-1", {"data": 1, "expert": 1}, 8, 8),
    ("no-expert-axis", {"data": 4, "model": 2}, 8, 8),
    ("open-1x4", {"data": 1, "expert": 4}, 8, 8),
    ("open-2x4", {"data": 2, "expert": 4}, 8, 8),
    ("e16-over-8", {"data": 1, "expert": 8}, 16, 8),
    ("e6-over-4", {"data": 2, "expert": 4}, 6, 8),
    ("batch-6-over-2x2", {"data": 2, "expert": 2}, 8, 6),
    ("batch-2-over-1x4", {"data": 1, "expert": 4}, 8, 2),
]


@pytest.mark.parametrize("case", GATE, ids=[g[0] for g in GATE])
def test_expert_axis_usable_gate_table(case):
    """The port's gate, on a mapping and on the reference's meshes, equals
    the reference's ``expert_axis_usable`` (batch axes ``("data",)``)."""
    _, axes, E, batch = case
    cfg_j, cfg_t = _layer_cfgs(E=E, k=2)
    jmesh = (None if axes is None else
             AbstractMesh(tuple(axes.values()), tuple(axes)))
    want = jax_moe.expert_axis_usable(cfg_j, jmesh, batch,
                                      ("data",) if axes else None)
    assert expert_axis_usable(cfg_t, axes, batch) == want
    if axes is not None and "expert" in axes and axes["expert"] > 1:
        assert want == (E % axes["expert"] == 0
                        and batch % (axes["expert"] * axes["data"]) == 0)


# --------------------------------------------------------------------------
# gloo ranks
# --------------------------------------------------------------------------

def _jax_case(i, E, k, cf, branches, dispatch="sort"):
    """The reference test's weights and input for case ``i``, JAX
    ``moe_ffn`` on one device (out, aux), and the single-process port's
    gradients of sum(out²) + aux with respect to x and every weight
    leaf."""
    cfg_j = _layer_cfgs(E=E, k=k, cf=cf, **branches)[0]
    p = jax_moe.init_moe(jax.random.PRNGKey(i), cfg_j, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(100 + i), (G, T, D),
                          jnp.float32)

    out, aux = jax.jit(lambda p, x: jax_moe.moe_ffn(
        p, x, cfg_j, dispatch=dispatch))(p, x)
    p = jax.tree.map(np.asarray, p)
    moe = _port_moe(p)
    xt = torch.from_numpy(np.array(x)).requires_grad_(True)
    cfg_t = _layer_cfgs(E=E, k=k, cf=cf, **branches)[1]
    o, a = moe_ffn(moe, xt, cfg_t, dispatch=dispatch)
    leaves = list(moe.named_parameters())
    grads = torch.autograd.grad((o ** 2).sum() + a,
                                [xt] + [t for _, t in leaves])
    return {"p": p, "x": np.asarray(x), "out": np.asarray(out),
            "aux": float(aux), "grad_x": grads[0].numpy(),
            "grads": {n: g.numpy() for (n, _), g in zip(leaves, grads[1:])}}


def layer_on_ranks(mesh, policy, case, ref, dispatch="sort"):
    """``moe_ffn`` on this rank's share of the reference's weights and
    rows; the gathered output, the aux summed over the ranks, x's gathered
    gradient and every leaf's gradient summed and gathered."""
    _, E, k, cf, branches = case
    cfg = _layer_cfgs(E=E, k=k, cf=cf, **branches)[1]
    ctx = ShardContext(cfg, mesh, policy)
    moe = ctx.shard_part("blocks.0.moe", _port_moe(ref["p"]))
    lo, hi = ctx.lane_range(G)
    x = torch.from_numpy(ref["x"][lo:hi]).requires_grad_(True)
    out, aux = moe_ffn(moe, x, cfg, dispatch=dispatch, shard=ctx)
    leaves = list(moe.named_parameters())
    grads = torch.autograd.grad((out ** 2).sum() + aux,
                                [x] + [p for _, p in leaves])
    named = [(f"blocks.0.moe.{n}", p) for n, p in leaves]
    reduced = ctx.reduce_grads(named, grads[1:])
    return {"out": ctx.gather_lanes(out.detach(), G).numpy(),
            "aux": float(ctx.data_sum(aux.detach())),
            "grad_x": ctx.gather_lanes(grads[0], G).numpy(),
            "grads": {n: ctx.gather_tensor(f"blocks.0.moe.{n}", g).numpy()
                      for (n, _), g in zip(leaves, reduced)},
            "a2a_bytes": ctx.traffic.a2a_bytes}


def _worker(rank, world, init_file, out_dir, refs):
    torch.set_num_threads(1)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{init_file}", timeout_s=TIMEOUT_S)
    try:
        meshes = {shape: make_expert_mesh(shape[1], shape[0],
                                          device_type="cpu")
                  for _, shape in MESHES}
        out = {}
        for name, case, shape in RUNS:
            out[name] = layer_on_ranks(meshes[shape], POLICY, case,
                                       refs[case[0]])
        # the mesh's coordinates, and what the executor refuses on it
        mesh = meshes[(2, 2)]
        out["coord"] = [mesh.get_local_rank("data"),
                        mesh.get_local_rank("expert")]
        cfg = _layer_cfgs(E=8, k=2)[1]
        ctx = ShardContext(cfg, mesh, POLICY)
        moe = ctx.shard_part("blocks.0.moe", _port_moe(refs["k2"]["p"]))
        try:
            ctx.lane_range(G)
            moe_ffn(moe, torch.zeros(2, T, D), cfg, dispatch="einsum",
                    shard=ctx)
            out["einsum"] = None
        except NotImplementedError as e:
            out["einsum"] = str(e)
        try:
            ctx.lane_range(6)       # 6 rows do not split over 4 ranks
            moe_ffn(moe, torch.zeros(6, T, D), cfg, shard=ctx)
            out["rows"] = None
        except NotImplementedError as e:
            out["rows"] = str(e)
        out["policy"] = [ctx.policy.expert_axis, ctx.policy.ep_degree,
                         ctx.n_batch, ctx.batch_rank]
        local = make_local_mesh(2, device_type="cpu")
        ctx = ShardContext(cfg, local, ShardPolicy(expert_axis="expert",
                                                   ep_degree=2))
        out["local_policy"] = [ctx.policy.expert_axis, ctx.policy.ep_degree]
        if rank == 0:
            np.save(f"{out_dir}/results.npy", out, allow_pickle=True)
        gathered = [None] * world
        dist.all_gather_object(gathered, out["coord"])
        if rank == 0:
            pathlib.Path(f"{out_dir}/coords.json").write_text(
                json.dumps(gathered))
        dist.barrier()
    finally:
        dist.destroy_process_group()


JAX_EP = """
import json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.models.common import ModelConfig
from repro.models import moe as M
from repro.models import flags
cfg = ModelConfig(name="t", arch_type="moe", n_layers=1, d_model=16,
                  n_heads=4, n_kv_heads=4, d_ff=32, vocab_size=64,
                  n_experts=8, top_k=2, capacity_factor=1.25,
                  dtype=jnp.float32)
mesh = Mesh(np.array(jax.devices()).reshape(2, 4), ("data", "expert"))
p = M.init_moe(jax.random.PRNGKey(0), cfg, jnp.float32)
x = jax.random.normal(jax.random.PRNGKey(100), (8, 16, 16), jnp.float32)
with flags.batch_sharding(("data",), mesh=mesh):
    assert M.expert_axis_usable(cfg, mesh, 8, ("data",))
    out, aux = M._moe_ep(p, x, cfg, mesh, ("data",))
print("EP " + json.dumps({"out": np.asarray(out).tolist(),
                          "aux": float(aux)}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_ep")
    refs = {c[0]: _jax_case(i, *c[1:]) for i, c in enumerate(CASES)}
    with ThreadPoolExecutor(1) as pool:     # beside the ranks
        jax_run = pool.submit(run_subprocess, JAX_EP, devices=8,
                              timeout=TIMEOUT_S)
        run_ranks(_worker, (WORLD, str(tmp / "rendezvous"), str(tmp), refs),
                  WORLD, timeout_s=TIMEOUT_S)
        jax_out = jax_run.result()
    (line,) = [ln for ln in jax_out.splitlines() if ln.startswith("EP ")]
    return types.SimpleNamespace(
        res=np.load(tmp / "results.npy", allow_pickle=True).item(),
        refs=refs, jax_ep=json.loads(line[3:]),
        coords=json.loads((tmp / "coords.json").read_text()))


def _grad_close(got, want, what):
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= GRAD_TOL, f"{what}: {err:.2e}"


@pytest.mark.parametrize("run", RUNS, ids=RUN_NAMES)
def test_ep_layer_matches_jax_sort(runs, run):
    name, case = run[:2]
    res, ref = runs.res[name], runs.refs[case[0]]
    np.testing.assert_allclose(res["out"], ref["out"], atol=TOL, rtol=TOL)
    assert np.array_equal(np.argmax(res["out"].reshape(-1, D), -1),
                          np.argmax(ref["out"].reshape(-1, D), -1))
    assert res["aux"] == pytest.approx(ref["aux"], abs=TOL, rel=TOL)


@pytest.mark.parametrize("run", RUNS, ids=RUN_NAMES)
def test_ep_layer_gradients_match_the_single_process(runs, run):
    """x's gradient and every leaf's (the router's, replicated and summed
    over data x expert; the experts', summed over data) against the
    single-process port's."""
    name, case = run[:2]
    res, ref = runs.res[name], runs.refs[case[0]]
    _grad_close(res["grad_x"], ref["grad_x"], "x")
    assert set(res["grads"]) == set(ref["grads"])
    for leaf, g in res["grads"].items():
        _grad_close(g, ref["grads"][leaf], leaf)


@pytest.mark.parametrize("run", RUNS, ids=RUN_NAMES)
def test_the_all_to_all_runs_where_the_gate_opens(runs, run):
    """The experts split over ``expert`` travel by all-to-all; E = 6 on 4
    ranks keeps the gate closed, the experts whole and nothing sent."""
    name, case, (n_data, n_ep) = run
    opens = expert_axis_usable(_layer_cfgs(E=case[1], k=2)[1],
                               {"data": n_data, "expert": n_ep}, G)
    assert opens == (case[1] % n_ep == 0)
    assert (runs.res[name]["a2a_bytes"] > 0) == opens


@pytest.mark.parametrize("mesh", [m for m, _ in MESHES])
def test_ep_layer_matches_jax_moe_ep_on_8_devices(runs, mesh):
    """The first case against the reference's ``_moe_ep`` itself, on a
    (data 2, expert 4) mesh of 8 fake devices."""
    got = runs.res[f"k2-{mesh}"]
    np.testing.assert_allclose(got["out"], np.asarray(runs.jax_ep["out"]),
                               atol=TOL, rtol=TOL)
    assert got["aux"] == pytest.approx(runs.jax_ep["aux"], abs=TOL, rel=TOL)


def test_expert_mesh_coordinates_and_policy(runs):
    """Rank r at (r // 2, r % 2) on (data 2, expert 2); the batch's share
    is the world rank; the mesh decides the policy's expert axis."""
    assert runs.coords == [[0, 0], [0, 1], [1, 0], [1, 1]]
    assert runs.res["policy"] == ["expert", 2, 4, 0]
    assert runs.res["local_policy"] == ["model", 1]


def test_what_the_expert_mesh_refuses(runs):
    """einsum on experts split over ranks, and experts split over
    ``expert`` on rows that do not split over data x expert."""
    assert "einsum" in runs.res["einsum"]
    assert "does not split over 4 ranks" in runs.res["rows"]
