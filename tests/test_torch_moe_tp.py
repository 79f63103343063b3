"""Tensor parallelism for the port's MoE layer (``models/moe.py::_moe_tp``,
the reference's ``_moe_shmap``) against the JAX package, in fp32 on the
CPU.

A module fixture starts 4 gloo ranks with ``launch/mesh.py::run_ranks`` and
runs ``moe_ffn(shard=)`` on a (data 2, model 2) ``make_local_mesh`` with
``ShardPolicy(tp=True, zero=False)``: each rank holds half the experts and
half of the shared expert's and the residual branch's columns, routes its
data rank's 4 groups whole, and the partial outputs are summed over
``model``.  The cases of ``test_torch_moe_ep.py`` (the reference EP test's
and 6 experts):

* ``dispatch="sort"``: the gathered output within atol = rtol = 2e-5 of
  JAX ``moe_ffn(dispatch="sort")`` on one device, the same argmax, the aux
  shares summed over ``data`` within 2e-5; the gradients of ``sum(out²) +
  aux`` within 1e-5 of each leaf's largest magnitude of the single-process
  port's.  The router's gradient is checked as a leaf of its own: its
  combine-weight part is partial on each ``model`` rank (each rank's
  experts only) and must be summed over ``model``, its aux part whole on
  every rank and counted once.
* ``dispatch="grouped"``: against JAX ``_moe_grouped`` on one device, the
  aux joint over the global batch.
* ``dispatch="shmap"``: against JAX ``_moe_shmap`` itself on a (data 2,
  model 2) mesh of 4 fake CPU devices in a subprocess beside the ranks
  (its aux is the mean of each data shard's joint aux), within 1e-4, the
  tolerance of the reference's 16-device test.
"""
import json
import types
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch
import torch.distributed as dist
from conftest import run_subprocess

from repro_torch.launch.mesh import (init_distributed, make_local_mesh,
                                     run_ranks)
from repro_torch.runtime import ShardPolicy
from test_torch_moe_ep import (CASES, TOL, D, _grad_close, _jax_case,
                               layer_on_ranks)

torch.set_num_threads(1)

WORLD = 4
TIMEOUT_S = 240
SHMAP_TOL = 1e-4
POLICY = ShardPolicy(tp=True, zero=False)
BY_NAME = {c[0]: (i, c) for i, c in enumerate(CASES)}
# (name, case, dispatch)
RUNS = ([(f"{c[0]}-sort", c[0], "sort") for c in CASES]
        + [("k2-grouped", "k2", "grouped"),
           ("branches-grouped", "branches", "grouped")])
SHMAP = ["k2", "k2-drops", "branches", "e16"]


def _worker(rank, world, init_file, out_dir, refs):
    torch.set_num_threads(1)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{init_file}", timeout_s=TIMEOUT_S)
    try:
        mesh = make_local_mesh(2, device_type="cpu")
        out = {}
        for name, case, dispatch in RUNS:
            out[name] = layer_on_ranks(mesh, POLICY, BY_NAME[case][1],
                                       refs[(case, dispatch)], dispatch)
        for case in SHMAP:
            out[f"{case}-shmap"] = layer_on_ranks(
                mesh, POLICY, BY_NAME[case][1], refs[(case, "sort")],
                "shmap")
        if rank == 0:
            np.save(f"{out_dir}/results.npy", out, allow_pickle=True)
        dist.barrier()
    finally:
        dist.destroy_process_group()


JAX_SHMAP = """
import json, numpy as np, jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.models.common import ModelConfig
from repro.models import moe as M
from repro.models import flags
mesh = Mesh(np.array(jax.devices()).reshape(2, 2), ("data", "model"))
for name, i, E, k, cf, br in CASES:
    cfg = ModelConfig(name="t", arch_type="moe", n_layers=1, d_model=16,
                      n_heads=4, n_kv_heads=4, d_ff=32, vocab_size=64,
                      n_experts=E, top_k=k, capacity_factor=cf,
                      dtype=jnp.float32, **br)
    p = M.init_moe(jax.random.PRNGKey(i), cfg, jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(100 + i), (8, 16, 16),
                          jnp.float32)
    with flags.batch_sharding(("data",), mesh=mesh):
        out, aux = M.moe_ffn(p, x, cfg, dispatch="shmap")
    print("SHMAP " + json.dumps({"name": name,
                                 "out": np.asarray(out).tolist(),
                                 "aux": float(aux)}))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("moe_tp")
    refs = {(case, dispatch): _jax_case(BY_NAME[case][0],
                                        *BY_NAME[case][1][1:], dispatch)
            for _, case, dispatch in RUNS}
    code = JAX_SHMAP.replace("CASES", repr(
        [(c, BY_NAME[c][0], *BY_NAME[c][1][1:]) for c in SHMAP]))
    with ThreadPoolExecutor(1) as pool:     # beside the ranks
        jax_run = pool.submit(run_subprocess, code, devices=4,
                              timeout=TIMEOUT_S)
        run_ranks(_worker, (WORLD, str(tmp / "rendezvous"), str(tmp), refs),
                  WORLD, timeout_s=TIMEOUT_S)
        jax_out = jax_run.result()
    shmap = {}
    for line in jax_out.splitlines():
        if line.startswith("SHMAP "):
            r = json.loads(line[len("SHMAP "):])
            shmap[r["name"]] = r
    return types.SimpleNamespace(
        res=np.load(tmp / "results.npy", allow_pickle=True).item(),
        refs=refs, shmap=shmap)


@pytest.mark.parametrize("run", RUNS, ids=[r[0] for r in RUNS])
def test_tp_layer_matches_jax(runs, run):
    name, case, dispatch = run
    res, ref = runs.res[name], runs.refs[(case, dispatch)]
    np.testing.assert_allclose(res["out"], ref["out"], atol=TOL, rtol=TOL)
    assert np.array_equal(np.argmax(res["out"].reshape(-1, D), -1),
                          np.argmax(ref["out"].reshape(-1, D), -1))
    assert res["aux"] == pytest.approx(ref["aux"], abs=TOL, rel=TOL)
    assert res["a2a_bytes"] == 0


@pytest.mark.parametrize("run", RUNS, ids=[r[0] for r in RUNS])
def test_tp_layer_gradients_match_the_single_process(runs, run):
    """x's gradient and every leaf's, the router's on its own: neither its
    combine part left partial (one ``model`` rank's experts) nor its aux
    part counted twice, each of which moves it far past the tolerance."""
    name, case, dispatch = run
    res, ref = runs.res[name], runs.refs[(case, dispatch)]
    _grad_close(res["grad_x"], ref["grad_x"], "x")
    assert set(res["grads"]) == set(ref["grads"])
    for leaf, g in res["grads"].items():
        _grad_close(g, ref["grads"][leaf], leaf)


@pytest.mark.parametrize("case", SHMAP)
def test_tp_shmap_matches_jax_moe_shmap_on_4_devices(runs, case):
    res, ref = runs.res[f"{case}-shmap"], runs.shmap[case]
    np.testing.assert_allclose(res["out"], np.asarray(ref["out"]),
                               atol=SHMAP_TOL, rtol=SHMAP_TOL)
    assert res["aux"] == pytest.approx(ref["aux"], abs=SHMAP_TOL,
                                       rel=SHMAP_TOL)
