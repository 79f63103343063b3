"""The port's sharding rule table and plan bridge against the JAX
package's, on the CPU, without ranks.

- Spec tables: each parameter of the full-width qwen3-4b, mamba2-370m,
  zamba2-1.2b and whisper-medium (port: on the ``meta`` device; JAX:
  ``jax.eval_shape`` of ``init_lm``, or ``init_encdec``)
  through ``runtime/sharding.py::param_specs`` against JAX
  ``param_shardings`` on an ``AbstractMesh`` of the same axes, each port
  leaf mapped to its JAX path by ``bridge.jax_path`` and a block's leading
  layer entry dropped; meshes (8, 1), (4, 2), (2, 4), (16, 16) and the pod
  (2, 16, 16); every ``tp``/``zero`` pair.  Also the AdamW state
  (``opt_shardings``) and batches with ``sp_degree``/``ep_degree``.
- ``ShardPolicy.from_strategy``, ``policy_from_plan`` (with and without
  layer specs; ``sp_degree``/``ep_degree`` carried; the ``seq_shard``
  rule, which fires for qwen3-4b at a small HBM budget) and
  ``modeled_memory`` over a grid: equal to JAX, field by field.
- ``schedule_program_from_plan``'s tables equal JAX's; ``PLN004`` and
  ``PLN006`` raised as in ``tests/test_plan_lint.py``.
All comparisons are exact: the same Python arithmetic on the same inputs.
"""
import dataclasses
import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.configs.specs import layerspecs_for as jax_layerspecs
from repro.core import ParallelPlan as JaxPlan
from repro.core import Strategy as JaxStrategy
from repro.models.encdec import init_encdec as jax_init_encdec
from repro.models.transformer import init_lm as jax_init_lm
from repro.optim import adamw_init as jax_adamw_init
from repro.roofline.analysis import modeled_memory as jax_modeled_memory
from repro.runtime import plan_bridge as jax_bridge
from repro.runtime.sharding import ShardPolicy as JaxPolicy
from repro.runtime.sharding import batch_shardings as jax_batch_shardings
from repro.runtime.sharding import opt_shardings as jax_opt_shardings
from repro.runtime.sharding import param_shardings as jax_param_shardings
from repro_torch.analysis import DiagnosticError
from repro_torch.bridge import jax_path
from repro_torch.configs import get_config
from repro_torch.configs.specs import layerspecs_for
from repro_torch.core import ParallelPlan, Strategy
from repro_torch.roofline import HBM_BW, modeled_memory
from repro_torch.runtime import (ShardPolicy, abstract_params, batch_specs,
                                 opt_specs, param_specs,
                                 pipeline_loss_from_plan, policy_from_plan,
                                 schedule_program_from_plan)

torch.set_num_threads(1)

ARCHS = ("qwen3-4b", "mamba2-370m", "zamba2-1.2b", "whisper-medium")
MESHES = {"8x1": ((8, 1), ("data", "model")),
          "4x2": ((4, 2), ("data", "model")),
          "2x4": ((2, 4), ("data", "model")),
          "16x16": ((16, 16), ("data", "model")),
          "pod": ((2, 16, 16), ("pod", "data", "model"))}
PAIRS = [(tp, zero) for tp in (False, True) for zero in (False, True)]


def _norm(entries, nd):
    """A spec as a tuple of nd tuples of axis names (a bare name as a
    one-name tuple, None as the empty tuple)."""
    entries = list(entries) + [None] * (nd - len(entries))
    return tuple(() if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in entries)


def _key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


@functools.lru_cache(maxsize=None)
def _jax_abstract(arch):
    cfg = jax_get_config(arch)
    init = jax_init_encdec if cfg.is_encoder_decoder else jax_init_lm
    return jax.eval_shape(lambda k: init(k, cfg), jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_abstract(arch):
    return abstract_params(get_config(arch))


def _flat(tree):
    return {_key(p): x for p, x in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


def _port_vs_jax(port_specs, jax_flat, names_shapes):
    """Each port leaf's spec against its JAX leaf's, layer entry dropped."""
    for name, shape in names_shapes:
        path, layer = jax_path(name)
        js = jax_flat[path]
        leaf_nd = len(shape)
        if layer is None:
            want = _norm(js.spec, leaf_nd)
        else:
            want = _norm(js.spec, leaf_nd + 1)[1:]
        assert _norm(port_specs[name], leaf_nd) == want, (name, path)


@pytest.mark.parametrize("tp,zero", PAIRS, ids=lambda v: str(v))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_jax_param_shardings(arch, mesh, tp, zero):
    shape, names = MESHES[mesh]
    amesh = AbstractMesh(shape, names)
    aparams = _jax_abstract(arch)
    jax_specs = _flat(jax_param_shardings(aparams, amesh,
                                          JaxPolicy(tp=tp, zero=zero)))
    port = _port_abstract(arch)
    got = param_specs(port, dict(zip(names, shape)),
                      ShardPolicy(tp=tp, zero=zero))
    named = [(n, tuple(p.shape)) for n, p in port.named_parameters()]
    # every JAX leaf is some port leaf's (the bridge's naming rule)
    assert {jax_path(n)[0] for n, _ in named} == set(jax_specs)
    for n, s in named:
        path, layer = jax_path(n)
        jshape = tuple(_flat(aparams)[path].shape)
        assert jshape == (s if layer is None else (jshape[0], *s)), n
    _port_vs_jax(got, jax_specs, named)


@pytest.mark.parametrize("mesh", ["4x2", "pod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_opt_specs_equal_jax_opt_shardings(arch, mesh):
    shape, names = MESHES[mesh]
    amesh = AbstractMesh(shape, names)
    aparams = _jax_abstract(arch)
    aopt = jax.eval_shape(jax_adamw_init, aparams)
    jflat = _flat(jax_opt_shardings(aopt, amesh, JaxPolicy()))
    port = _port_abstract(arch)
    got = opt_specs(port, dict(zip(names, shape)), ShardPolicy())
    assert got["step"] == () and _norm(jflat["step"].spec, 0) == ()
    named = [(n, tuple(p.shape)) for n, p in port.named_parameters()]
    for part in ("master", "m", "v"):
        specs = dict(zip([n for n, _ in named], got[part]))
        sub = {k[len(part) + 1:]: v for k, v in jflat.items()
               if k.startswith(part + "/")}
        _port_vs_jax(specs, sub, named)


@pytest.mark.parametrize("sp,ep,shape,names", [
    (1, 1, (8, 1), ("data", "model")),
    (1, 1, (2, 16, 16), ("pod", "data", "model")),
    (2, 1, (4, 2), ("data", "seq")),
    (4, 1, (2, 4), ("data", "seq")),
    (1, 2, (4, 2), ("data", "expert")),
    (2, 2, (2, 2, 2), ("data", "seq", "expert")),
    (1, 1, (3, 1), ("data", "model")),
], ids=["dp", "pod", "sp2", "sp4", "ep2", "sp2-ep2", "indivisible"])
def test_batch_specs_equal_jax_batch_shardings(sp, ep, shape, names):
    amesh = AbstractMesh(shape, names)
    batch = {"tokens": (8, 4096), "labels": (8, 4096), "lengths": (8,)}
    jpol = JaxPolicy(sp_degree=sp, ep_degree=ep)
    jax_out = jax_batch_shardings(
        {k: jax.ShapeDtypeStruct(s, np.int32) for k, s in batch.items()},
        amesh, jpol)
    got = batch_specs(batch, dict(zip(names, shape)),
                      ShardPolicy(sp_degree=sp, ep_degree=ep))
    for k, s in batch.items():
        assert _norm(got[k], len(s)) == _norm(jax_out[k].spec, len(s)), k
    no_pol = jax_batch_shardings(
        {k: jax.ShapeDtypeStruct(s, np.int32) for k, s in batch.items()},
        amesh)
    got = batch_specs(batch, dict(zip(names, shape)))
    for k, s in batch.items():
        assert _norm(got[k], len(s)) == _norm(no_pol[k].spec, len(s)), k


# --------------------------------------------------------------------------
# policies, the memory model, the schedule bridge
# --------------------------------------------------------------------------

LEVELS = [(("dp", 4),), (("sdp", 4),), (("tp", 4),),
          (("dp", 2), ("tp", 2)), (("sdp", 16), ("tp", 16)),
          (("sdp", 2), ("tp", 2), ("dp", 2))]


def _strategies(seed, n):
    """n (port, JAX) strategies, a seeded mix of LEVELS and ckpt."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        lv, ck = LEVELS[rng.integers(len(LEVELS))], bool(rng.integers(2))
        out.append((Strategy(lv, ckpt=ck), JaxStrategy(lv, ckpt=ck)))
    return out


def _plans(cfg_layers, n_strat, *, sp=1, ep=1, batch=256, seed=0):
    pairs = _strategies(seed, n_strat)
    kw = dict(n_devices=256, pp_degree=1, partition=[cfg_layers],
              global_batch=batch, n_micro=1)
    port = ParallelPlan(strategies=[p for p, _ in pairs], **kw)
    jplan = JaxPlan(strategies=[j for _, j in pairs], **kw)
    port.sp_degree = jplan.sp_degree = sp
    port.ep_degree = jplan.ep_degree = ep
    return port, jplan


@pytest.mark.parametrize("levels", LEVELS, ids=str)
@pytest.mark.parametrize("ckpt", [False, True])
def test_from_strategy_equals_jax(levels, ckpt):
    got = ShardPolicy.from_strategy(Strategy(levels, ckpt=ckpt),
                                    remat_segments=[ckpt])
    want = JaxPolicy.from_strategy(JaxStrategy(levels, ckpt=ckpt),
                                   remat_segments=[ckpt])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def _policy_case(arch, n_extra, with_specs, hbm, kw, sp, ep, seed):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    port, jplan = _plans(cfg.n_layers, cfg.n_layers + n_extra, sp=sp, ep=ep,
                         seed=seed)
    extra = dict(kw, hbm_capacity=hbm)
    pspecs = layerspecs_for(cfg, 4096) if with_specs else None
    jspecs = jax_layerspecs(jcfg, 4096) if with_specs else None
    jkw = {k: v for k, v in extra.items() if k not in ("tp", "data_shards")}
    got = policy_from_plan(cfg, port, specs=pspecs, **extra)
    if "tp" in kw:       # the reference's constants in its call
        assert (kw["tp"], kw["data_shards"]) == (16, 16)
    want = jax_bridge.policy_from_plan(jcfg, jplan, specs=jspecs, **jkw)
    return got, want


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n_extra", [0, 2], ids=["body", "padded"])
@pytest.mark.parametrize("with_specs", [False, True], ids=["", "specs"])
@pytest.mark.parametrize("hbm", [16e9, 2e9], ids=["16G", "2G"])
def test_policy_from_plan_equals_jax(arch, n_extra, with_specs, hbm):
    for seed in range(3):
        got, want = _policy_case(arch, n_extra, with_specs, hbm, {}, 1, 1,
                                 seed)
        assert dataclasses.asdict(got) == dataclasses.asdict(want), seed


@pytest.mark.parametrize("sp,ep", [(4, 1), (1, 2), (2, 4)])
def test_policy_from_plan_carries_sp_and_ep(sp, ep):
    got, want = _policy_case("qwen3-4b", 0, True, 16e9,
                             {"tp": 16, "data_shards": 16}, sp, ep, 0)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.sp_degree, got.ep_degree) == (sp, ep)
    assert got.expert_axis == ("expert" if ep > 1 else "model")


def test_seq_shard_rule_fires_on_a_small_budget():
    """test_substrates.py::test_plan_bridge_policies's plan, on qwen3-4b:
    the 16 GB budget holds its stash, 4 GB does not; in both packages."""
    cfg, jcfg = get_config("qwen3-4b"), jax_get_config("qwen3-4b")
    levels = (("sdp", 16), ("tp", 16))
    kw = dict(n_devices=256, pp_degree=1, partition=[cfg.n_layers],
              global_batch=256, n_micro=1)
    port = ParallelPlan(strategies=[Strategy(levels, ckpt=True)]
                        * cfg.n_layers, **kw)
    jplan = JaxPlan(strategies=[JaxStrategy(levels, ckpt=True)]
                    * cfg.n_layers, **kw)
    for hbm, fires in ((16e9, False), (4e9, True)):
        got = policy_from_plan(cfg, port, specs=layerspecs_for(cfg, 4096),
                               hbm_capacity=hbm)
        want = jax_bridge.policy_from_plan(
            jcfg, jplan, specs=jax_layerspecs(jcfg, 4096), hbm_capacity=hbm)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert got.seq_shard is fires and got.tp and got.zero
        assert got.remat_segments == (True,)


def test_policy_from_plan_takes_the_mesh_degrees():
    """The reference's literal tp=16, data_shards=16 are keywords: other
    degrees change the modeled residency the rule reads."""
    cfg = get_config("qwen3-4b")
    port, _ = _plans(cfg.n_layers, cfg.n_layers)
    specs = layerspecs_for(cfg, 4096)
    remat = any(policy_from_plan(cfg, port).remat_segments)
    kw = dict(mode="train", chips=256, remat=remat, batch=256,
              hbm_capacity=16e9)
    a = modeled_memory(specs, tp=16, data_shards=16, **kw)
    b = modeled_memory(specs, tp=1, data_shards=1, **kw)
    assert b.resident_bytes_per_device > a.resident_bytes_per_device
    cap = (a.resident_bytes_per_device + b.resident_bytes_per_device) / 2
    assert not policy_from_plan(cfg, port, specs=specs, hbm_capacity=cap
                                ).seq_shard
    assert policy_from_plan(cfg, port, specs=specs, hbm_capacity=cap, tp=1,
                            data_shards=1).seq_shard


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("seq_shard", [1, 4])
def test_modeled_memory_equals_jax(arch, mode, remat, seq_shard):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    specs, jspecs = layerspecs_for(cfg, 4096), jax_layerspecs(jcfg, 4096)
    for chips, tp, ds, batch, cache in ((256, 16, 16, 256, 0.0),
                                        (8, 2, 4, 16, 3e10),
                                        (1, 1, 1, 2, 1e9)):
        kw = dict(mode=mode, chips=chips, tp=tp, data_shards=ds,
                  remat=remat, batch=batch, cache_bytes_total=cache,
                  hbm_capacity=16e9, seq_shard=seq_shard)
        got, want = modeled_memory(specs, **kw), jax_modeled_memory(jspecs,
                                                                    **kw)
        assert got.traffic_bytes_per_device == want.traffic_bytes_per_device
        assert (got.resident_bytes_per_device
                == want.resident_bytes_per_device)
        assert got.fits == want.fits
        # the device constant is the H100's, not the reference's TPU's
        assert got.t_memory() == got.traffic_bytes_per_device / 3.35e12
    assert HBM_BW == 3.35e12


@pytest.mark.parametrize("sched,pp,m,V", [
    ("gpipe", 2, 4, 1), ("1f1b", 4, 8, 1), ("1f1b-interleaved", 2, 4, 2),
    ("zb-h1", 4, 8, 1)])
def test_schedule_program_from_plan_equals_jax(sched, pp, m, V):
    kw = dict(n_devices=8, pp_degree=pp, partition=[8 // pp] * pp,
              global_batch=32, n_micro=m, schedule=sched, vpp_degree=V)
    port = ParallelPlan(strategies=[Strategy((("dp", 8 // pp),))] * 8, **kw)
    jplan = JaxPlan(strategies=[JaxStrategy((("dp", 8 // pp),))] * 8, **kw)
    got = schedule_program_from_plan(port, validate=True)
    want = jax_bridge.schedule_program_from_plan(jplan, validate=True)
    for f in ("name", "n_stages", "n_chunks", "n_micro", "n_ticks",
              "remat"):
        assert getattr(got, f) == getattr(want, f), f
    for f in ("mb_index", "chunk_index", "valid", "loss_valid", "phase"):
        a, b = getattr(got, f), getattr(want, f)
        assert (a is None and b is None) or np.array_equal(a, b), f


def test_uncompilable_schedule_raises_pln004():
    kw = dict(n_devices=8, pp_degree=2, partition=[4, 4], global_batch=32,
              n_micro=4, schedule="1f1b-interleaved")   # vpp_degree 1
    port = ParallelPlan(strategies=[Strategy((("dp", 4),))] * 8, **kw)
    with pytest.raises(DiagnosticError) as ei:
        schedule_program_from_plan(port)
    assert "PLN004" in ei.value.rules()


def test_pipe_mismatch_raises_pln006():
    kw = dict(n_devices=8, pp_degree=2, partition=[4, 4], global_batch=32,
              n_micro=4)
    port = ParallelPlan(strategies=[Strategy((("dp", 4),))] * 8, **kw)
    cfg = get_config("qwen3-4b").reduced(n_layers=8)
    with pytest.raises(DiagnosticError) as ei:
        pipeline_loss_from_plan(cfg, {"pipe": 4, "data": 2}, port)
    assert "PLN006" in ei.value.rules()
