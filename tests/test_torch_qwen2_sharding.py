"""The port's sharded Qwen2 family (the QKV bias at a GQA group of 5)
against the single-process port and the JAX package, on the CPU.

The rule table first, without ranks: every leaf of full-width qwen3-8b,
qwen2.5-14b and qwen2-72b (the port's on the ``meta`` device, JAX's from
``jax.eval_shape`` of ``init_lm``) through ``param_specs`` and
``opt_specs`` against JAX ``param_shardings`` and ``opt_shardings`` on an
``AbstractMesh``, on (2, 2), (4, 1) and (8, 2), with TP and ZeRO on and
off: the stacked (L, q_dim) and (L, kv_dim) biases fall through the
column rule to the ZeRO default, as in the reference.

Then real ranks: a module fixture starts 4 gloo ranks with
``launch/mesh.py::run_ranks`` (spawn, a ``file://`` rendezvous under a
temporary directory, one thread each, a 240 s limit).  The model is
reduced fp32 qwen2.5-14b bridged from JAX ``init_lm`` with biases drawn
from a seed (std 0.5): 2 layers, d 320, 10 query heads over 2 KV heads of
dh 32 (a GQA group of 5, and 5 again on each of two ``model`` ranks' 5
heads over 1 KV head), d_ff 640, a vocabulary of 1024.  Batches of 4 x 16
tokens made with numpy from a seed.

Training cases: (data 2, model 2) with TP, ZeRO-3 and remat; (2, 2) with
TP; (4, 1) with ZeRO-3.  Each keeps the rank's shards of the bridged
weights (``shard_train_state``), runs ``make_sharded_loss`` on one batch
and gathers every gradient leaf, then trains three sharded AdamW steps
and gathers the biases.  Serving on (2, 2) with TP (each ``data`` rank's
lanes on a (data 1, model 2) pair, the rank's slice of each bias): the
prefill, 8 greedy dense-cache decode steps on a 16-slot cache, and the
paged engine.  The pipeline: (pipe 2, data 2), ``1f1b``, 2 micro-batches
of 4 x 16, one layer a stage.

Tolerances (fp32, sums in another order): the loss within 1e-5 relative
and every gathered gradient leaf, the biases' included (summed over
``model``), within 1e-5 of its largest magnitude of the single-process
port, within 1e-4 of JAX ``jax.value_and_grad(lm_loss)``; three steps'
losses within 1e-5 of the single-process ``make_train_step``, the biases
after them within 1e-4 (``AFTER_TOL``); the prefill and decode logits within 1e-5 of the
single process's largest, with its greedy tokens on every rank; the
paged engine's tokens the single process's; the pipeline's loss and
gradients within 1e-5 of the single-process ``lm_loss`` on the whole
batch.
"""
import functools
import json
import pathlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.configs import get_config as jax_get_config
from repro.models.transformer import init_lm as jax_init_lm
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim import adamw_init as jax_adamw_init
from repro.runtime.sharding import ShardPolicy as JaxPolicy
from repro.runtime.sharding import opt_shardings as jax_opt_shardings
from repro.runtime.sharding import param_shardings as jax_param_shardings
from repro_torch.bridge import jax_path, params_from_jax
from repro_torch.configs import get_config
from repro_torch.launch.mesh import (init_distributed, make_local_mesh,
                                     make_pipeline_mesh, run_ranks)
from repro_torch.models import decode_step, init_decode_state, lm_loss
from repro_torch.optim import adamw_init, global_norm
from repro_torch.runtime import (ShardPolicy, abstract_params, gather_params,
                                 make_prefill_step, make_serve_step,
                                 make_sharded_loss, make_train_step,
                                 opt_specs, param_specs,
                                 shard_serving_params, shard_train_state)
from repro_torch.runtime.pipeline import (make_pipeline_loss,
                                          stage_split_params)
from repro_torch.serving import EngineConfig, ServeRequest, ServingEngine

torch.set_num_threads(1)

ARCH = "qwen2.5-14b"
WORLD = 4
TIMEOUT_S = 240
B, S, STEPS = 4, 16, 3
CONTEXT, DECODE_STEPS = 16, 8
M_PIPE = 2
RTOL, GRAD_TOL, JAX_TOL = 1e-5, 1e-5, 1e-4
# the biases after three AdamW steps: bk's gradient is mostly near zero
# (adding bk shifts a query's scores by q.bk, which softmax cancels but
# for RoPE's turn; its median element is 2e-3 of its largest here), and
# AdamW's m / sqrt(v) moves such an element by a whole lr step whatever
# its size, so the sum order's last bits become lr-sized differences
# (measured on the CPU: 1.7e-5 of the largest after three steps)
AFTER_TOL = 1e-4
BIAS_STD = 0.5
R = (True,)
# (name, (data, model), policy)
CASES = [("2x2-tp-zero-remat", (2, 2),
          dict(tp=True, zero=True, remat_segments=R)),
         ("2x2-tp", (2, 2), dict(tp=True, zero=False)),
         ("4x1-zero", (4, 1), dict(tp=False, zero=True))]
CASE_NAMES = [c[0] for c in CASES]
SERVE_MESH, SERVE_POLICY = (2, 2), dict(tp=True, zero=False)
ECFG = dict(page_size=4, n_pages=24, decode_slots=3, max_context=24,
            prefill_batch=2, prefill_chunk=4)
BIASES = ("bq", "bk", "bv")
# the rule table on the full configs
TABLE_ARCHS = ("qwen3-8b", "qwen2.5-14b", "qwen2-72b")
TABLE_MESHES = {"2x2": (2, 2), "4x1": (4, 1), "8x2": (8, 2)}
PAIRS = [(tp, zero) for tp in (False, True) for zero in (False, True)]


def _cfgs():
    """(JAX, port) configs of the reduced fp32 qwen2.5-14b at G = 5."""
    return tuple(c(ARCH).reduced(n_layers=2, d_model=320).with_(
        n_heads=10, n_kv_heads=2, head_dim=32, dtype=dt)
        for c, dt in ((jax_get_config, jnp.float32),
                      (get_config, torch.float32)))


def _tree(cfg_j):
    """JAX ``init_lm`` (seed 0) with seeded biases, numpy leaves."""
    tree = jax.tree.map(np.asarray, jax.jit(lambda k: jax_init_lm(
        k, cfg_j))(jax.random.PRNGKey(0)))
    attn = tree["stacks"][0]["attn"]
    rng = np.random.default_rng(11)
    attn.update({k: (BIAS_STD * rng.standard_normal(attn[k].shape)
                     ).astype(np.float32) for k in BIASES})
    return tree


def _batches(vocab):
    rng = np.random.default_rng(0)
    out = [{k: rng.integers(0, vocab, (B, S), dtype=np.int32)
            for k in ("tokens", "labels")} for _ in range(STEPS)]
    out[0]["labels"][1, :5] = -100          # ignored labels weigh as one
    return out


def _batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _bias_names(model):
    return [n for n, _ in model.named_parameters()
            if n.rsplit(".", 1)[-1] in BIASES]


def _greedy(step, params, state, first, n=DECODE_STEPS):
    logits, tokens, tok = [], [], first
    for _ in range(n):
        lg, state = step(params, state, tok)
        tok = lg.argmax(-1)
        logits.append(lg)
        tokens.append(tok)
    return torch.stack(logits), torch.stack(tokens)


def _paged(cfg, params, vocab, **kw):
    rng = np.random.default_rng(6)
    reqs = [ServeRequest(rid=str(i), prompt=rng.integers(
        0, vocab, int(rng.integers(3, 13))).tolist(),
        max_new=int(rng.integers(3, 7))) for i in range(6)]
    ServingEngine(cfg, params, EngineConfig(**ECFG), device="cpu",
                  **kw).run(reqs)
    return [r.tokens for r in reqs]


def _pipe_batch(b):
    """Batch 0 as ``M_PIPE`` micro-batches, every label kept."""
    return {k: torch.from_numpy(b[k].reshape(M_PIPE, B // M_PIPE, S))
            for k in ("tokens", "labels")}


def _worker(rank, world, init_file, out_dir, tree, batches, pipe_batch):
    """One rank: every training case, serving and the pipeline; rank 0
    saves."""
    torch.set_num_threads(1)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{init_file}", timeout_s=TIMEOUT_S)
    try:
        cfg = _cfgs()[1]
        meshes, out = {}, {}

        def mesh_of(shape):
            if shape not in meshes:     # a collective: the same order
                meshes[shape] = make_local_mesh(shape[1], device_type="cpu")
            return meshes[shape]

        def fresh():
            return params_from_jax(tree, cfg, device="cpu")

        def gathered(name, value):
            allranks = [None] * world
            dist.all_gather_object(allranks, value)
            out[name] = allranks

        for name, shape, pk in CASES:
            mesh, pol = mesh_of(shape), ShardPolicy(**pk)
            params, _ = shard_train_state(fresh(), mesh, pol, cfg=cfg)
            loss_fn = make_sharded_loss(cfg, mesh, pol)
            loss, grads = loss_fn(params, _batch(batches[0]))
            ctx = loss_fn.shard
            named = list(params.named_parameters())
            full = {n: ctx.gather_tensor(n, g).numpy()
                    for (n, _), g in zip(named, grads)}
            params, opt = shard_train_state(fresh(), mesh, pol, cfg=cfg)
            step = make_train_step(cfg, mesh=mesh, policy=pol)
            losses = [float(step(params, opt, _batch(b))["loss"])
                      for b in batches]
            back = gather_params(params, mesh, pol, cfg=cfg)
            gathered(name, {"loss": loss.item(), "losses": losses,
                            "tp": ctx.tp, "gnorm": ctx.grad_norm(
                                named, grads).item(),
                            "bq": list(params.blocks[0].attn.bq.shape)})
            if rank == 0:
                np.savez(f"{out_dir}/{name}.npz", **full, **{
                    f"after/{n}": back.get_parameter(n).detach().numpy()
                    for n in _bias_names(back)})
        mesh, pol = mesh_of(SERVE_MESH), ShardPolicy(**SERVE_POLICY)
        params = shard_serving_params(fresh(), mesh, pol, cfg=cfg)
        b0 = {"tokens": batches[0]["tokens"]}
        prefill = make_prefill_step(cfg, mesh=mesh, policy=pol)
        block = prefill(params, _batch(b0))
        step = make_serve_step(cfg, mesh=mesh, policy=pol)
        state = init_decode_state(cfg, B, CONTEXT, device="cpu",
                                  shard=step.shard)
        logits, tokens = _greedy(step, params, state, torch.from_numpy(
            batches[0]["tokens"][:, 0]).long())
        gathered("serve", {"prefill": block.numpy().tolist(),
                           "lanes": list(prefill.shard.lane_range(B)),
                           "model_rank": prefill.shard.model_rank,
                           "logits": logits.numpy().tolist(),
                           "tokens": tokens.numpy().tolist(),
                           "tp": step.shard.tp})
        gathered("paged", _paged(cfg, params, cfg.vocab_size, mesh=mesh,
                                 policy=pol))
        pmesh = make_pipeline_mesh(2, 2, device_type="cpu")
        i = pmesh.get_local_rank("pipe")
        stage = stage_split_params(fresh(), 2)[i]
        loss, grads = make_pipeline_loss(cfg, pmesh, M_PIPE,
                                         schedule="1f1b")(stage, pipe_batch)
        gathered("pipe", {"loss": loss.item()})
        if pmesh.get_local_rank("data") == 0:
            np.savez(f"{out_dir}/pipe-{i}.npz", **{
                n: g.numpy() for (n, _), g in zip(stage.named_parameters(),
                                                  grads)})
        if rank == 0:
            pathlib.Path(f"{out_dir}/results.json").write_text(
                json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on 4 gloo ranks; the single-process port and JAX
    references."""
    tmp = tmp_path_factory.mktemp("qwen2_sharding")
    cj, ct = _cfgs()
    tree = _tree(cj)
    batches = _batches(ct.vocab_size)
    b0 = batches[0]
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jax_lm_loss(
        p, {k: jnp.asarray(v) for k, v in b0.items()}, cj)))(
        jax.tree.map(jnp.asarray, tree))
    port = params_from_jax(tree, ct, device="cpu")
    pl = lm_loss(port, _batch(b0), ct)
    pg = torch.autograd.grad(pl, list(port.parameters()))
    jgrads = params_from_jax(jax.tree.map(np.asarray, jg), ct,
                             device="cpu").named_parameters()
    ref = {"loss": pl.item(), "jax_loss": float(jl),
           "grads": {n: g.numpy() for (n, _), g in
                     zip(port.named_parameters(), pg)},
           "jax_grads": {n: g.detach().numpy() for n, g in jgrads},
           "gnorm": global_norm(pg).item()}
    single = params_from_jax(tree, ct, device="cpu")
    opt = adamw_init(list(single.parameters()))
    step = make_train_step(ct)
    ref["losses"] = [float(step(single, opt, _batch(b))["loss"])
                     for b in batches]
    ref["after"] = {n: single.get_parameter(n).detach().numpy()
                    for n in _bias_names(single)}
    # the pipeline's whole batch: batch 0's tokens, every label kept
    pipe_batch = _pipe_batch({"tokens": b0["tokens"],
                              "labels": batches[1]["labels"]})
    flat = {k: v.reshape(B, S) for k, v in pipe_batch.items()}
    pl = lm_loss(port, flat, ct)
    ref["pipe_loss"] = pl.item()
    ref["pipe_grads"] = {n: g.numpy() for (n, _), g in zip(
        port.named_parameters(), torch.autograd.grad(
            pl, list(port.parameters())))}
    with torch.inference_mode():
        ref["prefill"] = make_prefill_step(ct)(
            port, {"tokens": torch.from_numpy(b0["tokens"])}).numpy()
        state = init_decode_state(ct, B, CONTEXT, device="cpu")
        logits, tokens = _greedy(
            lambda p, s, t: decode_step(p, s, t, ct), port, state,
            torch.from_numpy(b0["tokens"][:, 0]).long())
    ref["logits"], ref["tokens"] = logits.numpy(), tokens.numpy()
    ref["paged"] = _paged(ct, port, ct.vocab_size)
    run_ranks(_worker, (WORLD, str(tmp / "rendezvous"), str(tmp), tree,
                        batches, pipe_batch), WORLD, timeout_s=TIMEOUT_S)
    res = json.loads((tmp / "results.json").read_text())
    grads = {}
    for name in CASE_NAMES:
        with np.load(tmp / f"{name}.npz") as f:
            grads[name] = {k: f[k] for k in f.files}
    pipe = {}
    for i in range(2):
        with np.load(tmp / f"pipe-{i}.npz") as f:
            for k in f.files:
                assert k not in pipe or np.array_equal(pipe[k], f[k]), k
                pipe[k] = f[k]
    return types.SimpleNamespace(res=res, grads=grads, ref=ref, pipe=pipe,
                                 cfgs=(cj, ct))


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


# ---------------------------------------------------------------------------
# the rule table, no ranks
# ---------------------------------------------------------------------------

def _norm(entries, nd):
    """A spec as a tuple of nd tuples of axis names."""
    entries = list(entries) + [None] * (nd - len(entries))
    return tuple(() if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in entries)


def _key(path):
    return "/".join(str(getattr(k, "key", getattr(k, "idx", k)))
                    for k in path)


@functools.lru_cache(maxsize=None)
def _abstract(arch):
    aj = jax.eval_shape(lambda k: jax_init_lm(k, jax_get_config(arch)),
                        jax.random.PRNGKey(0))
    return aj, abstract_params(get_config(arch))


def _port_vs_jax(got, jax_specs, named):
    for name, leaf_shape in named:
        path, layer = jax_path(name)
        nd = len(leaf_shape)
        want = (_norm(jax_specs[path].spec, nd) if layer is None
                else _norm(jax_specs[path].spec, nd + 1)[1:])
        assert _norm(got[name], nd) == want, (name, path)


@pytest.mark.parametrize("tp,zero", PAIRS, ids=lambda v: str(v))
@pytest.mark.parametrize("mesh", list(TABLE_MESHES))
@pytest.mark.parametrize("arch", TABLE_ARCHS)
def test_param_specs_equal_jax_param_shardings(arch, mesh, tp, zero):
    """Leaf by leaf, the biases included: a block's (q_dim,) bias is the
    stacked (L, q_dim) leaf with its layer entry dropped, ZeRO-sharded
    over ``data`` where that divides and never over ``model``."""
    shape = TABLE_MESHES[mesh]
    aj, port = _abstract(arch)
    jax_specs = {_key(p): x for p, x in jax.tree_util.tree_flatten_with_path(
        jax_param_shardings(aj, AbstractMesh(shape, ("data", "model")),
                            JaxPolicy(tp=tp, zero=zero)))[0]}
    got = param_specs(port, dict(zip(("data", "model"), shape)),
                      ShardPolicy(tp=tp, zero=zero))
    named = [(n, tuple(p.shape)) for n, p in port.named_parameters()]
    assert {jax_path(n)[0] for n, _ in named} == set(jax_specs)
    _port_vs_jax(got, jax_specs, named)
    biases = _bias_names(port)
    assert len(biases) == (3 * get_config(arch).n_layers
                           if get_config(arch).qkv_bias else 0)
    for n in biases:
        assert _norm(got[n], 1) == ((("data",),) if zero and shape[0] > 1
                                    else ((),)), n


@pytest.mark.parametrize("mesh", ["2x2", "8x2"])
@pytest.mark.parametrize("arch", TABLE_ARCHS)
def test_opt_specs_equal_jax_opt_shardings(arch, mesh):
    """AdamW's master, m and v mirror the parameters' specs, the biases'
    included, as JAX ``opt_shardings`` (TP and ZeRO on)."""
    shape = TABLE_MESHES[mesh]
    aj, port = _abstract(arch)
    jflat = {_key(p): x for p, x in jax.tree_util.tree_flatten_with_path(
        jax_opt_shardings(jax.eval_shape(jax_adamw_init, aj),
                          AbstractMesh(shape, ("data", "model")),
                          JaxPolicy()))[0]}
    got = opt_specs(port, dict(zip(("data", "model"), shape)),
                    ShardPolicy())
    assert got["step"] == () and _norm(jflat["step"].spec, 0) == ()
    named = [(n, tuple(p.shape)) for n, p in port.named_parameters()]
    for part in ("master", "m", "v"):
        specs = dict(zip([n for n, _ in named], got[part]))
        sub = {k[len(part) + 1:]: v for k, v in jflat.items()
               if k.startswith(part + "/")}
        _port_vs_jax(specs, sub, named)


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_sharded_loss_and_grads_match_the_single_process(runs, case):
    """Every gathered gradient within 1e-5, the biases' too: under TP each
    rank adds its slice of a replicated bias (``ShardContext.tp_local``),
    and the slices' gradients summed over ``model`` are the whole."""
    name = case[0]
    ranks, ref = runs.res[name], runs.ref
    assert all(r == ranks[0] for r in ranks)    # every rank alike
    assert ranks[0]["loss"] == pytest.approx(ref["loss"], rel=RTOL)
    assert set(runs.grads[name]) - {k for k in runs.grads[name]
                                    if k.startswith("after/")} == \
        set(ref["grads"])
    for k, g in ref["grads"].items():
        assert _rel(runs.grads[name][k], g) <= GRAD_TOL, (name, k)
    assert ranks[0]["gnorm"] == pytest.approx(ref["gnorm"], rel=RTOL)
    assert len([k for k in ref["grads"] if k.endswith(".bq")]) == 2


@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_sharded_loss_and_grads_match_jax(runs, case):
    name = case[0]
    assert runs.res[name][0]["loss"] == pytest.approx(runs.ref["jax_loss"],
                                                      rel=JAX_TOL)
    for k, g in runs.ref["jax_grads"].items():
        assert _rel(runs.grads[name][k], g) <= JAX_TOL, (name, k)


@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_three_sharded_steps_match_the_single_process(runs, case):
    """Three AdamW steps' losses, and the biases after them, gathered."""
    name = case[0]
    assert runs.res[name][0]["losses"] == pytest.approx(
        runs.ref["losses"], rel=RTOL)
    for n, want in runs.ref["after"].items():
        assert _rel(runs.grads[name][f"after/{n}"], want) <= AFTER_TOL, n


def test_each_tp_rank_holds_its_heads_at_a_group_of_5(runs):
    """Under TP a rank runs 5 query heads over 1 KV head (G = 5) and holds
    the replicated (320,) bq, or its ZeRO half over ``data``."""
    want = {"2x2-tp-zero-remat": (2, [160]), "2x2-tp": (2, [320]),
            "4x1-zero": (1, [80])}
    for name, (tp, bq) in want.items():
        for r in runs.res[name]:
            assert (r["tp"], r["bq"]) == (tp, bq), name
    cfg = runs.cfgs[1]
    assert (cfg.n_heads // 2) // (cfg.n_kv_heads // 2) == 5


def test_tp_dense_cache_serving_matches_the_single_process(runs):
    """The prefill (each ``data`` rank's lanes and ``model`` rank's
    vocabulary columns, 1024 splitting over 2) and 8 greedy decode steps
    (every lane's whole logits on every rank) under TP on the rank's
    heads."""
    ref = runs.ref
    v = runs.cfgs[1].vocab_size // 2
    for r in runs.res["serve"]:
        assert r["tp"] == 2
        lo, hi = r["lanes"]
        m = r["model_rank"]
        got = np.asarray(r["prefill"])
        want = ref["prefill"][lo:hi, :, m * v:(m + 1) * v]
        assert got.shape == want.shape == (hi - lo, S, v)
        assert np.abs(got - want).max() <= \
            RTOL * np.abs(ref["prefill"]).max()
        assert r["tokens"] == ref["tokens"].tolist()
        assert _rel(np.asarray(r["logits"]), ref["logits"]) <= RTOL


def test_tp_paged_engine_serves_as_one_process(runs):
    assert all(r == runs.ref["paged"] for r in runs.res["paged"])
    assert all(len(t) > 0 for t in runs.ref["paged"])


def test_pipeline_loss_and_grads_match_the_single_process(runs):
    """``1f1b`` on (pipe 2, data 2), one biased layer a stage: the loss
    and every gradient (each stage's leaves, both layers' biases among
    them) against ``lm_loss`` on the whole batch."""
    ref = runs.ref
    for r in runs.res["pipe"]:
        assert r["loss"] == pytest.approx(ref["pipe_loss"], rel=RTOL)
    assert set(runs.pipe) == set(ref["pipe_grads"])
    assert {"blocks.0.attn.bq", "blocks.1.attn.bv"} <= set(runs.pipe)
    for k, g in ref["pipe_grads"].items():
        assert _rel(runs.pipe[k], g) <= GRAD_TOL, k
