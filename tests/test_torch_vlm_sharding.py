"""The port's sharded vision-language model (internvl2-26b) against the
single-process port and the JAX package, on the CPU.

The rule table first, without ranks: every leaf of full-width internvl2
(the port's on the ``meta`` device, JAX's from ``jax.eval_shape`` of
``init_lm``) through ``param_specs`` against JAX ``param_shardings`` on an
``AbstractMesh``, on (2, 2) and (4, 1), with TP and ZeRO on and off: the
projector's w1 column-parallel, w2 row-parallel, its biases whole, and
the 92553-row table and head whole over ``model`` (92553 is odd).

Then real ranks: a module fixture starts 4 gloo ranks with
``launch/mesh.py::run_ranks`` (spawn, a ``file://`` rendezvous under a
temporary directory, one thread each, a 240 s limit).  The model is a
reduced fp32 internvl2 bridged from JAX ``init_lm``: 2 layers, d 256, 8
query heads over 4 KV heads of dh 32 (a GQA group of 2 on every rank's
heads), d_ff 512, 8 vision tokens of ``d_vision`` 96, and a vocabulary of
1001, which no ``model`` axis of 2 or 4 divides, so that TP meets an
untied head it cannot split.  Batches of 4 x 16 tokens with 4 x 8
patches, made with numpy from a seed.

Training cases: (data 2, model 2) with TP, ZeRO, remat and ``seq_shard``
(the token slices cut across the vision and text rows together); (2, 2)
with TP and ZeRO; (1, 4) with TP; (4, 1) with ZeRO; (4, 1) with DP.  Each
bridges the JAX weights into a full port model, keeps the rank's shards
(``shard_train_state``), runs ``make_sharded_loss`` on one batch and
gathers every gradient leaf, then trains three sharded AdamW steps from
the same weights.  Beside the ranks, ``conftest.run_subprocess`` runs JAX
``make_train_step`` for the VLM on a (4, 1) mesh of fake devices with
``tp=False, zero=False``.

Serving cases: the sharded ``make_prefill_step`` with patches, 8 greedy
steps of ``make_serve_step`` on a 16-slot cache (tokens only, as the
reference serves a VLM) on (2, 2) without TP, with TP, and on (4, 1)
with ZeRO; the paged engine on (2, 2) with TP.  Checkpoints on (2, 2)
with TP and ZeRO, interchangeable with the single process's and JAX's.

Tolerances (fp32, sums in another order): the loss within 1e-5 relative
and every gathered gradient leaf within 1e-5 of its largest magnitude of
the single-process port, within 1e-4 of JAX
``jax.value_and_grad(lm_loss)``; three steps' losses within 1e-5 of the
single-process ``make_train_step`` (DP's also within 1e-4 of JAX's on 4
fake devices); the prefill and decode logits within 1e-5 of the single
process's largest, with its greedy tokens on every rank; the paged
engine's tokens the single process's; checkpoints bit for bit.  ``train
--arch internvl2-26b --reduced --ranks 4`` gives the one-process CLI's
first loss within 1e-5 and the next two within 2e-3 (the CLI's reduced
model is bf16).
"""
import functools
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

from repro.checkpointing import restore_train_state as jax_restore
from repro.configs import get_config as jax_get_config
from repro.models.transformer import init_lm as jax_init_lm
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim import adamw_init as jax_adamw_init
from repro.runtime.sharding import ShardPolicy as JaxPolicy
from repro.runtime.sharding import param_shardings as jax_param_shardings
from repro_torch.bridge import flat_from_leaves, jax_path, params_from_jax
from repro_torch.checkpointing import (restore_sharded_train_state,
                                       restore_train_state,
                                       save_sharded_train_state,
                                       save_train_state)
from repro_torch.configs import get_config
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import (init_distributed, make_local_mesh,
                                     run_ranks)
from repro_torch.models import (decode_step, init_decode_state, lm_forward,
                                lm_loss)
from repro_torch.optim import adamw_init, global_norm
from repro_torch.runtime import (ShardPolicy, abstract_params, gather_params,
                                 init_train_state, make_prefill_step,
                                 make_serve_step, make_sharded_loss,
                                 make_train_step, param_specs,
                                 shard_serving_params, shard_train_state)
from repro_torch.serving import EngineConfig, ServeRequest, ServingEngine

torch.set_num_threads(1)

ARCH = "internvl2-26b"
WORLD = 4
TIMEOUT_S = 240
B, S, N_VIS, D_VIS, STEPS = 4, 16, 8, 96, 3
CONTEXT, DECODE_STEPS = 16, 8
VOCAB = 1001
RTOL, GRAD_TOL, JAX_TOL = 1e-5, 1e-5, 1e-4
# bf16 training through the CLI, ranks against one process, steps after
# the first: 4 ranks' bf16 gradients, each of one row, summed in fp32 and
# rounded once, round otherwise than one process's bf16 gradient of 4
# rows, and AdamW's first steps carry the difference into the weights
# (measured on the CPU: 1.3e-5 at step 2, 3.8e-4 at step 3); half a bf16
# rounding (2^-9)
CLI_BF16_RTOL = 2e-3
R = (True,)
# (name, (data, model), policy)
CASES = [("2x2-tp-zero-remat-seq", (2, 2),
          dict(tp=True, zero=True, remat_segments=R, seq_shard=True)),
         ("2x2-tp-zero", (2, 2), dict(tp=True, zero=True)),
         ("1x4-tp", (1, 4), dict(tp=True, zero=False)),
         ("4x1-zero", (4, 1), dict(tp=False, zero=True)),
         ("4x1-dp", (4, 1), dict(tp=False, zero=False))]
CASE_NAMES = [c[0] for c in CASES]
SERVE_CASES = [("2x2-context", (2, 2), dict(tp=False, zero=False)),
               ("2x2-tp", (2, 2), dict(tp=True, zero=False)),
               ("4x1-zero", (4, 1), dict(tp=False, zero=True))]
SERVE_NAMES = [c[0] for c in SERVE_CASES]
PAGED_MESH, PAGED_POLICY = (2, 2), dict(tp=True, zero=False)
ECFG = dict(page_size=4, n_pages=24, decode_slots=3, max_context=24,
            prefill_batch=2, prefill_chunk=4)
CKPT_MESH, CKPT_POLICY = (2, 2), dict(tp=True, zero=True)
OPT = ("master", "m", "v")
CLI_ARGV = ["--arch", ARCH, "--reduced", "--device", "cpu", "--steps", "3",
            "--batch", "4", "--seq", "16", "--log-every", "1"]
# the rule table on full-width internvl2
TABLE_MESHES = {"2x2": (2, 2), "4x1": (4, 1)}
PAIRS = [(tp, zero) for tp in (False, True) for zero in (False, True)]


def _cfgs():
    """(JAX, port) configs of the reduced fp32 internvl2."""
    return tuple(c(ARCH).reduced(d_model=256).with_(
        n_heads=8, n_kv_heads=4, head_dim=32, vision_tokens=N_VIS,
        d_vision=D_VIS, vocab_size=VOCAB, dtype=dt)
        for c, dt in ((jax_get_config, jnp.float32),
                      (get_config, torch.float32)))


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        b = {k: rng.integers(0, VOCAB, (B, S), dtype=np.int32)
             for k in ("tokens", "labels")}
        b["patches"] = rng.standard_normal((B, N_VIS, D_VIS),
                                           dtype=np.float32)
        out.append(b)
    out[0]["labels"][1, :5] = -100          # ignored labels weigh as one
    return out


def _batch(b):
    return {k: torch.from_numpy(v) for k, v in b.items()}


def _mesh(meshes, shape):
    if shape not in meshes:     # a collective: the same order everywhere
        meshes[shape] = make_local_mesh(shape[1], device_type="cpu")
    return meshes[shape]


def _greedy(step, params, state, first, n=DECODE_STEPS):
    """``n`` decode steps from token ``first`` (B,), each next token the
    argmax of the step's logits: (logits (n, B, V), tokens (n, B))."""
    logits, tokens, tok = [], [], first
    for _ in range(n):
        lg, state = step(params, state, tok)
        tok = lg.argmax(-1)
        logits.append(lg)
        tokens.append(tok)
    return torch.stack(logits), torch.stack(tokens)


def _requests():
    rng = np.random.default_rng(6)
    return [(rng.integers(0, VOCAB, int(rng.integers(3, 13))).tolist(),
             int(rng.integers(3, 7))) for _ in range(6)]


def _paged(cfg, params, **kw):
    reqs = [ServeRequest(rid=str(i), prompt=list(p), max_new=n)
            for i, (p, n) in enumerate(_requests())]
    ServingEngine(cfg, params, EngineConfig(**ECFG), device="cpu",
                  **kw).run(reqs)
    return [r.tokens for r in reqs]


def _full(model):
    return {n: p.detach().numpy() for n, p in model.named_parameters()}


def _worker(rank, world, init_file, out_dir, tree, batches, ckpt_single):
    """One rank: every training case, every serving case and the
    checkpoints; rank 0 saves."""
    torch.set_num_threads(1)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{init_file}", timeout_s=TIMEOUT_S)
    try:
        cfg = _cfgs()[1]
        meshes, out = {}, {}

        def fresh():
            return params_from_jax(tree, cfg, device="cpu")

        def gathered(name, value):
            allranks = [None] * world
            dist.all_gather_object(allranks, value)
            out[name] = allranks

        for name, shape, pk in CASES:
            mesh, pol = _mesh(meshes, shape), ShardPolicy(**pk)
            params, _ = shard_train_state(fresh(), mesh, pol, cfg=cfg)
            loss_fn = make_sharded_loss(cfg, mesh, pol)
            loss, grads = loss_fn(params, _batch(batches[0]))
            ctx = loss_fn.shard
            named = list(params.named_parameters())
            gnorm = ctx.grad_norm(named, grads).item()
            full = {n: ctx.gather_tensor(n, g).numpy()
                    for (n, _), g in zip(named, grads)}
            params, opt = shard_train_state(fresh(), mesh, pol, cfg=cfg)
            step = make_train_step(cfg, mesh=mesh, policy=pol)
            losses = [float(step(params, opt, _batch(b))["loss"])
                      for b in batches]
            gathered(name, {"loss": loss.item(), "gnorm": gnorm,
                            "losses": losses, "tp": ctx.tp,
                            "split_vocab": ctx.split_vocab,
                            "head": list(params.head.shape),
                            "w1": list(params.projector.w1.shape)})
            if rank == 0:
                np.savez(f"{out_dir}/{name}.npz", **full)
        first = torch.from_numpy(batches[0]["tokens"][:, 0]).long()
        for name, shape, pk in SERVE_CASES:
            mesh, pol = _mesh(meshes, shape), ShardPolicy(**pk)
            params = shard_serving_params(fresh(), mesh, pol, cfg=cfg)
            prefill = make_prefill_step(cfg, mesh=mesh, policy=pol)
            block = prefill(params, _batch(batches[0]))
            step = make_serve_step(cfg, mesh=mesh, policy=pol)
            state = init_decode_state(cfg, B, CONTEXT, device="cpu",
                                      shard=step.shard)
            logits, tokens = _greedy(step, params, state, first)
            gathered(f"serve-{name}", {
                "prefill": block.numpy().tolist(),
                "lanes": list(prefill.shard.lane_range(B)),
                "logits": logits.numpy().tolist(),
                "tokens": tokens.numpy().tolist(),
                "kv": state["layout"].kv})
        mesh, pol = _mesh(meshes, PAGED_MESH), ShardPolicy(**PAGED_POLICY)
        params = shard_serving_params(fresh(), mesh, pol, cfg=cfg)
        gathered("paged", _paged(cfg, params, mesh=mesh, policy=pol))
        # checkpoints: a single-process save restored into fresh shards;
        # a save after a sharded step, beside the gathered state
        mesh, pol = _mesh(meshes, CKPT_MESH), ShardPolicy(**CKPT_POLICY)
        whole, whole_opt = init_train_state(cfg, seed=1, device="cpu")
        restore_train_state(whole, whole_opt, ckpt_single)
        params, opt = init_train_state(cfg, mesh=mesh, policy=pol, seed=2,
                                       device="cpu")
        step = make_train_step(cfg, mesh=mesh, policy=pol)
        _, _, at = restore_sharded_train_state(params, opt, step.shard,
                                               ckpt_single)
        cut = step.shard.shard_tensor
        named = [n for n, _ in params.named_parameters()]
        same = at == 1 and opt["step"] == whole_opt["step"] and all(
            torch.equal(p, cut(n, w)) for n, p, w in
            zip(named, params.parameters(), whole.parameters()))
        same = same and all(torch.equal(t, cut(n, w)) for k in OPT
                            for n, t, w in zip(named, opt[k], whole_opt[k]))
        loss = float(step(params, opt, _batch(batches[1]))["loss"])
        save_sharded_train_state(2, params, opt, step.shard,
                                 f"{out_dir}/ckpt_sharded")
        back = gather_params(params, mesh, pol, cfg=cfg)
        opt_back = {k: [step.shard.gather_tensor(n, t)
                        for n, t in zip(named, opt[k])] for k in OPT}
        gathered("ckpt", {"restored_shards_equal": same, "loss": loss})
        if rank == 0:
            np.savez(f"{out_dir}/ckpt_gathered.npz", **_full(back), **{
                f"{k}/{n}": t.numpy() for k in OPT
                for n, t in zip(named, opt_back[k])})
            pathlib.Path(f"{out_dir}/results.json").write_text(
                json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


JAX_DP = """
import numpy as np, jax, jax.numpy as jnp
from repro.configs import get_config
from repro.runtime import ShardPolicy, make_train_step, init_train_state
cfg = get_config("internvl2-26b").reduced(d_model=256).with_(
    n_heads=8, n_kv_heads=4, head_dim=32, vision_tokens=N_VIS,
    d_vision=D_VIS, vocab_size=VOCAB, dtype=jnp.float32)
mesh = jax.make_mesh((4, 1), ("data", "model"), devices=jax.devices()[:4])
pol = ShardPolicy(tp=False, zero=False)
batches = np.load("BATCHES")
spec = {k: jax.ShapeDtypeStruct(batches[k].shape[1:], batches[k].dtype)
        for k in ("tokens", "labels", "patches")}
with mesh:
    step = make_train_step(cfg, mesh, pol, spec)
    params, opt = init_train_state(cfg, mesh, pol)
    losses = []
    for i in range(batches["tokens"].shape[0]):
        b = {k: jnp.asarray(batches[k][i]) for k in spec}
        params, opt, m = step.fn(params, opt, b)
        losses.append(float(m["loss"]))
print("LOSSES", losses)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on 4 gloo ranks; the single-process port and JAX
    references; JAX DP on 4 fake devices (run beside the ranks)."""
    tmp = tmp_path_factory.mktemp("vlm_sharding")
    cj, ct = _cfgs()
    params_j = jax_init_lm(jax.random.PRNGKey(0), cj)
    tree = jax.tree.map(np.asarray, params_j)
    batches = _batches()
    b0 = batches[0]
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jax_lm_loss(
        p, {k: jnp.asarray(v) for k, v in b0.items()}, cj)))(params_j)
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
    params_p = params_from_jax(tree, ct, device="cpu")
    opt = adamw_init(list(params_p.parameters()))
    step = make_train_step(ct)
    ref["losses"] = [float(step(params_p, opt, _batch(b))["loss"])
                     for b in batches]
    # serving: the single process's prefill, greedy decode and paged engine
    with torch.inference_mode():
        ref["prefill"] = lm_forward(port, torch.from_numpy(b0["tokens"]), ct,
                                    patches=torch.from_numpy(
                                        b0["patches"]))[0].numpy()
        state = init_decode_state(ct, B, CONTEXT, device="cpu")
        logits, tokens = _greedy(
            lambda p, s, t: decode_step(p, s, t, ct), port, state,
            torch.from_numpy(b0["tokens"][:, 0]).long())
    ref["logits"], ref["tokens"] = logits.numpy(), tokens.numpy()
    ref["paged"] = _paged(ct, port)
    # the single-process checkpoint the ranks restore: one AdamW step
    single = params_from_jax(tree, ct, device="cpu")
    single_opt = adamw_init(list(single.parameters()))
    make_train_step(ct)(single, single_opt, _batch(b0))
    save_train_state(1, single, single_opt, tmp / "ckpt_single")
    np.savez(tmp / "batches.npz",
             **{k: np.stack([b[k] for b in batches])
                for k in ("tokens", "labels", "patches")})
    code = (JAX_DP.replace("BATCHES", str(tmp / "batches.npz"))
            .replace("VOCAB", str(VOCAB)).replace("N_VIS", str(N_VIS))
            .replace("D_VIS", str(D_VIS)))
    with ThreadPoolExecutor(1) as pool:     # beside the ranks
        jax_run = pool.submit(run_subprocess, code, devices=4,
                              timeout=TIMEOUT_S)
        run_ranks(_worker, (WORLD, str(tmp / "rendezvous"), str(tmp), tree,
                            batches, str(tmp / "ckpt_single")), WORLD,
                  timeout_s=TIMEOUT_S)
        jax_out = jax_run.result()
    res = json.loads((tmp / "results.json").read_text())
    grads = {}
    for name in CASE_NAMES:
        with np.load(tmp / f"{name}.npz") as f:
            grads[name] = {k: f[k] for k in f.files}
    with np.load(tmp / "ckpt_gathered.npz") as f:
        ckpt_gathered = {k: f[k] for k in f.files}
    line = [x for x in jax_out.splitlines() if x.startswith("LOSSES")][0]
    return types.SimpleNamespace(res=res, grads=grads, ref=ref, tmp=tmp,
                                 ckpt_gathered=ckpt_gathered,
                                 jax_dp=json.loads(line[len("LOSSES "):]),
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


@functools.lru_cache(maxsize=None)
def _abstract():
    aj = jax.eval_shape(lambda k: jax_init_lm(k, jax_get_config(ARCH)),
                        jax.random.PRNGKey(0))
    return aj, abstract_params(get_config(ARCH))


@pytest.mark.parametrize("tp,zero", PAIRS, ids=lambda v: str(v))
@pytest.mark.parametrize("mesh", list(TABLE_MESHES))
def test_param_specs_equal_jax_leaf_spec_on_full_internvl2(mesh, tp, zero):
    shape = TABLE_MESHES[mesh]
    aj, port = _abstract()
    jax_specs = {
        "/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in p): x
        for p, x in jax.tree_util.tree_flatten_with_path(jax_param_shardings(
            aj, AbstractMesh(shape, ("data", "model")),
            JaxPolicy(tp=tp, zero=zero)))[0]}
    got = param_specs(port, dict(zip(("data", "model"), shape)),
                      ShardPolicy(tp=tp, zero=zero))
    named = [(n, tuple(p.shape)) for n, p in port.named_parameters()]
    assert {jax_path(n)[0] for n, _ in named} == set(jax_specs)
    for name, leaf_shape in named:
        path, layer = jax_path(name)
        nd = len(leaf_shape)
        want = (_norm(jax_specs[path].spec, nd) if layer is None
                else _norm(jax_specs[path].spec, nd + 1)[1:])
        assert _norm(got[name], nd) == want, (name, path)
    model = ("model",) if tp and shape[1] > 1 else ()
    data = ("data",) if zero else ()
    assert _norm(got["projector.w1"], 2) == (data, model)
    assert _norm(got["projector.w2"], 2) == (model, data)
    assert got["projector.b1"] == got["projector.b2"] == (None,)
    assert _norm(got["head"], 2)[1] == () and _norm(got["embed"], 2)[0] == ()


# ---------------------------------------------------------------------------
# the ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_sharded_vlm_loss_and_grads_match_the_single_process(runs, case):
    name = case[0]
    ranks, ref = runs.res[name], runs.ref
    assert all(r == ranks[0] for r in ranks)    # every rank alike
    assert ranks[0]["loss"] == pytest.approx(ref["loss"], rel=RTOL)
    assert set(runs.grads[name]) == set(ref["grads"])
    assert {k for k in ref["grads"] if k.startswith("projector.")} == {
        "projector.w1", "projector.b1", "projector.w2", "projector.b2"}
    for k, g in runs.grads[name].items():
        assert _rel(g, ref["grads"][k]) <= GRAD_TOL, (name, k)
    assert ranks[0]["gnorm"] == pytest.approx(ref["gnorm"], rel=RTOL)


@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_sharded_vlm_loss_and_grads_match_jax(runs, case):
    name = case[0]
    assert runs.res[name][0]["loss"] == pytest.approx(runs.ref["jax_loss"],
                                                      rel=JAX_TOL)
    for k, g in runs.grads[name].items():
        assert _rel(g, runs.ref["jax_grads"][k]) <= JAX_TOL, (name, k)


@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_three_sharded_vlm_steps_match_the_single_process(runs, case):
    got = runs.res[case[0]][0]["losses"]
    assert got == pytest.approx(runs.ref["losses"], rel=RTOL)


def test_tp_keeps_the_untied_head_whole_where_the_vocabulary_does_not_split(
        runs):
    """1001 splits over no model axis: under TP every rank holds the whole
    head's vocabulary columns (its d rows cut over data under ZeRO) and
    its projector's w1 columns are the rank's."""
    d = runs.cfgs[1].d_model
    want = {"2x2-tp-zero-remat-seq": (2, [d // 2, VOCAB], [D_VIS // 2,
                                                          d // 2]),
            "2x2-tp-zero": (2, [d // 2, VOCAB], [D_VIS // 2, d // 2]),
            "1x4-tp": (4, [d, VOCAB], [D_VIS, d // 4]),
            "4x1-zero": (1, [d // 4, VOCAB], [D_VIS // 4, d]),
            "4x1-dp": (1, [d, VOCAB], [D_VIS, d])}
    for name, (tp, head, w1) in want.items():
        for r in runs.res[name]:
            assert (r["tp"], r["split_vocab"], r["head"], r["w1"]) == \
                (tp, False, head, w1), name


def test_data_parallel_vlm_steps_match_jax_make_train_step(runs):
    """(4, 1) DP against the JAX executor on 4 fake devices with
    ``tp=False, zero=False``, the patches split over data."""
    assert runs.res["4x1-dp"][0]["losses"] == pytest.approx(runs.jax_dp,
                                                            rel=JAX_TOL)


@pytest.mark.parametrize("case", SERVE_CASES, ids=SERVE_NAMES)
def test_sharded_vlm_prefill_with_patches_gives_each_rank_its_lanes(runs,
                                                                   case):
    ranks, want = runs.res[f"serve-{case[0]}"], runs.ref["prefill"]
    for r in ranks:
        lo, hi = r["lanes"]
        got = np.asarray(r["prefill"])
        assert got.shape == (hi - lo, S, VOCAB)
        assert np.abs(got - want[lo:hi]).max() <= RTOL * np.abs(want).max()
    covered = sorted({tuple(r["lanes"]) for r in ranks})
    assert covered[0][0] == 0 and covered[-1][1] == B


@pytest.mark.parametrize("case", SERVE_CASES, ids=SERVE_NAMES)
def test_sharded_vlm_decode_matches_the_single_process(runs, case):
    """Every rank returns every lane's whole logits (the head whole under
    TP) and the single process's greedy tokens."""
    ranks, ref = runs.res[f"serve-{case[0]}"], runs.ref
    for r in ranks:
        assert r["tokens"] == ref["tokens"].tolist()
        assert _rel(np.asarray(r["logits"]), ref["logits"]) <= RTOL
    assert {r["kv"] for r in ranks} == (
        {None} if case[1][1] == 1 else {"seq"})


def test_sharded_paged_engine_serves_the_vlm_as_one_process(runs):
    """The paged engine on (2, 2) with TP (the rank's heads, the whole head
    on every rank), text-only: the single process's tokens on every
    rank."""
    assert all(r == runs.ref["paged"] for r in runs.res["paged"])
    assert all(len(t) > 0 for t in runs.ref["paged"])


def test_single_process_checkpoint_restores_into_the_ranks(runs):
    """Each rank's restored leaves, the projector's included, are its
    ``shard_tensor`` slices of the single process's saved state, bit for
    bit, and the ranks agree on the step that follows."""
    ranks = runs.res["ckpt"]
    assert all(r["restored_shards_equal"] for r in ranks)
    assert len({r["loss"] for r in ranks}) == 1


def test_sharded_checkpoint_restores_in_one_process_and_in_jax(runs):
    """The ranks' save is the gathered state, bit for bit, through the
    port's one-process ``restore_train_state`` and through JAX
    ``restore_train_state`` (the projector at ``projector/w1`` ...)."""
    cj, ct = runs.cfgs
    d = runs.tmp / "ckpt_sharded"
    model, opt = init_train_state(ct, seed=5, device="cpu")
    _, _, step = restore_train_state(model, opt, d)
    assert step == 2 and opt["step"] == 2
    want = runs.ckpt_gathered
    named = [n for n, _ in model.named_parameters()]
    for n, p in model.named_parameters():
        assert np.array_equal(p.detach().numpy(), want[n]), n
    for k in OPT:
        for n, t in zip(named, opt[k]):
            assert np.array_equal(t.numpy(), want[f"{k}/{n}"]), (k, n)
    tmpl = jax_init_lm(jax.random.PRNGKey(3), cj)
    params_j, opt_j, step_j = jax_restore(tmpl, jax_adamw_init(tmpl), d)
    assert step_j == 2 and int(opt_j["step"]) == 2
    got = dict(jax.tree_util.tree_flatten_with_path(params_j)[0])
    flat = flat_from_leaves(model, list(model.parameters()))
    assert len(got) == len(flat) and "projector/w1" in flat
    for path, a in got.items():
        key = "/".join(str(getattr(x, "key", getattr(x, "idx", x)))
                       for x in path)
        assert np.array_equal(np.asarray(a), flat[key].numpy()), key


def test_train_cli_ranks_trains_internvl2_as_one_process(capsys):
    """``train --arch internvl2-26b --reduced --ranks 4`` (the plan's
    policy over 4 spawned CPU ranks, batches with ``patches``) gives the
    one-process CLI's losses: the first (the same weights and batch)
    within 1e-5, the next two within ``CLI_BF16_RTOL``."""
    sharded = train_cli.main([*CLI_ARGV, "--ranks", "4"])
    out = capsys.readouterr().out
    assert "mesh={'data': 4, 'model': 1}" in out and "policy=" in out
    single = train_cli.main([*CLI_ARGV, "--ranks", "1"])
    got, want = ([h["loss"] for h in hist] for hist in (sharded, single))
    assert len(got) == 3 and all(np.isfinite(got))
    assert got[0] == pytest.approx(want[0], rel=RTOL)
    assert got == pytest.approx(want, rel=CLI_BF16_RTOL)
    assert all(h["gloo_bytes_sent"] > 0 for h in sharded)
