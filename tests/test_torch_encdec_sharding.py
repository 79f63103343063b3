"""The port's sharded encoder-decoder against the single-process port and
the JAX package, on the CPU.

The ranks are real processes: a module fixture starts 4 gloo ranks with
``launch/mesh.py::run_ranks`` (spawn, a ``file://`` rendezvous under a
temporary directory, one thread each, a 240 s limit).  The model is a
reduced fp32 whisper-medium bridged from JAX ``init_encdec`` (its default
4096-row decoder position table): 2 + 2 layers, d 128, 4 heads of dh 32,
d_ff 256, 32 encoder frames, and a vocabulary of 1001, which no ``model``
axis of 2 or 4 divides, so that TP meets a tied table it cannot split
(the reduced configs cap the vocabulary at 1024, which divides).  Batches
of 4 x 16 decoder tokens over 4 x 32 frames, made with numpy from a seed.

Training cases: (data 2, model 2) with TP, ZeRO, remat and ``seq_shard``;
(1, 4) with TP; (4, 1) with ZeRO; (4, 1) with DP.  Each bridges the JAX
weights into a full port model, keeps the rank's shards
(``shard_train_state``), runs ``make_sharded_loss`` on one batch and
gathers every gradient leaf, then trains three sharded AdamW steps from
the same weights.  Beside the ranks, ``conftest.run_subprocess`` runs JAX
``make_train_step`` for whisper on a (4, 1) mesh of fake devices with
``tp=False, zero=False``.

Serving cases: the sharded ``make_prefill_step`` and 8 greedy steps of
``make_serve_step`` on a 16-slot cache, on (2, 2) without TP (the self
caches' context over ``model``), with TP (the rank's heads, its cross K/V
heads too), with TP and the KV heads over ``model``
(``shard_cache_seq=False``), and on (4, 1) with ZeRO (a lane a rank).

Checkpoints on (2, 2) with TP and ZeRO: the ranks restore a
single-process save into fresh shards, and save after a sharded step; the
files are interchangeable with the single process's and JAX's.

Tolerances (fp32, sums in another order): the loss within 1e-5 relative
and every gathered gradient leaf within 1e-5 of its largest magnitude of
the single-process port, within 1e-4 of JAX
``jax.value_and_grad(encdec_loss)``; three steps' losses within 1e-5 of
the single-process ``make_train_step`` (DP's also within 1e-4 of JAX's on
4 fake devices); serving logits within 1e-5 of the single process's
largest, with its greedy tokens on every rank; checkpoints bit for bit.
``train --arch whisper-medium --reduced --ranks 4`` gives the one-process
CLI's first loss within 1e-5 and the next two within 2e-3 (the CLI's
reduced model is bf16).
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

from repro.checkpointing import restore_train_state as jax_restore
from repro.configs import get_config as jax_get_config
from repro.models import encdec as jax_encdec
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.bridge import flat_from_leaves, params_from_jax
from repro_torch.checkpointing import (restore_sharded_train_state,
                                       restore_train_state,
                                       save_sharded_train_state,
                                       save_train_state)
from repro_torch.configs import get_config
from repro_torch.launch import train as train_cli
from repro_torch.launch.mesh import (init_distributed, make_local_mesh,
                                     run_ranks)
from repro_torch.models import (decode_train, encdec_decode_step,
                                encdec_loss, encode, init_encdec_decode_state)
from repro_torch.optim import AdamWConfig, adamw_init, global_norm
from repro_torch.runtime import (ShardPolicy, gather_params,
                                 init_train_state, make_prefill_step,
                                 make_serve_step, make_sharded_loss,
                                 make_train_step, shard_serving_params,
                                 shard_train_state)

torch.set_num_threads(1)

WORLD = 4
TIMEOUT_S = 240
B, S, STEPS = 4, 16, 3
CONTEXT, DECODE_STEPS = 16, 8
VOCAB = 1001
RTOL, GRAD_TOL, JAX_TOL = 1e-5, 1e-5, 1e-4
# bf16 training through the CLI, ranks against one process, steps after
# the first: its 4 ranks' bf16 gradient sums round otherwise than one
# process's (1.6e-5 at step 2, measured), so six times that
CLI_BF16_RTOL = 1e-4
R = (True,)
# (name, (data, model), policy)
CASES = [("2x2-tp-zero-remat-seq", (2, 2),
          dict(tp=True, zero=True, remat_segments=R, seq_shard=True)),
         ("1x4-tp", (1, 4), dict(tp=True, zero=False)),
         ("4x1-zero", (4, 1), dict(tp=False, zero=True)),
         ("4x1-dp", (4, 1), dict(tp=False, zero=False))]
CASE_NAMES = [c[0] for c in CASES]
SERVE_CASES = [("2x2-context", (2, 2), dict(tp=False, zero=False)),
               ("2x2-tp", (2, 2), dict(tp=True, zero=False)),
               ("2x2-tp-heads", (2, 2),
                dict(tp=True, zero=False, shard_cache_seq=False)),
               ("4x1-zero", (4, 1), dict(tp=False, zero=True))]
SERVE_NAMES = [c[0] for c in SERVE_CASES]
CKPT_MESH, CKPT_POLICY = (2, 2), dict(tp=True, zero=True)
OPT = ("master", "m", "v")
CLI_ARGV = ["--arch", "whisper-medium", "--reduced", "--device", "cpu",
            "--steps", "3", "--batch", "4", "--seq", "16", "--log-every",
            "1"]


def _cfgs():
    """(JAX, port) configs of the reduced fp32 whisper."""
    return tuple(c("whisper-medium").reduced(d_model=128).with_(
        n_heads=4, n_kv_heads=4, head_dim=32, vocab_size=VOCAB, dtype=dt)
        for c, dt in ((jax_get_config, jnp.float32),
                      (get_config, torch.float32)))


def _batches():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(STEPS):
        b = {k: rng.integers(0, VOCAB, (B, S), dtype=np.int32)
             for k in ("tokens", "labels")}
        b["frames"] = rng.standard_normal((B, 32, 128), dtype=np.float32)
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
                            "losses": losses,
                            "split_vocab": ctx.split_vocab})
            if rank == 0:
                np.savez(f"{out_dir}/{name}.npz", **full)
        frames = torch.from_numpy(batches[0]["frames"])
        first = torch.from_numpy(batches[0]["tokens"][:, 0]).long()
        for name, shape, pk in SERVE_CASES:
            mesh, pol = _mesh(meshes, shape), ShardPolicy(**pk)
            params = shard_serving_params(fresh(), mesh, pol, cfg=cfg)
            prefill = make_prefill_step(cfg, mesh=mesh, policy=pol)
            block = prefill(params, _batch(batches[0]))
            step = make_serve_step(cfg, mesh=mesh, policy=pol)
            state = init_encdec_decode_state(params, frames, cfg, CONTEXT,
                                             shard=step.shard)
            logits, tokens = _greedy(step, params, state, first)
            lay = state["layout"]
            gathered(f"serve-{name}", {
                "prefill": block.numpy().tolist(),
                "lanes": list(prefill.shard.lane_range(B)),
                "logits": logits.numpy().tolist(),
                "tokens": tokens.numpy().tolist(), "kv": lay.kv,
                "cache": list(state["self_cache"][0]["k"].shape),
                "cross": list(state["cross_kv"][0][0].shape)})
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
cfg = get_config("whisper-medium").reduced(d_model=128).with_(
    n_heads=4, n_kv_heads=4, head_dim=32, vocab_size=VOCAB,
    dtype=jnp.float32)
mesh = jax.make_mesh((4, 1), ("data", "model"), devices=jax.devices()[:4])
pol = ShardPolicy(tp=False, zero=False)
batches = np.load("BATCHES")
spec = {k: jax.ShapeDtypeStruct(batches[k].shape[1:], batches[k].dtype)
        for k in ("tokens", "labels", "frames")}
try:
    with mesh:
        step = make_train_step(cfg, mesh, pol, spec)
        params, opt = init_train_state(cfg, mesh, pol)
        losses = []
        for i in range(batches["tokens"].shape[0]):
            b = {k: jnp.asarray(batches[k][i]) for k in spec}
            params, opt, m = step.fn(params, opt, b)
            losses.append(float(m["loss"]))
    print("LOSSES", losses)
except Exception as e:
    print("RAISED", type(e).__name__)
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on 4 gloo ranks; the single-process port and JAX
    references; JAX DP on 4 fake devices (run beside the ranks)."""
    tmp = tmp_path_factory.mktemp("encdec_sharding")
    cj, ct = _cfgs()
    params_j = jax_encdec.init_encdec(jax.random.PRNGKey(0), cj)
    tree = jax.tree.map(np.asarray, params_j)
    batches = _batches()
    b0 = batches[0]
    jl, jg = jax.jit(jax.value_and_grad(lambda p: jax_encdec.encdec_loss(
        p, {k: jnp.asarray(v) for k, v in b0.items()}, cj)))(params_j)
    port = params_from_jax(tree, ct, device="cpu")
    pl = encdec_loss(port, _batch(b0), ct)
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
    # serving: the single process's prefill and greedy decode
    with torch.inference_mode():
        frames = torch.from_numpy(b0["frames"])
        ref["prefill"] = decode_train(port, torch.from_numpy(b0["tokens"]),
                                      encode(port, frames, ct), ct).numpy()
        state = init_encdec_decode_state(port, frames, ct, CONTEXT)
        logits, tokens = _greedy(
            lambda p, s, t: encdec_decode_step(p, s, t, ct), port, state,
            torch.from_numpy(b0["tokens"][:, 0]).long())
    ref["logits"], ref["tokens"] = logits.numpy(), tokens.numpy()
    # the single-process checkpoint the ranks restore: one AdamW step
    single = params_from_jax(tree, ct, device="cpu")
    single_opt = adamw_init(list(single.parameters()))
    make_train_step(ct)(single, single_opt, _batch(b0))
    save_train_state(1, single, single_opt, tmp / "ckpt_single")
    np.savez(tmp / "batches.npz",
             **{k: np.stack([b[k] for b in batches])
                for k in ("tokens", "labels", "frames")})
    code = (JAX_DP.replace("BATCHES", str(tmp / "batches.npz"))
            .replace("VOCAB", str(VOCAB)))
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
    line = [x for x in jax_out.splitlines()
            if x.startswith(("LOSSES", "RAISED"))][0]
    jax_dp = (json.loads(line[len("LOSSES "):]) if line.startswith("LOSSES")
              else line[len("RAISED "):])
    return types.SimpleNamespace(res=res, grads=grads, ref=ref, tmp=tmp,
                                 ckpt_gathered=ckpt_gathered, jax_dp=jax_dp,
                                 tree=tree, cfgs=(cj, ct))


def _rel(got, want):
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_sharded_encdec_loss_and_grads_match_the_single_process(runs, case):
    name = case[0]
    ranks, ref = runs.res[name], runs.ref
    assert all(r == ranks[0] for r in ranks)    # every rank alike
    assert ranks[0]["loss"] == pytest.approx(ref["loss"], rel=RTOL)
    assert set(runs.grads[name]) == set(ref["grads"])
    for k, g in runs.grads[name].items():
        assert _rel(g, ref["grads"][k]) <= GRAD_TOL, (name, k)
    assert ranks[0]["gnorm"] == pytest.approx(ref["gnorm"], rel=RTOL)


@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_sharded_encdec_loss_and_grads_match_jax(runs, case):
    name = case[0]
    assert runs.res[name][0]["loss"] == pytest.approx(runs.ref["jax_loss"],
                                                      rel=JAX_TOL)
    for k, g in runs.grads[name].items():
        assert _rel(g, runs.ref["jax_grads"][k]) <= JAX_TOL, (name, k)


@pytest.mark.parametrize("case", CASES, ids=CASE_NAMES)
def test_three_sharded_encdec_steps_match_the_single_process(runs, case):
    got = runs.res[case[0]][0]["losses"]
    assert got == pytest.approx(runs.ref["losses"], rel=RTOL)


def test_tp_keeps_the_tied_table_whole_where_the_vocabulary_does_not_split(
        runs):
    """1001 splits over no model axis: under TP every rank looks up and
    projects onto the whole table (``ShardContext.split_vocab`` off)."""
    assert all(not r["split_vocab"] for name in CASE_NAMES
               for r in runs.res[name])


def test_data_parallel_encdec_steps_match_jax_make_train_step(runs):
    """(4, 1) DP against the JAX executor on 4 fake devices, which runs
    whisper with ``tp=False, zero=False``."""
    assert isinstance(runs.jax_dp, list), runs.jax_dp
    assert runs.res["4x1-dp"][0]["losses"] == pytest.approx(runs.jax_dp,
                                                            rel=JAX_TOL)


@pytest.mark.parametrize("case", SERVE_CASES, ids=SERVE_NAMES)
def test_sharded_encdec_decode_matches_the_single_process(runs, case):
    """Every rank returns every lane's whole logits and the single
    process's greedy tokens."""
    ranks, ref = runs.res[f"serve-{case[0]}"], runs.ref
    for r in ranks:
        assert r["tokens"] == ref["tokens"].tolist()
        assert _rel(np.asarray(r["logits"]), ref["logits"]) <= RTOL


@pytest.mark.parametrize("case", SERVE_CASES, ids=SERVE_NAMES)
def test_sharded_encdec_prefill_gives_each_rank_its_lanes(runs, case):
    ranks, want = runs.res[f"serve-{case[0]}"], runs.ref["prefill"]
    for r in ranks:
        lo, hi = r["lanes"]
        got = np.asarray(r["prefill"])
        assert got.shape == (hi - lo, S, VOCAB)
        assert np.abs(got - want[lo:hi]).max() <= RTOL * np.abs(want).max()
    covered = sorted({tuple(r["lanes"]) for r in ranks})
    assert covered[0][0] == 0 and covered[-1][1] == B


def test_sharded_encdec_decode_state_layout(runs):
    """Where the state lies: lanes over data, the self caches' context (or
    KV heads) over model, the cross K/V of the rank's lanes and, under
    TP, of its heads."""
    cfg = runs.cfgs[1]
    H, dh, T = cfg.n_kv_heads, cfg.dh, cfg.encoder_seq
    want = {"2x2-context": ("seq", [2, CONTEXT // 2, H, dh], [2, T, H, dh]),
            "2x2-tp": ("seq", [2, CONTEXT // 2, H, dh], [2, T, H // 2, dh]),
            "2x2-tp-heads": ("heads", [2, CONTEXT, H // 2, dh],
                             [2, T, H // 2, dh]),
            "4x1-zero": (None, [1, CONTEXT, H, dh], [1, T, H, dh])}
    for name, (kv, cache, cross) in want.items():
        for r in runs.res[f"serve-{name}"]:
            assert (r["kv"], r["cache"], r["cross"]) == (kv, cache, cross)


def test_single_process_checkpoint_restores_into_the_ranks(runs):
    """Each rank's restored leaves are its ``shard_tensor`` slices of the
    single process's saved state, bit for bit, and the ranks agree on the
    step that follows."""
    ranks = runs.res["ckpt"]
    assert all(r["restored_shards_equal"] for r in ranks)
    assert len({r["loss"] for r in ranks}) == 1


def test_sharded_checkpoint_restores_in_one_process_and_in_jax(runs):
    """The ranks' save is the gathered state, bit for bit, through the
    port's one-process ``restore_train_state`` and through JAX
    ``restore_train_state``."""
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
    tmpl = jax_encdec.init_encdec(jax.random.PRNGKey(3), cj)
    params_j, opt_j, step_j = jax_restore(tmpl, jax_adamw_init(tmpl), d)
    assert step_j == 2 and int(opt_j["step"]) == 2
    got = dict(jax.tree_util.tree_flatten_with_path(params_j)[0])
    flat = flat_from_leaves(model, list(model.parameters()))
    assert len(got) == len(flat)
    for path, a in got.items():
        key = "/".join(str(getattr(x, "key", getattr(x, "idx", x)))
                       for x in path)
        assert np.array_equal(np.asarray(a), flat[key].numpy()), key


def test_train_cli_ranks_trains_whisper_as_one_process(capsys):
    """``train --arch whisper-medium --reduced --ranks 4`` (the plan's
    policy over 4 spawned CPU ranks, batches with ``frames``) gives the
    one-process CLI's losses: the first (the same weights and batch)
    within 1e-5, the next two within ``CLI_BF16_RTOL``.  The CLI's reduced
    model is bf16, and its bf16 gradients summed over 4 ranks round
    otherwise than one process's (measured: 1.6e-5 at step 2)."""
    sharded = train_cli.main([*CLI_ARGV, "--ranks", "4"])
    out = capsys.readouterr().out
    assert "mesh={'data': 4, 'model': 1}" in out and "policy=" in out
    single = train_cli.main([*CLI_ARGV, "--ranks", "1"])
    got, want = ([h["loss"] for h in hist] for hist in (sharded, single))
    assert len(got) == 3 and all(np.isfinite(got))
    assert got[0] == pytest.approx(want[0], rel=RTOL)
    assert got == pytest.approx(want, rel=CLI_BF16_RTOL)
    assert all(h["gloo_bytes_sent"] > 0 for h in sharded)
