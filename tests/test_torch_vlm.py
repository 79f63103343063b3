"""The port's vision-language model (internvl2-26b) against the JAX
package's, on the CPU.

Reduced internvl2-26b in fp32, changed so that what the reduced config
hides shows: d 384, 6 query heads over 1 KV head of dh 64 (a GQA group of
6, the full model's), d_ff 768, 16 vision tokens of ``d_vision`` 192 (the
projector's w1 is not square, so a transposed w1 fails), vocabulary 1024,
2 layers.  Weights come from JAX ``init_lm`` (its projector included) and
are bridged into the port (``repro_torch.bridge.params_from_jax``);
tokens, labels and patches come from the same seeded data pipeline.  On
the CPU every attention takes the flash kernel's plain version,
autodiffed by torch.

Tolerances (fp32, sums in another order): ``project`` within 1e-6 of its
largest output; ``lm_forward`` logits and ``make_prefill_step`` within
1e-5 of their largest; ``lm_loss`` 1e-5 relative and every gradient (the
projector's included) within 1e-4 of its leaf's largest magnitude; three
training steps 1e-4 relative against JAX ``make_train_step`` on a
one-device mesh; both serving engines token-identical to JAX ``serve`` and
``serve_paged`` (text-only, as the reference serves a VLM); the bridge and
checkpoints bit for bit both ways in bf16.  Also here: the train CLI's
batches with ``patches``, and the pipeline runtime's refusal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import restore_train_state as jax_restore
from repro.checkpointing import save_train_state as jax_save
from repro.configs import get_config as jax_get_config
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import batch_specs as jax_batch_specs
from repro.data.pipeline import synthetic_lm_batches as jax_batches
from repro.launch.mesh import make_local_mesh as jax_make_local_mesh
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import serve as jax_serve
from repro.launch.serve import serve_paged as jax_serve_paged
from repro.models.embedding import init_projector as jax_init_projector
from repro.models.embedding import project as jax_project
from repro.models.transformer import init_lm as jax_init_lm
from repro.models.transformer import lm_forward as jax_lm_forward
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adamw_update as jax_adamw_update
from repro.runtime import executor as jax_executor
from repro.runtime.sharding import ShardPolicy as JaxShardPolicy
from repro.serving import EngineConfig as JaxEngineConfig
from repro_torch.bridge import (flat_from_leaves, params_from_jax,
                                tree_from_params)
from repro_torch.checkpointing import restore_train_state, save_train_state
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import LM, build_stacks, init_lm, lm_forward, lm_loss
from repro_torch.models.embedding import Projector, project
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime.executor import (init_train_state, make_prefill_step,
                                          make_train_step)
from repro_torch.runtime.pipeline import init_stage, stage_split_params
from repro_torch.serving import EngineConfig, ServeRequest, ServingEngine

torch.set_num_threads(1)

ARCH = "internvl2-26b"
CHANGES = dict(n_heads=6, n_kv_heads=1, head_dim=64, d_vision=192)
SEQ, BATCH = 24, 2


def _cfgs(dtype="float32"):
    """(JAX, port) reduced internvl2 at d 384 with ``CHANGES``."""
    return tuple(c(ARCH).reduced(d_model=384).with_(
        dtype=getattr(m, dtype), **CHANGES)
        for c, m in ((jax_get_config, jnp), (get_config, torch)))


def _bridged(seed=0, dtype="float32"):
    cfg_j, cfg_t = _cfgs(dtype)
    params_j = jax.jit(lambda k: jax_init_lm(k, cfg_j))(
        jax.random.PRNGKey(seed))
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def _dcfg(cfg, seed=1234, seq=SEQ, batch=BATCH):
    return JaxDataConfig(seq_len=seq, global_batch=batch,
                         vocab_size=cfg.vocab_size,
                         vision_tokens=cfg.vision_tokens,
                         d_vision=cfg.d_vision, seed=seed)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: max|diff| / max|ref| = {err:.3e} > {tol}"


def test_the_config_equals_the_reference_config():
    """Every field of the port's internvl2-26b equals the JAX package's,
    the dtype apart."""
    got, want = get_config(ARCH), jax_get_config(ARCH)
    assert got.name == ARCH and got.arch_type == "vlm"
    fields = set(got.__dataclass_fields__) - {"dtype"}
    assert fields == set(want.__dataclass_fields__) - {"dtype"}
    assert {f: getattr(got, f) for f in fields} == \
        {f: getattr(want, f) for f in fields}
    assert (got.n_layers, got.d_model, got.n_heads, got.n_kv_heads, got.dh,
            got.d_ff, got.vocab_size, got.vision_tokens, got.d_vision) == \
        (48, 6144, 48, 8, 128, 16384, 92553, 256, 3200)


def test_build_stacks_and_init_lm_build_the_vlm():
    """One segment of dense blocks, as the reference's, and a projector of
    w1 (d_vision, d), b1 (d,), w2 (d, d), b2 (d,) beside an untied head;
    other archs have none."""
    _, cfg = _cfgs()
    assert build_stacks(cfg) == [("dense", cfg.n_layers)]
    model = init_lm(cfg, device="cpu")
    assert isinstance(model.projector, Projector)
    assert {n: tuple(p.shape) for n, p in
            model.projector.named_parameters()} == {
        "w1": (192, 384), "b1": (384,), "w2": (384, 384), "b2": (384,)}
    assert model.head is not None
    assert not model.projector.b1.any() and not model.projector.b2.any()
    full = init_lm(get_config(ARCH), device="meta")
    assert sum(p.numel() for p in full.parameters()) == 19_918_682_112
    assert init_lm(get_config("qwen3-4b").reduced(),
                   device="cpu").projector is None


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-6),
                                       ("bfloat16", 1e-2)])
def test_project_matches_jax(dtype, tol):
    """``project`` on weights from JAX ``init_projector``, (3, 16, 192)
    patches to width 384: fp32 within 1e-6 of the largest output, bf16
    (the GELU in fp32 between two bf16 products, as the reference) within
    one bf16 rounding of it."""
    p_j = jax_init_projector(jax.random.PRNGKey(3), 192, 384,
                             getattr(jnp, dtype))
    rng = np.random.default_rng(3)
    p_j = dict(p_j, b1=jnp.asarray(rng.standard_normal(384), p_j["b1"].dtype),
               b2=jnp.asarray(rng.standard_normal(384), p_j["b2"].dtype))
    x = rng.standard_normal((3, 16, 192)).astype(np.float32)
    want = jax_project(p_j, jnp.asarray(x, getattr(jnp, dtype)))
    p_t = Projector(*(torch.from_numpy(np.array(p_j[k], np.float32)).to(
        getattr(torch, dtype)) for k in ("w1", "b1", "w2", "b2")))
    got = project(p_t, torch.from_numpy(x).to(getattr(torch, dtype)))
    assert got.dtype == getattr(torch, dtype)
    _close(got.float().detach(), np.asarray(want, np.float32), tol,
           "project")


def test_lm_forward_with_patches_matches_jax():
    """Logits (B, S, V) of the text rows: the patches projected and
    prepended, the stack over 16 + 24 rows at positions 0..39; without
    patches the text-only forward."""
    cfg_j, cfg_t, params_j, params_t = _bridged()
    b = next(jax_batches(_dcfg(cfg_t, seed=5)))
    assert b["patches"].shape == (BATCH, 16, 192)
    want, _ = jax_lm_forward(params_j, jnp.asarray(b["tokens"]), cfg_j,
                             patches=jnp.asarray(b["patches"]))
    got, aux = lm_forward(params_t, torch.from_numpy(b["tokens"]), cfg_t,
                          patches=torch.from_numpy(b["patches"]))
    assert got.shape == (BATCH, SEQ, cfg_t.vocab_size) and float(aux) == 0
    _close(got.detach(), want, 1e-5, "logits with patches")
    text, _ = lm_forward(params_t, torch.from_numpy(b["tokens"]), cfg_t)
    want_text, _ = jax_lm_forward(params_j, jnp.asarray(b["tokens"]), cfg_j)
    _close(text.detach(), want_text, 1e-5, "logits without patches")
    assert not torch.allclose(text, got)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_lm_loss_and_every_gradient_match_jax(remat):
    cfg_j, cfg_t, params_j, params_t = _bridged(seed=1)
    b = next(jax_batches(_dcfg(cfg_t, seed=7)))
    b["labels"] = b["labels"].copy()        # a view of the tokens' array
    b["labels"][0, :5] = -100
    batch_j = {k: jnp.asarray(v) for k, v in b.items()}
    segs = [remat] if remat else None
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, batch_j, cfg_j,
                              remat_segments=segs)))(params_j)
    leaves = list(params_t.parameters())
    loss_t = lm_loss(params_t, _torch(b), cfg_t, remat_segments=segs)
    grads_t = torch.autograd.grad(loss_t, leaves)
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    want = params_from_jax(jax.tree.map(np.asarray, grads_j), cfg_t,
                           device="cpu")
    named = list(want.named_parameters())
    assert len(named) == len(grads_t) == len(leaves)
    assert {n for n, _ in named if n.startswith("projector.")} == {
        "projector.w1", "projector.b1", "projector.w2", "projector.b2"}
    for (name, w), g in zip(named, grads_t):
        assert float(g.abs().max()) > 0, name
        _close(g.numpy(), w.detach().numpy(), 1e-4, name)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_three_train_steps_follow_jax_make_train_step(remat):
    """The port's ``make_train_step`` against JAX ``make_train_step`` on a
    one-device mesh, from JAX ``init_train_state``'s weights bridged into
    the port, on batches with patches."""
    cfg_j, cfg_t = _cfgs()
    policy = JaxShardPolicy(tp=False, zero=False, remat_segments=(remat,))
    dcfg = _dcfg(cfg_t)
    ocfg_j, ocfg_t = JaxAdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)
    mesh = jax_make_local_mesh()
    with mesh:
        built = jax_executor.make_train_step(cfg_j, mesh, policy,
                                             jax_batch_specs(dcfg), ocfg_j)
        params_j, opt_j = jax_executor.init_train_state(cfg_j, mesh, policy)
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    start = {k: v.detach().clone()
             for k, v in params_t.projector.named_parameters()}
    opt_t = adamw_init(list(params_t.parameters()), ocfg_t)
    step = make_train_step(cfg_t, ocfg_t, remat_segments=[remat])
    gen = jax_batches(dcfg)
    losses = []
    for _ in range(3):
        b = next(gen)
        assert "patches" in b
        with mesh:
            params_j, opt_j, m_j = built.fn(
                params_j, opt_j, {k: jnp.asarray(v) for k, v in b.items()})
        m_t = step(params_t, opt_t, _torch(b))
        assert float(m_t["loss"]) == pytest.approx(float(m_j["loss"]),
                                                   rel=1e-4)
        assert float(m_t["grad_norm"]) == pytest.approx(
            float(m_j["grad_norm"]), rel=1e-4)
        losses.append(float(m_t["loss"]))
    assert losses[-1] < losses[0]
    for name, p in params_t.projector.named_parameters():    # it trains
        assert not torch.equal(p.detach(), start[name]), name


def test_make_prefill_step_with_patches_matches_jax():
    """The port's prefill step against JAX ``make_prefill_step`` on a
    one-device mesh, both given the patches."""
    cfg_j, cfg_t, params_j, params_t = _bridged(seed=2)
    b = next(jax_batches(_dcfg(cfg_t, seed=9)))
    b.pop("labels")
    spec = {k: jax.ShapeDtypeStruct(v.shape, v.dtype) for k, v in b.items()}
    mesh = jax_make_local_mesh()
    with mesh:
        built = jax_executor.make_prefill_step(
            cfg_j, mesh, JaxShardPolicy(tp=False, zero=False), spec)
        want = built.fn(params_j, {k: jnp.asarray(v) for k, v in b.items()})
    got = make_prefill_step(cfg_t)(params_t, _torch(b))
    assert got.shape == (BATCH, SEQ, cfg_t.vocab_size)
    assert not got.requires_grad
    _close(got, want, 1e-5, "prefill with patches")


def _requests(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, int(rng.integers(3, 13))
                          ).tolist(), int(rng.integers(3, 7)))
            for _ in range(n)]


def test_dense_serve_token_identical_to_jax():
    """The dense-cache engine with slot recycling, text-only: 5 requests
    on 2 lanes of a 24-token cache, JAX ``serve``'s weights (``init_lm``
    seed 0 under jit, the projector drawn and idle)."""
    cfg_j, cfg_t, _, params_t = _bridged()
    spec = _requests(cfg_t, 5, 5)
    reqs_j = [JaxRequest(i, list(p), n) for i, (p, n) in enumerate(spec)]
    reqs_t = [serve_cli.Request(i, list(p), n)
              for i, (p, n) in enumerate(spec)]
    jax_serve(cfg_j, reqs_j, batch=2, context=24, seed=0, verbose=False)
    serve_cli.serve(cfg_t, reqs_t, batch=2, context=24, verbose=False,
                    device="cpu", params=params_t)
    for rj, rt in zip(reqs_j, reqs_t):
        assert rt.generated == rj.generated, f"request {rj.rid}"
        assert rt.done and len(rt.generated) == rt.max_new


def test_paged_serve_token_identical_to_jax():
    """The paged engine (chunked prefill, continuous batching) against JAX
    ``serve_paged`` on its weights, text-only."""
    cfg_j, cfg_t, _, params_t = _bridged()
    geo = dict(page_size=4, n_pages=24, decode_slots=3, max_context=24,
               prefill_batch=2, prefill_chunk=4)
    spec = _requests(cfg_t, 6, 6)
    reqs_j = [JaxRequest(i, list(p), n) for i, (p, n) in enumerate(spec)]
    jax_serve_paged(cfg_j, reqs_j, JaxEngineConfig(**geo), seed=0,
                    verbose=False)
    reqs_t = [ServeRequest(rid=str(i), prompt=list(p), max_new=n)
              for i, (p, n) in enumerate(spec)]
    ServingEngine(cfg_t, params_t, EngineConfig(**geo),
                  device="cpu").run(reqs_t)
    for rj, rt in zip(reqs_j, reqs_t):
        assert rt.tokens == rj.generated, f"request {rj.rid}"
        assert rt.done


@pytest.mark.parametrize("engine", ["paged", "dense"])
def test_serve_cli_serves_internvl2_on_cpu(engine, capsys):
    reqs = serve_cli.main(["--arch", ARCH, "--engine", engine, "--device",
                           "cpu", "--requests", "3", "--batch", "2",
                           "--max-new", "4"])
    assert all(r.done and len(r.generated) == 4 for r in reqs)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


def test_bridge_carries_the_projector_both_ways_bit_for_bit():
    """bf16 JAX ``init_lm`` -> the port -> the JAX tree: every leaf, the
    projector's included, the same bits; a projector key the bridge does
    not know raises."""
    cfg_j, cfg_t = _cfgs("bfloat16")
    tree = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(4),
                                                cfg_j))
    model = params_from_jax(tree, cfg_t, device="cpu")
    assert isinstance(model, LM) and model.projector.w1.dtype == \
        torch.bfloat16
    back = tree_from_params(model)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_j.keys() == flat_t.keys()
    assert any("projector" in str(k) for k in flat_j)
    for k, a in flat_j.items():
        assert a.dtype == flat_t[k].dtype and np.array_equal(
            a.view(np.uint8), flat_t[k].view(np.uint8)), k
    bad = dict(tree, projector=dict(tree["projector"], w3=tree["head"]))
    with pytest.raises(ValueError, match="projector"):
        params_from_jax(bad, cfg_t, device="cpu")


def _bf16_state(seed):
    """Reduced bf16 internvl2: JAX ``init_lm`` and an AdamW state after one
    update with random gradients."""
    cfg_j, cfg_t = _cfgs("bfloat16")
    params = jax_init_lm(jax.random.PRNGKey(seed), cfg_j)
    ocfg = JaxAdamWConfig(lr=1e-2)
    opt = jax_adamw_init(params, ocfg)
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32), p.dtype), params)
    params, opt, _ = jax_adamw_update(params, grads, opt, ocfg)
    return cfg_j, cfg_t, params, opt


def test_jax_checkpoint_restores_into_the_port_vlm(tmp_path):
    cfg_j, cfg_t, params, opt = _bf16_state(0)
    jax_save(1, params, opt, tmp_path, extra={"arch": ARCH})
    model = params_from_jax(jax.tree.map(np.asarray, jax_init_lm(
        jax.random.PRNGKey(5), cfg_j)), cfg_t, device="cpu")
    state = adamw_init(list(model.parameters()))
    _, _, step = restore_train_state(model, state, tmp_path)
    assert step == 1 and state["step"] == 1
    want = params_from_jax(jax.tree.map(np.asarray, params), cfg_t,
                           device="cpu")
    for (name, p), q in zip(model.named_parameters(), want.parameters()):
        assert p.dtype == q.dtype == torch.bfloat16, name
        assert torch.equal(p.detach().view(torch.int16),
                           q.detach().view(torch.int16)), name
    for k in ("master", "m", "v"):
        ref = params_from_jax(jax.tree.map(np.asarray, opt[k]), cfg_t,
                              device="cpu")
        for t, q in zip(state[k], ref.parameters()):
            assert t.dtype == torch.float32 and torch.equal(t, q), k


def test_port_checkpoint_restores_through_jax_vlm(tmp_path):
    cfg_j, cfg_t = _cfgs("bfloat16")
    model = params_from_jax(jax.tree.map(np.asarray, jax_init_lm(
        jax.random.PRNGKey(2), cfg_j)), cfg_t, device="cpu")
    state = adamw_init(list(model.parameters()))
    leaves = list(model.parameters())
    rng = np.random.default_rng(1)
    grads = [torch.from_numpy(rng.standard_normal(tuple(p.shape))
                              .astype(np.float32)).to(p.dtype)
             for p in leaves]
    adamw_update(leaves, grads, state, AdamWConfig(lr=1e-2))
    save_train_state(1, model, state, tmp_path)
    tmpl = jax_init_lm(jax.random.PRNGKey(7), cfg_j)
    params, opt, step = jax_restore(tmpl, jax_adamw_init(tmpl), tmp_path)
    assert step == 1 and int(opt["step"]) == 1
    flat_j = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(
        tree_from_params(model))[0])
    assert flat_j.keys() == flat_t.keys()
    for k, a in flat_j.items():
        assert a.dtype == flat_t[k].dtype and np.array_equal(
            np.asarray(a).view(np.uint8), flat_t[k].view(np.uint8)), k
    for key in ("master", "m", "v"):
        want = flat_from_leaves(model, state[key])
        got = jax.tree_util.tree_flatten_with_path(opt[key])[0]
        assert len(got) == len(want)
        for path, a in got:
            k = "/".join(str(getattr(x, "key", getattr(x, "idx", x)))
                         for x in path)
            assert np.array_equal(np.asarray(a), want[k].numpy()), (key, k)


def test_train_cli_trains_internvl2_on_cpu_with_patches(monkeypatch, capsys):
    """``train --arch internvl2-26b --reduced --device cpu``: its batches
    are JAX ``DataConfig``'s with ``vision_tokens`` and ``d_vision`` (the
    same bytes, ``patches`` included), and every step reaches the train
    step with them."""
    args = train_cli.parse_args(["--arch", ARCH, "--reduced", "--device",
                                 "cpu", "--seq", str(SEQ), "--batch",
                                 str(BATCH)])
    cfg = train_cli.config_from_args(args)
    got = next(train_cli.batches(cfg, args))
    want = next(jax_batches(JaxDataConfig(
        seq_len=SEQ, global_batch=BATCH, vocab_size=cfg.vocab_size,
        vision_tokens=cfg.vision_tokens, d_vision=cfg.d_vision)))
    assert got.keys() == want.keys() == {"tokens", "labels", "patches"}
    for k in want:
        assert got[k].dtype == want[k].dtype and np.array_equal(got[k],
                                                                want[k]), k
    seen = []
    real = train_cli.make_train_step

    def make(cfg, opt_cfg=None, *, remat_segments=None):
        step = real(cfg, opt_cfg, remat_segments=remat_segments)

        def recorded(params, opt, batch):
            seen.append((type(params), {k: tuple(v.shape)
                                        for k, v in batch.items()}))
            return step(params, opt, batch)
        return recorded

    monkeypatch.setattr(train_cli, "make_train_step", make)
    hist = train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                           "--steps", "3", "--batch", str(BATCH), "--seq",
                           str(SEQ), "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert "model: internvl2-26b" in out and out.strip().endswith("done.")
    patches = (BATCH, cfg.vision_tokens, cfg.d_vision)
    assert seen == [(LM, {"tokens": (BATCH, SEQ), "labels": (BATCH, SEQ),
                          "patches": patches})] * 3


@pytest.mark.parametrize("entry", ["cli", "init_stage", "stage_split"])
def test_the_pipeline_runtime_refuses_the_vlm(entry, monkeypatch):
    """The reference's pipeline loss reads the tokens only, so a VLM would
    train there text-only with its projector idle: the port's pipeline
    refuses it, naming the unpipelined executor, before any plan is
    searched or rank spawned."""
    _, cfg = _cfgs()
    if entry == "cli":
        def never(*a, **k):
            raise AssertionError("reached past the refusal")

        for name in ("plan_from_args", "_spawn"):
            monkeypatch.setattr(train_cli, name, never)
        with pytest.raises(ValueError, match="make_train_step"):
            train_cli.main(["--arch", ARCH, "--reduced", "--device", "cpu",
                            "--steps", "1", "--pipeline", "--ranks", "2"])
    elif entry == "init_stage":
        with pytest.raises(ValueError, match="VLM"):
            init_stage(cfg, 2, 1, 0, device="cpu")
    else:
        with pytest.raises(ValueError, match="projector"):
            stage_split_params(init_lm(cfg, device="cpu"), 2)


def test_init_train_state_draws_the_projector_once_a_model():
    """``init_train_state`` of the VLM: the projector among the leaves,
    AdamW's master a copy of each, and two draws from one seed the same
    numbers."""
    _, cfg = _cfgs()
    a, opt = init_train_state(cfg, seed=3, device="cpu")
    b, _ = init_train_state(cfg, seed=3, device="cpu")
    names = [n for n, _ in a.named_parameters()]
    assert names[-4:] == ["projector.w1", "projector.b1", "projector.w2",
                          "projector.b2"]
    assert all(torch.equal(x, y) for x, y in zip(a.parameters(),
                                                 b.parameters()))
    assert all(torch.equal(m, p) for m, p in zip(opt["master"],
                                                 a.parameters()))
