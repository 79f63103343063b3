"""The port's Qwen2/Qwen3 dense family (qwen3-8b, qwen2.5-14b, qwen2-72b)
against the JAX package's, on the CPU.

The configs first: each equals the reference's field by field, and the
port's ``list_archs()`` equals the JAX package's.

Then reduced fp32 models that keep what ``reduced()`` drops: 2 layers, dh
32, and each arch's GQA group (``reduced()`` alone makes qwen2.5-14b 4
heads over 4 KV heads, a group of 1).  qwen2.5-14b at d 320 with 10 query
heads over 2 KV heads (a group of 5, and 5 again on a TP rank's half);
qwen2-72b at d 256 with 8 over 1 (a group of 8); qwen3-8b at d 256 with 8
over 2 (a group of 4, with the QK-norm and no bias).  Weights come from
JAX ``init_lm``, whose QKV biases are zeros; the tests write biases drawn
with numpy from a seed (std 0.5) into the JAX tree before bridging it
(``repro_torch.bridge.params_from_jax``), so that a wrong add or a wrong
slice shows.  Tokens and labels come from the same seeded data pipeline.
On the CPU every attention takes the flash kernel's plain version,
autodiffed by torch.

Tolerances (fp32, sums in another order): ``lm_forward`` logits and
``make_prefill_step`` within 1e-5 of their largest; ``lm_loss`` 1e-5
relative and every gradient (the biases' included) within 1e-4 of its
leaf's largest magnitude, with and without remat; three training steps
1e-4 relative against JAX ``make_train_step`` on a one-device mesh, and
the bias leaves after them within 1e-4 of their largest; both serving
engines token-identical to JAX ``serve`` and ``serve_paged`` on the same
biased weights; the bridge and checkpoints bit for bit both ways in bf16.
A zero-bias forward lies more than 1e-2 of the largest logit from the
biased one, so the biases are seen.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.launch.serve as jax_serve_mod
from repro.checkpointing import restore_train_state as jax_restore
from repro.checkpointing import save_train_state as jax_save
from repro.configs import get_config as jax_get_config
from repro.configs import list_archs as jax_list_archs
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import batch_specs as jax_batch_specs
from repro.data.pipeline import synthetic_lm_batches as jax_batches
from repro.launch.mesh import make_local_mesh as jax_make_local_mesh
from repro.launch.serve import Request as JaxRequest
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
from repro_torch.configs import get_config, list_archs
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import train as train_cli
from repro_torch.models import LM, init_lm, lm_forward, lm_loss
from repro_torch.optim import AdamWConfig, adamw_init, adamw_update
from repro_torch.runtime.executor import make_prefill_step, make_train_step
from repro_torch.serving import EngineConfig, ServeRequest, ServingEngine

torch.set_num_threads(1)

ARCHS = ["qwen3-8b", "qwen2.5-14b", "qwen2-72b"]
BIASED = ["qwen2.5-14b", "qwen2-72b"]
# the reduced test configs: (d_model, n_heads, n_kv_heads), dh 32
SHAPES = {"qwen3-8b": (256, 8, 2), "qwen2.5-14b": (320, 10, 2),
          "qwen2-72b": (256, 8, 1)}
# the full configs: (L, d, H, KV, dh, d_ff, vocab, qkv_bias, qk_norm),
# and their parameter counts
FULL = {"qwen3-8b": ((36, 4096, 32, 8, 128, 12288, 151936, False, True),
                     8_190_735_360),
        "qwen2.5-14b": ((48, 5120, 40, 8, 128, 13824, 152064, True, False),
                        14_770_033_664),
        "qwen2-72b": ((80, 8192, 64, 8, 128, 29568, 152064, True, False),
                      72_706_203_648)}
BIAS_STD = 0.5
SEQ, BATCH = 24, 2


def _cfgs(arch, dtype="float32"):
    """(JAX, port) reduced configs of ``arch`` that keep its GQA group."""
    d, h, kv = SHAPES[arch]
    return tuple(c(arch).reduced(n_layers=2, d_model=d).with_(
        n_heads=h, n_kv_heads=kv, head_dim=32, dtype=getattr(m, dtype))
        for c, m in ((jax_get_config, jnp), (get_config, torch)))


def _with_biases(tree, seed):
    """The JAX tree with ``bq``, ``bk`` and ``bv`` drawn from a seeded
    normal of std ``BIAS_STD`` (numpy leaves, the leaves' dtype); a tree
    without biases is returned as it is."""
    attn = tree["stacks"][0]["attn"]
    if "bq" not in attn:
        return tree
    rng = np.random.default_rng(seed)
    attn = dict(attn, **{k: np.asarray(
        BIAS_STD * rng.standard_normal(attn[k].shape),
        np.float32).astype(attn[k].dtype) for k in ("bq", "bk", "bv")})
    return dict(tree, stacks=[dict(tree["stacks"][0], attn=attn),
                              *tree["stacks"][1:]])


def _jax_tree(arch, seed=0, dtype="float32"):
    cfg_j, _ = _cfgs(arch, dtype)
    return _with_biases(jax.tree.map(np.asarray, jax.jit(
        lambda k: jax_init_lm(k, cfg_j))(jax.random.PRNGKey(seed))), seed)


def _bridged(arch, seed=0, dtype="float32"):
    """(JAX config, port config, JAX params, port model) with the same
    seeded biases."""
    cfg_j, cfg_t = _cfgs(arch, dtype)
    tree = _jax_tree(arch, seed, dtype)
    return (cfg_j, cfg_t, jax.tree.map(jnp.asarray, tree),
            params_from_jax(tree, cfg_t, device="cpu"))


def _dcfg(cfg, seed=1234):
    return JaxDataConfig(seq_len=SEQ, global_batch=BATCH,
                         vocab_size=cfg.vocab_size, seed=seed)


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: max|diff| / max|ref| = {err:.3e} > {tol}"


def _bias_names(model):
    return [n for n, _ in model.named_parameters()
            if n.rsplit(".", 1)[-1] in ("bq", "bk", "bv")]


# ---------------------------------------------------------------------------
# the configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_the_config_equals_the_reference_config(arch):
    """Every field of the port's config equals the JAX package's, the
    dtype apart (bf16 in both)."""
    got, want = get_config(arch), jax_get_config(arch)
    assert got.name == arch and got.arch_type == "dense"
    fields = set(got.__dataclass_fields__) - {"dtype"}
    assert fields == set(want.__dataclass_fields__) - {"dtype"}
    assert {f: getattr(got, f) for f in fields} == \
        {f: getattr(want, f) for f in fields}
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    assert (got.n_layers, got.d_model, got.n_heads, got.n_kv_heads, got.dh,
            got.d_ff, got.vocab_size, got.qkv_bias, got.qk_norm) == \
        FULL[arch][0]
    assert not got.tie_embeddings


def test_list_archs_equals_the_reference():
    assert list_archs() == jax_list_archs()
    assert set(ARCHS) <= set(list_archs())


@pytest.mark.parametrize("arch", ARCHS)
def test_full_parameter_count_equals_the_reference(arch):
    """The port's model on the ``meta`` device has the JAX tree's leaves'
    sizes, the biases' (L x (q_dim + 2 kv_dim)) included."""
    full = init_lm(get_config(arch), device="meta")
    n = sum(p.numel() for p in full.parameters())
    aj = jax.eval_shape(lambda k: jax_init_lm(k, jax_get_config(arch)),
                        jax.random.PRNGKey(0))
    assert n == sum(int(np.prod(x.shape)) for x in jax.tree.leaves(aj))
    assert n == FULL[arch][1]
    cfg = get_config(arch)
    biases = sum(p.numel() for name, p in full.named_parameters()
                 if name in _bias_names(full))
    assert biases == (cfg.n_layers * (cfg.q_dim + 2 * cfg.kv_dim)
                      if cfg.qkv_bias else 0)


# ---------------------------------------------------------------------------
# the forward, the loss and its gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", BIASED)
def test_the_biases_are_seen(arch):
    """The same weights with the biases zeroed give logits more than 1e-2
    of the largest from the biased ones: a test that passes with the add
    left out would be no test."""
    _, cfg_t, _, params_t = _bridged(arch)
    assert cfg_t.n_heads // cfg_t.n_kv_heads == SHAPES[arch][1] // \
        SHAPES[arch][2]
    assert min(float(params_t.get_parameter(n).detach().abs().max())
               for n in _bias_names(params_t)) > 0.5
    tokens = torch.from_numpy(next(jax_batches(_dcfg(cfg_t)))["tokens"])
    with torch.no_grad():
        biased, _ = lm_forward(params_t, tokens, cfg_t)
        for name in _bias_names(params_t):
            params_t.get_parameter(name).zero_()
        plain, _ = lm_forward(params_t, tokens, cfg_t)
    diff = float((biased - plain).abs().max() / biased.abs().max())
    assert diff > 1e-2, diff


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_forward_matches_jax(arch):
    cfg_j, cfg_t, params_j, params_t = _bridged(arch)
    b = next(jax_batches(_dcfg(cfg_t, seed=5)))
    want, _ = jax_lm_forward(params_j, jnp.asarray(b["tokens"]), cfg_j)
    got, aux = lm_forward(params_t, torch.from_numpy(b["tokens"]), cfg_t)
    assert got.shape == (BATCH, SEQ, cfg_t.vocab_size) and float(aux) == 0
    _close(got.detach(), want, 1e-5, "logits")


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_every_gradient_match_jax(arch, remat):
    cfg_j, cfg_t, params_j, params_t = _bridged(arch, seed=1)
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
    assert len(_bias_names(want)) == (6 if arch in BIASED else 0)
    for (name, w), g in zip(named, grads_t):
        assert float(g.abs().max()) > 0, name
        _close(g.numpy(), w.detach().numpy(), 1e-4, name)


@pytest.mark.parametrize("remat", [False, True], ids=["plain", "remat"])
def test_three_train_steps_follow_jax_make_train_step(remat):
    """qwen2.5-14b at G = 5: the port's ``make_train_step`` against JAX
    ``make_train_step`` on a one-device mesh, from JAX
    ``init_train_state``'s weights with the seeded biases written in (and
    AdamW's state drawn again from them) bridged into the port.  AdamW
    decays and updates the biases as every leaf: they change each step
    and end within 1e-4 of JAX's."""
    arch = "qwen2.5-14b"
    cfg_j, cfg_t = _cfgs(arch)
    policy = JaxShardPolicy(tp=False, zero=False, remat_segments=(remat,))
    dcfg = _dcfg(cfg_t)
    ocfg_j, ocfg_t = JaxAdamWConfig(lr=1e-3), AdamWConfig(lr=1e-3)
    mesh = jax_make_local_mesh()
    with mesh:
        built = jax_executor.make_train_step(cfg_j, mesh, policy,
                                             jax_batch_specs(dcfg), ocfg_j)
        params_j, _ = jax_executor.init_train_state(cfg_j, mesh, policy)
        tree = _with_biases(jax.tree.map(np.asarray, params_j), 3)
        params_j = jax.tree.map(jnp.asarray, tree)
        # the step donates its arguments: AdamW's master on buffers apart
        opt_j = jax_adamw_init(jax.tree.map(jnp.array, tree))
    params_t = params_from_jax(tree, cfg_t, device="cpu")
    opt_t = adamw_init(list(params_t.parameters()), ocfg_t)
    step = make_train_step(cfg_t, ocfg_t, remat_segments=[remat])
    names = _bias_names(params_t)
    gen = jax_batches(dcfg)
    losses = []
    for _ in range(3):
        b = next(gen)
        before = {n: params_t.get_parameter(n).detach().clone()
                  for n in names}
        with mesh:
            params_j, opt_j, m_j = built.fn(
                params_j, opt_j, {k: jnp.asarray(v) for k, v in b.items()})
        m_t = step(params_t, opt_t, _torch(b))
        assert float(m_t["loss"]) == pytest.approx(float(m_j["loss"]),
                                                   rel=1e-4)
        assert float(m_t["grad_norm"]) == pytest.approx(
            float(m_j["grad_norm"]), rel=1e-4)
        losses.append(float(m_t["loss"]))
        for n in names:                     # every bias moves every step
            assert not torch.equal(params_t.get_parameter(n).detach(),
                                   before[n]), n
    assert losses[-1] < losses[0]
    want = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                           device="cpu")
    for n in names:
        _close(params_t.get_parameter(n).detach(),
               want.get_parameter(n).detach(), 1e-4, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_make_prefill_step_matches_jax(arch):
    """The port's prefill step against JAX ``make_prefill_step`` on a
    one-device mesh."""
    cfg_j, cfg_t, params_j, params_t = _bridged(arch, seed=2)
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
    _close(got, want, 1e-5, "prefill")


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

def _requests(cfg, n, seed):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, cfg.vocab_size, int(rng.integers(3, 13))
                          ).tolist(), int(rng.integers(3, 7)))
            for _ in range(n)]


def _biased_jax_init(monkeypatch, tree):
    """JAX ``serve`` and ``serve_paged`` draw their weights with
    ``init_lm``; hand them ``tree`` (the biased weights) instead."""
    monkeypatch.setattr(jax_serve_mod, "init_lm", lambda key, cfg: jax.tree.map(
        jnp.asarray, tree))


@pytest.mark.parametrize("arch", ARCHS)
def test_dense_serve_token_identical_to_jax(arch, monkeypatch):
    """The dense-cache engine with slot recycling: 5 requests on 2 lanes
    of a 24-token cache, on the biased weights in both packages."""
    cfg_j, cfg_t = _cfgs(arch)
    tree = _jax_tree(arch, seed=4)
    _biased_jax_init(monkeypatch, tree)
    spec = _requests(cfg_t, 5, 5)
    reqs_j = [JaxRequest(i, list(p), n) for i, (p, n) in enumerate(spec)]
    reqs_t = [serve_cli.Request(i, list(p), n)
              for i, (p, n) in enumerate(spec)]
    jax_serve_mod.serve(cfg_j, reqs_j, batch=2, context=24, seed=0,
                        verbose=False)
    serve_cli.serve(cfg_t, reqs_t, batch=2, context=24, verbose=False,
                    device="cpu",
                    params=params_from_jax(tree, cfg_t, device="cpu"))
    for rj, rt in zip(reqs_j, reqs_t):
        assert rt.generated == rj.generated, f"request {rj.rid}"
        assert rt.done and len(rt.generated) == rt.max_new


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_serve_token_identical_to_jax(arch, monkeypatch):
    """The paged engine (chunked prefill, continuous batching) against JAX
    ``serve_paged`` on the biased weights."""
    cfg_j, cfg_t = _cfgs(arch)
    tree = _jax_tree(arch, seed=6)
    _biased_jax_init(monkeypatch, tree)
    geo = dict(page_size=4, n_pages=24, decode_slots=3, max_context=24,
               prefill_batch=2, prefill_chunk=4)
    spec = _requests(cfg_t, 6, 6)
    reqs_j = [JaxRequest(i, list(p), n) for i, (p, n) in enumerate(spec)]
    jax_serve_mod.serve_paged(cfg_j, reqs_j, JaxEngineConfig(**geo), seed=0,
                              verbose=False)
    reqs_t = [ServeRequest(rid=str(i), prompt=list(p), max_new=n)
              for i, (p, n) in enumerate(spec)]
    ServingEngine(cfg_t, params_from_jax(tree, cfg_t, device="cpu"),
                  EngineConfig(**geo), device="cpu").run(reqs_t)
    for rj, rt in zip(reqs_j, reqs_t):
        assert rt.tokens == rj.generated, f"request {rj.rid}"
        assert rt.done


@pytest.mark.parametrize("engine", ["paged", "dense"])
@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_serves_on_cpu(arch, engine, capsys):
    reqs = serve_cli.main(["--arch", arch, "--engine", engine, "--device",
                           "cpu", "--requests", "3", "--batch", "2",
                           "--max-new", "4"])
    assert all(r.done and len(r.generated) == 4 for r in reqs)
    assert "served 3 requests, 12 tokens" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ARCHS)
def test_train_cli_trains_on_cpu(arch, capsys):
    hist = train_cli.main(["--arch", arch, "--reduced", "--device", "cpu",
                           "--steps", "3", "--batch", str(BATCH), "--seq",
                           str(SEQ), "--log-every", "1"])
    out = capsys.readouterr().out
    assert len(hist) == 3 and all(np.isfinite(h["loss"]) for h in hist)
    assert hist[-1]["loss"] < hist[0]["loss"]
    assert f"model: {arch}" in out and out.strip().endswith("done.")


# ---------------------------------------------------------------------------
# the bridge and checkpoints
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_round_trips_bit_for_bit(arch):
    """bf16 JAX ``init_lm`` with the seeded biases -> the port -> the JAX
    tree: every leaf, ``stacks/0/attn/bq`` (L, q_dim) included, the same
    bits."""
    cfg_j, cfg_t = _cfgs(arch, "bfloat16")
    tree = _jax_tree(arch, seed=4, dtype="bfloat16")
    model = params_from_jax(tree, cfg_t, device="cpu")
    assert isinstance(model, LM)
    back = tree_from_params(model)
    flat_j = dict(jax.tree_util.tree_flatten_with_path(tree)[0])
    flat_t = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_j.keys() == flat_t.keys()
    for k, a in flat_j.items():
        assert a.dtype == flat_t[k].dtype and np.array_equal(
            a.view(np.uint8), flat_t[k].view(np.uint8)), k
    if arch in BIASED:
        bq = back["stacks"][0]["attn"]["bq"]
        assert bq.shape == (2, cfg_t.q_dim) and np.abs(
            bq.astype(np.float32)).max() > 0.5
        assert model.blocks[1].attn.bk.shape == (cfg_t.kv_dim,)


def _bf16_state(arch, seed):
    """Reduced bf16 ``arch`` with the seeded biases: JAX params and an
    AdamW state after one update with random gradients."""
    cfg_j, cfg_t = _cfgs(arch, "bfloat16")
    params = jax.tree.map(jnp.asarray, _jax_tree(arch, seed, "bfloat16"))
    ocfg = JaxAdamWConfig(lr=1e-2)
    opt = jax_adamw_init(params, ocfg)
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(lambda p: jnp.asarray(
        rng.standard_normal(p.shape).astype(np.float32), p.dtype), params)
    params, opt, _ = jax.jit(jax_adamw_update, static_argnums=3)(
        params, grads, opt, ocfg)
    return cfg_j, cfg_t, params, opt


@pytest.mark.parametrize("arch", BIASED)
def test_jax_checkpoint_restores_into_the_port(arch, tmp_path):
    cfg_j, cfg_t, params, opt = _bf16_state(arch, 0)
    jax_save(1, params, opt, tmp_path, extra={"arch": arch})
    with np.load(tmp_path / "step_00000001" / "params.npz") as f:
        assert f["stacks/0/attn/bq@bf16"].shape == (2, cfg_t.q_dim)
    model = params_from_jax(_jax_tree(arch, 5, "bfloat16"), cfg_t,
                            device="cpu")
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


@pytest.mark.parametrize("arch", BIASED)
def test_port_checkpoint_restores_through_jax(arch, tmp_path):
    cfg_j, cfg_t = _cfgs(arch, "bfloat16")
    model = params_from_jax(_jax_tree(arch, 2, "bfloat16"), cfg_t,
                            device="cpu")
    state = adamw_init(list(model.parameters()))
    leaves = list(model.parameters())
    rng = np.random.default_rng(1)
    grads = [torch.from_numpy(rng.standard_normal(tuple(p.shape))
                              .astype(np.float32)).to(p.dtype)
             for p in leaves]
    adamw_update(leaves, grads, state, AdamWConfig(lr=1e-2))
    save_train_state(1, model, state, tmp_path)
    with np.load(tmp_path / "step_00000001" / "opt_state.npz") as f:
        assert f["m/stacks/0/attn/bv"].shape == (2, cfg_t.kv_dim)
    tmpl = jax.tree.map(jnp.asarray, _jax_tree(arch, 7, "bfloat16"))
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
