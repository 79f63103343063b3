"""The port's mixture-of-experts layer and MoE decoders against the JAX
package's, in fp32 on the CPU.

* ``_capacity`` equal to JAX's over a (T, k, E, cf) grid.
* ``moe_ffn`` for each dispatch (sort, einsum, grouped, and shmap, which
  runs the grouped path without a mesh in both packages) against JAX
  ``moe_ffn`` with the same dispatch on the same weights: output within
  1e-5 of its largest magnitude, aux within 1e-5 relative, the same
  top-k experts, and the (group, token, expert) pairs the port's dispatch
  buffer holds equal to those the reference's rule keeps on JAX's routing
  (rank of each (token, choice) within its expert in (token, choice)
  order, kept below the capacity).  top-k 1, 2 and 8, capacity factors
  1.25 and 0.5 (drops), the shared expert and the dense residual branch;
  and a crafted tie, where ``jax.lax.top_k`` takes the lower index.
* Reduced arctic-480b and kimi-k2-1t-a32b (16 experts: top-8, a shared
  expert, one dense layer first), bridged from JAX ``init_lm``:
  ``lm_forward`` logits and aux, ``lm_loss`` (1e-5 relative) and every
  gradient leaf (1e-4 of its largest magnitude) against
  ``jax.value_and_grad``; remat gives the same loss and gradients
  (training and serving: ``test_torch_moe_serving.py``).
* The bridge's round trip for kimi-k2's two segments and checkpoints
  interchangeable with the JAX package's both ways.
* What the sharded executor and the pipeline still refuse of a MoE
  model (EP and TP themselves: ``test_torch_moe_{ep,tp,sharded}.py``).
"""
import math
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpointing import restore_train_state as jax_restore
from repro.checkpointing import save_train_state as jax_save
from repro.configs import get_config as jax_get_config
from repro.models import moe as jax_moe
from repro.models.common import ModelConfig as JaxModelConfig
from repro.models.transformer import init_lm as jax_init_lm
from repro.models.transformer import lm_forward as jax_lm_forward
from repro.models.transformer import lm_loss as jax_lm_loss
from repro.models.transformer import \
    supports_paged_decode as jax_supports_paged_decode
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.bridge import (flat_from_leaves, params_from_jax,
                                tensor_from_numpy, tree_from_params)
from repro_torch.checkpointing import restore_train_state, save_train_state
from repro_torch.configs import get_config
from repro_torch.data import DataConfig, synthetic_lm_batches
from repro_torch.launch import serve as serve_mod
from repro_torch.launch import train as train_mod
from repro_torch.models import (build_stacks, init_lm, lm_forward, lm_loss,
                                supports_paged_decode)
from repro_torch.models import moe as moe_mod
from repro_torch.models.common import ModelConfig
from repro_torch.models.mlp import SwiGLU
from repro_torch.models.moe import MoE, moe_ffn
from repro_torch.optim import AdamWConfig, adamw_init
from repro_torch.runtime.executor import (init_serving_params,
                                          make_serve_step, make_train_step)
from repro_torch.runtime.pipeline import init_stage, stage_split_params
from repro_torch.runtime.sharding import ShardContext, ShardPolicy

torch.set_num_threads(1)

# the two archs at reduced size: arctic's default (4 experts, top-2, the
# dense residual branch) and kimi-k2 with 16 experts (top-8, a shared
# expert, its first layer dense)
ARCHS = {"arctic-480b": {}, "kimi-k2-1t-a32b": {"n_experts": 16}}


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    err = np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)
    assert err <= tol, f"{what}: max|diff| / max|ref| = {err:.3e} > {tol}"


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

def _layer_cfgs(E=4, k=2, cf=1.25, **kw):
    fields = dict(name="t", arch_type="moe", n_layers=1, d_model=16,
                  n_heads=4, n_kv_heads=4, d_ff=32, vocab_size=64,
                  n_experts=E, top_k=k, capacity_factor=cf, **kw)
    return (JaxModelConfig(**fields, dtype=jnp.float32),
            ModelConfig(**fields, dtype=torch.float32))


def _port_moe(p) -> MoE:
    """The port's layer on the JAX layer's weights (numpy leaves)."""
    t = lambda a: tensor_from_numpy(np.asarray(a), "cpu")  # noqa: E731
    opt = {k: SwiGLU(*(t(p[k][n]) for n in ("w_gate", "w_up", "w_down")))
           for k in ("shared", "dense_residual") if k in p}
    return MoE(t(p["router"]), t(p["w_gate"]), t(p["w_up"]),
               t(p["w_down"]), **opt)


def _jax_moe_ffn(cfg_j, dispatch):
    return jax.jit(lambda p, x: jax_moe.moe_ffn(p, x, cfg_j,
                                                dispatch=dispatch))


def _rule_pairs(topi, C):
    """The (group, token, expert) pairs the reference keeps: each (token,
    choice) ranked within its expert in (token, choice) order, kept while
    its rank is below the capacity C."""
    kept = set()
    for g in range(topi.shape[0]):
        seen = {}
        for t in range(topi.shape[1]):
            for e in topi[g, t]:
                e = int(e)
                if seen.get(e, 0) < C:
                    kept.add((g, t, e))
                seen[e] = seen.get(e, 0) + 1
    return kept


def _buffer_pairs(h, x, E):
    """The (group, token, expert) pairs held by the experts' input buffer
    h (E, G·C, d), each slot matched to the token row it copies."""
    G, T, d = x.shape
    C = h.shape[1] // G
    h = h.reshape(E, G, C, d)
    kept = set()
    for e in range(E):
        for g in range(G):
            for c in range(C):
                row = h[e, g, c]
                if not bool(row.any()):
                    continue
                (t,) = torch.nonzero((x[g] == row).all(-1))[:, 0].tolist()
                kept.add((g, t, e))
    return kept


@pytest.mark.parametrize("T", [1, 3, 24, 128, 256])
@pytest.mark.parametrize("k,E", [(1, 4), (2, 4), (2, 128), (8, 16),
                                 (8, 384)])
@pytest.mark.parametrize("cf", [0.5, 1.25, 2.0, 64.0])
def test_capacity_matches_jax(T, k, E, cf):
    cfg_j, cfg_t = _layer_cfgs(E=E, k=k, cf=cf)
    assert moe_mod._capacity(T, cfg_t) == jax_moe._capacity(T, cfg_j)


@pytest.mark.parametrize("dispatch", ["sort", "einsum", "grouped", "shmap"])
@pytest.mark.parametrize("E,k,cf,branches", [
    (4, 1, 1.25, {}),
    (4, 2, 1.25, {}),
    (4, 2, 0.5, {}),                               # capacity overflows
    (4, 2, 1.25, {"dense_residual_ff": 24}),       # arctic's branch
    (16, 8, 1.25, {"shared_expert_ff": 16}),       # kimi's top-8, shared
    (16, 8, 0.5, {"shared_expert_ff": 16}),
], ids=["k1", "k2", "k2-drops", "k2-residual", "k8-shared",
        "k8-shared-drops"])
def test_moe_ffn_matches_jax(dispatch, E, k, cf, branches, monkeypatch):
    cfg_j, cfg_t = _layer_cfgs(E=E, k=k, cf=cf, **branches)
    p_j = jax_moe.init_moe(jax.random.PRNGKey(0), cfg_j, jnp.float32)
    p_t = _port_moe(jax.tree.map(np.asarray, p_j))
    x = np.random.default_rng(1).standard_normal((2, 24, 16)).astype(
        np.float32)
    out_j, aux_j = _jax_moe_ffn(cfg_j, dispatch)(p_j, jnp.asarray(x))
    bufs = []
    real = moe_mod._experts
    monkeypatch.setattr(moe_mod, "_experts", lambda p, h: (
        bufs.append(h.detach().clone()), real(p, h))[1])
    xt = torch.from_numpy(x)
    with torch.no_grad():
        out_t, aux_t = moe_ffn(p_t, xt, cfg_t, dispatch=dispatch)
    _close(out_t, out_j, 1e-5, f"{dispatch} output")
    assert float(aux_t) == pytest.approx(float(aux_j), rel=1e-5)
    topi_j = np.asarray(jax.jit(jax.vmap(
        lambda g: jax_moe._route(p_j, g, cfg_j)[1]))(jnp.asarray(x)))
    with torch.no_grad():
        topi_t = moe_mod._route(p_t, xt, cfg_t)[1]
    np.testing.assert_array_equal(topi_t.numpy(), topi_j)
    C = jax_moe._capacity(24, cfg_j)
    want = _rule_pairs(topi_j, C)
    (buf,) = bufs
    assert _buffer_pairs(buf, xt, E) == want
    n_pairs = x.shape[0] * x.shape[1] * k
    assert cf >= 1 or len(want) < n_pairs, "the case drops no pair"


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("dispatch", ["sort", "einsum", "grouped"])
def test_a_routing_tie_goes_to_the_lower_expert(k, dispatch):
    """Experts 1 and 2 get the same logit for every token (their router
    columns are equal and the largest): ``jax.lax.top_k`` takes expert 1
    first, and so must the port."""
    cfg_j, cfg_t = _layer_cfgs(E=4, k=k)
    p = jax.tree.map(np.asarray, jax_moe.init_moe(jax.random.PRNGKey(0),
                                                  cfg_j, jnp.float32))
    router = np.zeros((16, 4), np.float32)
    router[:, 1] = router[:, 2] = 0.25
    p["router"] = router
    x = np.abs(np.random.default_rng(2).standard_normal(
        (2, 6, 16))).astype(np.float32)
    p_t = _port_moe(p)
    with torch.no_grad():
        probs = torch.softmax(torch.from_numpy(x) @ p_t.router, -1)
        topi_t = moe_mod._route(p_t, torch.from_numpy(x), cfg_t)[1]
        out_t, aux_t = moe_ffn(p_t, torch.from_numpy(x), cfg_t,
                               dispatch=dispatch)
    assert torch.equal(probs[..., 1], probs[..., 2]), "no tie to break"
    topi_j = np.asarray(jax_moe._route(p, jnp.asarray(x[0]), cfg_j)[1])
    assert (topi_j == [1, 2][:k]).all()
    assert (topi_t.numpy() == [1, 2][:k]).all()
    out_j, aux_j = _jax_moe_ffn(cfg_j, dispatch)(p, jnp.asarray(x))
    _close(out_t, out_j, 1e-5, dispatch)
    assert float(aux_t) == pytest.approx(float(aux_j), rel=1e-5)


def test_moe_dispatch_of_the_config_overrides_sort():
    """``cfg.moe_dispatch`` "grouped" turns the default sort into the
    grouped path (its aux is joint over the batch, not a mean of rows)."""
    cfg_j, cfg_t = _layer_cfgs(E=4, k=2)
    p_j = jax_moe.init_moe(jax.random.PRNGKey(3), cfg_j, jnp.float32)
    p_t = _port_moe(jax.tree.map(np.asarray, p_j))
    x = np.random.default_rng(3).standard_normal((3, 8, 16)).astype(
        np.float32)
    with torch.no_grad():
        grouped = moe_ffn(p_t, torch.from_numpy(x),
                          cfg_t.with_(moe_dispatch="grouped"))
        want = moe_ffn(p_t, torch.from_numpy(x), cfg_t, dispatch="grouped")
    assert torch.equal(grouped[0], want[0])
    assert torch.equal(grouped[1], want[1])
    _, aux_j = _jax_moe_ffn(cfg_j.with_(moe_dispatch="grouped"),
                            "sort")(p_j, jnp.asarray(x))
    assert float(grouped[1]) == pytest.approx(float(aux_j), rel=1e-5)


# ---------------------------------------------------------------------------
# the MoE decoders
# ---------------------------------------------------------------------------

def _configs(arch):
    kw = ARCHS[arch]
    return (jax_get_config(arch).reduced(**kw).with_(dtype=jnp.float32),
            get_config(arch).reduced(**kw).with_(dtype=torch.float32))


def _bridged(arch, seed=0):
    cfg_j, cfg_t = _configs(arch)
    params_j = jax.jit(lambda k: jax_init_lm(k, cfg_j))(
        jax.random.PRNGKey(seed))
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def _flat(tree, prefix=""):
    """{``stacks/1/moe/router``: numpy leaf} of a JAX tree."""
    if isinstance(tree, dict):
        return {k2: v2 for k, v in tree.items()
                for k2, v2 in _flat(v, f"{prefix}{k}/").items()}
    if isinstance(tree, (list, tuple)):
        return {k2: v2 for i, v in enumerate(tree)
                for k2, v2 in _flat(v, f"{prefix}{i}/").items()}
    return {prefix[:-1]: np.asarray(tree)}


def _batch(cfg, seq=24, batch=2, seed=7):
    return next(synthetic_lm_batches(DataConfig(
        seq_len=seq, global_batch=batch, vocab_size=cfg.vocab_size,
        seed=seed)))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_layout_of_the_moe_archs(arch):
    """The reference's segments: kimi-k2's dense first layer, then MoE."""
    cfg_j, cfg_t = _configs(arch)
    from repro.models.transformer import build_stacks as jax_build_stacks
    assert build_stacks(cfg_t) == [tuple(s) for s in jax_build_stacks(cfg_j)]
    assert supports_paged_decode(cfg_t) == jax_supports_paged_decode(cfg_j)
    want = {"arctic-480b": (4, 2, 0, 0, 256), "kimi-k2-1t-a32b": (
        16, 8, 1, 256, 0)}[arch]
    assert (cfg_t.n_experts, cfg_t.top_k, cfg_t.first_k_dense,
            cfg_t.shared_expert_ff, cfg_t.dense_residual_ff) == want
    model = init_lm(cfg_t, device="cpu")
    kinds = [type(b).__name__ for b in model.blocks]
    assert kinds == ["DenseBlock"] * cfg_t.first_k_dense + ["MoEBlock"] * (
        cfg_t.n_layers - cfg_t.first_k_dense)


@pytest.mark.parametrize("arch", list(ARCHS))
def test_lm_forward_loss_and_every_gradient_match_jax(arch):
    cfg_j, cfg_t, params_j, params_t = _bridged(arch, seed=1)
    b = _batch(cfg_t)
    batch_j = {k: jnp.asarray(v) for k, v in b.items()}
    batch_t = {k: torch.from_numpy(v) for k, v in b.items()}
    logits_j, aux_j = jax.jit(lambda p, t: jax_lm_forward(p, t, cfg_j))(
        params_j, batch_j["tokens"])
    with torch.no_grad():
        logits_t, aux_t = lm_forward(params_t, batch_t["tokens"], cfg_t)
    _close(logits_t, logits_j, 1e-5, "logits")
    assert float(aux_t) > 0
    assert float(aux_t) == pytest.approx(float(aux_j), rel=1e-5)
    loss_j, grads_j = jax.jit(jax.value_and_grad(
        lambda p: jax_lm_loss(p, batch_j, cfg_j)))(params_j)
    loss_t = lm_loss(params_t, batch_t, cfg_t)
    leaves = list(params_t.parameters())
    grads_t = flat_from_leaves(params_t, torch.autograd.grad(loss_t, leaves))
    assert float(loss_t.detach()) == pytest.approx(float(loss_j), rel=1e-5)
    grads_j = _flat(jax.tree.map(np.asarray, grads_j))
    assert set(grads_t) == set(grads_j)
    assert any("/moe/w_gate" in k for k in grads_t)
    for name, g in grads_t.items():
        _close(g.numpy(), grads_j[name], 1e-4, name)


def test_remat_sums_the_aux_loss_the_same_way():
    cfg_t = _configs("kimi-k2-1t-a32b")[1]
    params_t = init_lm(cfg_t, seed=2, device="cpu")
    b = {k: torch.from_numpy(v) for k, v in _batch(cfg_t).items()}
    leaves = list(params_t.parameters())
    loss = lm_loss(params_t, b, cfg_t)
    grads = torch.autograd.grad(loss, leaves)
    loss_r = lm_loss(params_t, b, cfg_t, remat_segments=[True])
    grads_r = torch.autograd.grad(loss_r, leaves)
    assert torch.equal(loss, loss_r)
    for g, gr in zip(grads, grads_r):
        assert torch.equal(g, gr)


# ---------------------------------------------------------------------------
# bridge and checkpoints
# ---------------------------------------------------------------------------

def test_bridge_round_trips_kimi_bf16_bit_for_bit():
    """Two segments (the dense first layer in ``stacks[0]``, the MoE layer
    in ``stacks[1]``), every leaf, the shared expert included."""
    cfg_j = jax_get_config("kimi-k2-1t-a32b").reduced(n_experts=16)
    cfg_t = get_config("kimi-k2-1t-a32b").reduced(n_experts=16)
    tree = jax.tree.map(np.asarray, jax.jit(lambda k: jax_init_lm(
        k, cfg_j))(jax.random.PRNGKey(0)))
    back = tree_from_params(params_from_jax(tree, cfg_t, device="cpu"))
    want, got = _flat(tree), _flat(back)
    assert set(got) == set(want)
    assert "stacks/1/moe/shared/w_gate" in got and "stacks/0/mlp/w_up" in got
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert got[k].shape == v.shape, k
        np.testing.assert_array_equal(got[k].view(np.uint8),
                                      v.view(np.uint8), err_msg=k)


def test_checkpoints_interchange_with_jax_both_ways(tmp_path):
    cfg_j = jax_get_config("kimi-k2-1t-a32b").reduced(n_experts=16)
    cfg_t = get_config("kimi-k2-1t-a32b").reduced(n_experts=16)
    params_j = jax.jit(lambda k: jax_init_lm(k, cfg_j))(
        jax.random.PRNGKey(0))
    opt_j = jax_adamw_init(params_j, JaxAdamWConfig())
    jax_save(3, params_j, opt_j, tmp_path / "jax")
    params_t = init_lm(cfg_t, seed=5, device="cpu")
    opt_t = adamw_init(list(params_t.parameters()), AdamWConfig())
    _, _, step = restore_train_state(params_t, opt_t, tmp_path / "jax")
    assert step == 3
    got = _flat(tree_from_params(params_t))
    for k, v in _flat(jax.tree.map(np.asarray, params_j)).items():
        np.testing.assert_array_equal(got[k].view(np.uint8),
                                      v.view(np.uint8), err_msg=k)
    # and back: the port's save restored by the JAX package
    d = save_train_state(4, params_t, opt_t, tmp_path / "port")
    like = jax.tree.map(jnp.zeros_like, params_j)
    restored, _, step_j = jax_restore(
        like, jax_adamw_init(like, JaxAdamWConfig()), d.parent)
    assert step_j == 4
    for k, v in _flat(jax.tree.map(np.asarray, restored)).items():
        np.testing.assert_array_equal(got[k].view(np.uint8),
                                      v.view(np.uint8), err_msg=k)


# ---------------------------------------------------------------------------
# what the sharded executor and the pipeline still refuse
# ---------------------------------------------------------------------------

class _Reached(Exception):
    """Raised in place of spawning a CLI's ranks."""


@pytest.mark.parametrize("entry", [
    "ShardContext", "make_train_step", "make_serve_step",
    "init_serving_params", "train --ranks", "serve --ranks",
    "stage_split_params", "init_stage", "train --pipeline", "moe_ffn"])
def test_sharded_and_pipelined_moe_is_refused(entry, monkeypatch):
    """EP and TP for MoE are ported (``test_torch_moe_{ep,tp,sharded}.py``);
    what each entry still refuses of a MoE model, before any rank is
    spawned: the sharded entries a mesh that is neither ``("data",
    "model")`` nor ``("data", "expert")`` (ValueError); the CLIs refuse
    nothing and reach their ranks; the pipeline kimi-k2's two segments (its
    dense first layer, then MoE blocks: ValueError, as the reference
    asserts one homogeneous stack); ``moe_ffn`` the einsum dispatch on
    experts split over ranks (NotImplementedError)."""
    cfg = get_config("arctic-480b").reduced().with_(dtype=torch.float32)
    kimi = get_config("kimi-k2-1t-a32b").reduced(n_experts=16)
    ring = types.SimpleNamespace(mesh_dim_names=("data", "seq"))

    def reached(*args, **kwargs):
        raise _Reached

    monkeypatch.setattr(train_mod, "_spawn", reached)
    monkeypatch.setattr(serve_mod, "run_ranks", reached)
    moe = init_lm(cfg, device="cpu").blocks[0].moe
    rank_share = MoE(moe.router, moe.w_gate[:2], moe.w_up[:2],
                     moe.w_down[:2], dense_residual=moe.dense_residual)
    call, want = {
        "ShardContext": (lambda: ShardContext(cfg, ring, ShardPolicy()),
                         ValueError),
        "make_train_step": (lambda: make_train_step(cfg, mesh=ring),
                            ValueError),
        "make_serve_step": (lambda: make_serve_step(cfg, mesh=ring),
                            ValueError),
        "init_serving_params": (lambda: init_serving_params(
            cfg, mesh=ring, device="cpu"), ValueError),
        "train --ranks": (lambda: train_mod.main(
            ["--arch", "arctic-480b", "--reduced", "--device", "cpu",
             "--ranks", "2", "--steps", "1"]), _Reached),
        "serve --ranks": (lambda: serve_mod.main(
            ["--arch", "arctic-480b", "--device", "cpu", "--ranks", "2"]),
            _Reached),
        "stage_split_params": (lambda: stage_split_params(
            init_lm(kimi, device="cpu"), 2), ValueError),
        "init_stage": (lambda: init_stage(kimi, 2, 1, 0, device="cpu"),
                       ValueError),
        "train --pipeline": (lambda: train_mod.main(
            ["--arch", "kimi-k2-1t-a32b", "--reduced", "--device", "cpu",
             "--pipeline", "--ranks", "2", "--steps", "1"]), ValueError),
        "moe_ffn": (lambda: moe_ffn(rank_share, torch.zeros(1, 2,
                                                            cfg.d_model),
                                    cfg, dispatch="einsum", shard=object()),
                    NotImplementedError),
    }[entry]
    match = {ValueError: "'data', 'expert'|homogeneous stack",
             NotImplementedError: "einsum", _Reached: None}[want]
    with pytest.raises(want, match=match):
        call()


def test_init_draws_each_expert_apart_with_the_reference_distributions():
    """Each expert's weights N(0, 1/d_in), drawn one at a time; the router
    fp32 and the experts in the model dtype."""
    cfg = get_config("arctic-480b").reduced(n_experts=4)
    moe = init_lm(cfg, device="cpu").blocks[0].moe
    assert moe.router.dtype == torch.float32
    assert moe.w_gate.dtype == moe.w_down.dtype == torch.bfloat16
    assert moe.shared is None and moe.dense_residual is not None
    d, f = cfg.d_model, cfg.d_ff
    for w, fan_in in ((moe.w_gate, d), (moe.w_up, d), (moe.w_down, f)):
        std = w.float().std(dim=(1, 2))
        assert torch.allclose(std, torch.full_like(std, fan_in ** -0.5),
                              rtol=0.05)
        assert not torch.equal(w[0], w[1])
    meta = init_lm(get_config("kimi-k2-1t-a32b"), device="meta")
    assert meta.blocks[1].moe.w_gate.shape == (384, 7168, 2048)
    assert math.prod(meta.blocks[1].moe.w_down.shape) == 384 * 2048 * 7168
