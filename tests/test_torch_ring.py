"""Ring-attention sequence parallelism of the port against the JAX package.

The Pallas ring kernel cannot run in this JAX version (``pl.load``), so the
port is held against the oracles that the JAX package's own ring tests use:
``kernels/ref.py::flash_attention_ref`` on the gathered sequence,
``models/attention.py::sdpa_ref`` with ``q_offset`` for one panel visit,
``kernels/ring_attention.py::_merge`` (plain jnp) and
``models/attention.py::attention(impl="ref")``.

The ring itself runs over real ranks: one test starts 4 gloo processes with
``torch.multiprocessing`` (a ``file://`` rendezvous under the test's
temporary directory, one thread each, its own 120 s limit so that a hung
rendezvous fails) on a (1, 4), a (2, 2) and a (4, 1) mesh; the parent
gathers the local outputs and compares them with the JAX oracles.

Tolerances: fp32 1e-5, absolute and relative (the same arithmetic summed in
another order); rows that a panel rejects whole must be exactly
(acc, m, l) = (0, -1e30, 0), and a ring of one rank exactly flash.
"""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from repro.configs import get_config as jax_get_config
from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.kernels.ring_attention import _merge as jax_merge
from repro.models.attention import attention as jax_attention
from repro.models.attention import sdpa_ref as jax_sdpa_ref
from repro.models.transformer import init_lm as jax_init_lm
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.ref import (NEG_INF, finalize_partial,
                                     flash_partial_ref, merge_partials)
from repro_torch.launch.mesh import init_distributed, make_ring_mesh
from repro_torch.models.attention import attention
from repro_torch.runtime.sequence import (ring_attention_on_mesh,
                                          seq_axis_size, shard_sequence)

torch.set_num_threads(1)

TOL = 1e-5
WORLD = 4
RING_TIMEOUT_S = 120


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64),
                               atol=TOL, rtol=TOL)


def _qkv(rng, B, S, T, H, KV, dh):
    return (rng.standard_normal((B, S, H, dh), np.float32),
            rng.standard_normal((B, T, KV, dh), np.float32),
            rng.standard_normal((B, T, KV, dh), np.float32))


# ---------------------------------------------------------------------------
# one panel visit: flash_partial_ref
# ---------------------------------------------------------------------------

S_LOC, T_LOC = 40, 56


def _np_state(q, k, delta, causal, window):
    """Row max and sum exp(s - m) of the scaled, masked scores, in float64:
    (m, l) as (B,S,H,1) and the admissible mask (B,S,H,T)."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    kh = np.repeat(k.astype(np.float64), H // KV, axis=2)       # (B,T,H,dh)
    s = np.einsum("bshd,bthd->bsht", q.astype(np.float64), kh) / np.sqrt(dh)
    qpos = delta + np.arange(S)[:, None]
    kpos = np.arange(T)[None, :]
    mask = np.ones((S, T), bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    mask = np.broadcast_to(mask[None, :, None, :], s.shape)
    m = np.where(mask, s, -np.inf).max(-1, keepdims=True)
    l = np.where(mask, np.exp(s - np.where(np.isfinite(m), m, 0.0)),
                 0.0).sum(-1, keepdims=True)
    return np.where(np.isfinite(m), m, NEG_INF), l, mask


@pytest.mark.parametrize("H,KV,dh", [(8, 2, 64), (8, 4, 128)],
                         ids=["gqa4-dh64", "gqa2-dh128"])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 24), (False, 24)])
@pytest.mark.parametrize("delta", [0, T_LOC, -T_LOC, 37, -21])
def test_flash_partial_ref_matches_jax(H, KV, dh, causal, window, delta):
    rng = np.random.default_rng(abs(delta) + H * KV + dh)
    q, k, v = _qkv(rng, 2, S_LOC, T_LOC, H, KV, dh)
    acc, m, l = (t.numpy() for t in ops.flash_partial(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        delta, causal=causal, window=window))
    assert acc.shape == q.shape and m.shape == l.shape == q.shape[:3] + (1,)
    m_np, l_np, mask = _np_state(q, k, delta, causal, window)
    _close(m, m_np)
    _close(l, l_np)
    seen = l[..., 0] > 0
    assert (seen == mask.any(-1)).all()
    want = np.asarray(jax_sdpa_ref(jnp.asarray(q), jnp.asarray(k),
                                   jnp.asarray(v), causal=causal,
                                   window=window, q_offset=delta))
    _close((acc / np.where(l > 0, l, 1.0))[seen], want[seen])
    # rows the panel rejects whole: exactly the empty state
    assert (acc[~seen] == 0).all() and (l[~seen] == 0).all()
    assert (m[~seen] == np.float32(NEG_INF)).all()
    if causal and delta == -T_LOC:
        assert not seen.any()           # a causally dead panel


def test_flash_partial_under_grad_raises_naming_k5():
    """The panel visit has no backward: an input that needs gradients
    raises while grad is enabled, and under ``no_grad`` the visit runs."""
    rng = np.random.default_rng(6)
    q, k, v = map(torch.from_numpy, _qkv(rng, 1, S_LOC, T_LOC, 4, 2, 32))
    with pytest.raises(ValueError, match="K5"):
        ops.flash_partial(q.requires_grad_(), k, v, 0)
    with torch.no_grad():
        acc, m, l = ops.flash_partial(q, k, v, 0)
    want = ops.flash_partial(q.detach(), k, v, 0)
    for got, ref_ in zip((acc, m, l), want):
        assert torch.equal(got, ref_)


# ---------------------------------------------------------------------------
# merge and finalize
# ---------------------------------------------------------------------------

def _random_state(rng, shape, empty_rows):
    acc = rng.standard_normal(shape, np.float32)
    m = rng.standard_normal(shape[:-1] + (1,), np.float32) * 3
    l = rng.uniform(0.5, 20.0, shape[:-1] + (1,)).astype(np.float32)
    acc[empty_rows], m[empty_rows], l[empty_rows] = 0.0, NEG_INF, 0.0
    return acc, m, l


@pytest.mark.parametrize("empty", ["none", "a", "b", "both", "mixed"])
def test_merge_partials_matches_jax_merge(empty):
    rng = np.random.default_rng(7)
    shape = (2, 12, 4, 64)
    rows = np.zeros(shape[:3], bool)
    rows_a, rows_b = rows.copy(), rows.copy()
    if empty in ("a", "both"):
        rows_a[:] = True
    if empty in ("b", "both"):
        rows_b[:] = True
    if empty == "mixed":
        rows_a[:, ::2] = True
        rows_b[:, ::3] = True
    a = _random_state(rng, shape, rows_a)
    b = _random_state(rng, shape, rows_b)
    got = merge_partials(tuple(map(torch.from_numpy, a)),
                         tuple(map(torch.from_numpy, b)))
    want = jax_merge(tuple(map(jnp.asarray, a)), tuple(map(jnp.asarray, b)))
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _close(g.numpy(), np.asarray(w))
    both = rows_a & rows_b
    assert (got[0].numpy()[both] == 0).all()
    assert (got[1].numpy()[both] == np.float32(NEG_INF)).all()
    assert (got[2].numpy()[both] == 0).all()
    out = finalize_partial(got, torch.float32).numpy()
    acc, _, l = (np.asarray(w) for w in want)
    _close(out, np.where(l > 0, acc / np.where(l > 0, l, 1.0), 0.0))
    assert (out[both] == 0).all()


@pytest.mark.parametrize("P", [2, 3, 4])
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 20)])
def test_panel_visits_merged_equal_flash_on_gathered_sequence(P, causal,
                                                              window):
    """The ring's arithmetic without the transport: every q shard visits
    every panel in ring order, merging as the ranks do."""
    rng = np.random.default_rng(P)
    S_loc = 16
    q, k, v = _qkv(rng, 2, S_loc * P, S_loc * P, 4, 2, 64)
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    outs = []
    for rank in range(P):
        state = None
        for r in range(P):
            src = (rank - r) % P
            part = flash_partial_ref(
                tq[:, rank * S_loc:(rank + 1) * S_loc],
                tk[:, src * S_loc:(src + 1) * S_loc],
                tv[:, src * S_loc:(src + 1) * S_loc],
                rank * S_loc - src * S_loc, causal=causal, window=window)
            state = part if state is None else merge_partials(state, part)
        outs.append(finalize_partial(state, torch.float32))
    want = jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                         causal=causal, window=window)
    _close(torch.cat(outs, 1).numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# a ring of one rank
# ---------------------------------------------------------------------------

def test_ring_of_one_rank_is_flash():
    rng = np.random.default_rng(4)
    q, k, v = map(torch.from_numpy, _qkv(rng, 1, 128, 128, 2, 2, 32))
    out = ops.ring_flash_attention(q, k, v, group=None, causal=True)
    assert torch.equal(out, ops.flash_attention(q, k, v, causal=True))


def test_ring_validates_global_shapes():
    rng = np.random.default_rng(5)
    q, k, v = map(torch.from_numpy, _qkv(rng, 1, 32, 32, 4, 2, 32))
    with pytest.raises(ValueError, match="window"):
        ops.ring_flash_attention(q, k, v, window=0)
    with pytest.raises(ValueError, match="divisible"):
        ops.ring_flash_attention(q, k[:, :, :1].repeat(1, 1, 3, 1),
                                 v[:, :, :1].repeat(1, 1, 3, 1))
    with pytest.raises(ValueError, match="window"):
        ops.flash_partial(q, k, v, 0, window=-1)


# ---------------------------------------------------------------------------
# the full-sequence layer on one process
# ---------------------------------------------------------------------------

def _layer(seed=0):
    """Reduced qwen3-4b fp32: the JAX pytree (numpy leaves, QK-norm weights
    randomised so that they matter) and the configs of both packages."""
    cfg_j = jax_get_config("qwen3-4b").reduced().with_(dtype=jnp.float32)
    cfg_t = get_config("qwen3-4b").reduced().with_(dtype=torch.float32)
    tree = jax.tree.map(np.asarray, jax.jit(
        lambda key: jax_init_lm(key, cfg_j))(jax.random.PRNGKey(seed)))
    rng = np.random.default_rng(seed)
    attn = tree["stacks"][0]["attn"]
    for name in ("q_norm", "k_norm"):
        attn[name] = (1.0 + 0.3 * rng.standard_normal(attn[name].shape)
                      ).astype(np.float32)
    return tree, cfg_j, cfg_t


def _jax_layer(tree):
    return jax.tree.map(lambda a: jnp.asarray(a[0]), tree["stacks"][0]["attn"])


@pytest.mark.parametrize("impl,S,window", [
    ("ref", 64, None), ("chunked", 64, None), ("chunked", 1024, None),
    ("chunked", 1024, 100), ("flash", 64, None), ("flash", 64, 9),
    ("auto", 64, None), ("auto", 1024, None)])
def test_attention_layer_matches_jax(impl, S, window):
    tree, cfg_j, cfg_t = _layer()
    layer = params_from_jax(tree, cfg_t, device="cpu").blocks[0].attn
    x = np.random.default_rng(S).standard_normal((1, S, cfg_t.d_model),
                                                 np.float32)
    pos = np.arange(S, dtype=np.int32)[None]
    with torch.no_grad():
        got = attention(layer, torch.from_numpy(x), torch.from_numpy(pos),
                        cfg_t, window=window, impl=impl)
    # the JAX "flash" is the Pallas kernel: hold the port's against "ref"
    want = jax_attention(_jax_layer(tree), jnp.asarray(x), jnp.asarray(pos),
                         cfg_j, window=window,
                         impl="ref" if impl == "flash" else impl)
    _close(got.numpy(), np.asarray(want))


def test_attention_rejects_unknown_impl():
    tree, _, cfg_t = _layer()
    layer = params_from_jax(tree, cfg_t, device="cpu").blocks[0].attn
    x = torch.zeros(1, 8, cfg_t.d_model)
    with pytest.raises(ValueError, match="impl"):
        attention(layer, x, torch.arange(8)[None], cfg_t, impl="sdpa")


# ---------------------------------------------------------------------------
# the ring over 4 gloo ranks
# ---------------------------------------------------------------------------

# (name, mesh (n_data, n_seq), B, S, H, KV, dh, causal, window)
RING_CASES = [
    ("causal-1x4", (1, 4), 1, 64, 4, 2, 32, True, None),
    ("bidirectional-1x4", (1, 4), 1, 64, 4, 1, 64, False, None),
    ("window-1x4", (1, 4), 2, 96, 4, 2, 32, True, 30),
    ("causal-2x2", (2, 2), 2, 64, 2, 2, 32, True, None),
    ("window-2x2", (2, 2), 2, 64, 4, 2, 32, True, 5),
]
LAYER_S = 64


def _ring_worker(rank, world, init_file, out_dir, cases, tree):
    """One rank: runs every case on its shards and saves its outputs."""
    torch.set_num_threads(1)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{init_file}",
                     timeout_s=RING_TIMEOUT_S)
    try:
        meshes = {}
        for name, shape, _, _, _, _, _, causal, window, arrays in cases:
            if shape not in meshes:     # collective: same order everywhere
                meshes[shape] = make_ring_mesh(shape[1], n_data=shape[0],
                                               device_type="cpu")
            mesh = meshes[shape]
            assert seq_axis_size(mesh) == shape[1]
            q, k, v = (shard_sequence(torch.from_numpy(a), mesh)
                       for a in arrays)
            out = ring_attention_on_mesh(mesh, causal=causal,
                                         window=window)(q, k, v)
            np.save(f"{out_dir}/{name}-{rank}.npy", out.numpy())
        # a seq axis of size 1 is flash, exactly
        mesh = make_ring_mesh(1, n_data=world, device_type="cpu")
        q, k, v = (torch.from_numpy(a) for a in cases[0][-1])
        assert torch.equal(ring_attention_on_mesh(mesh)(q, k, v),
                           ops.flash_attention(q, k, v))
        # the layer with bridged weights, at the shard's absolute positions
        mesh = meshes[(1, world)]
        cfg_t = get_config("qwen3-4b").reduced().with_(dtype=torch.float32)
        layer = params_from_jax(tree, cfg_t, device="cpu").blocks[0].attn
        x = np.random.default_rng(11).standard_normal(
            (1, LAYER_S, cfg_t.d_model), np.float32)
        pos = torch.arange(LAYER_S, dtype=torch.int32)[None]
        with torch.no_grad():
            out = attention(layer, shard_sequence(torch.from_numpy(x), mesh),
                            shard_sequence(pos, mesh), cfg_t, impl="ring",
                            sp_group=mesh.get_group("seq"))
        np.save(f"{out_dir}/layer-{rank}.npy", out.numpy())
        try:
            shard_sequence(torch.zeros(1, 6), mesh)
        except ValueError:
            pass
        else:
            raise AssertionError("a sequence of 6 split over 4 ranks")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _gather(out_dir, name, shape):
    n_data, n_seq = shape
    rows = [np.concatenate([np.load(f"{out_dir}/{name}-{d * n_seq + s}.npy")
                            for s in range(n_seq)], axis=1)
            for d in range(n_data)]
    return np.concatenate(rows, axis=0)


def test_ring_over_four_gloo_ranks_matches_jax(tmp_path):
    rng = np.random.default_rng(0)
    cases = [(*case, _qkv(rng, *case[2:4], case[3], *case[4:7]))
             for case in RING_CASES]
    tree, cfg_j, _ = _layer(seed=1)
    ctx = mp.start_processes(
        _ring_worker, args=(WORLD, str(tmp_path / "rendezvous"),
                            str(tmp_path), cases, tree),
        nprocs=WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + RING_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "ring ranks timed out"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    for name, shape, _, _, _, _, _, causal, window, (q, k, v) in cases:
        want = jax_flash_ref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=window)
        _close(_gather(tmp_path, name, shape), np.asarray(want))
    x = np.random.default_rng(11).standard_normal(
        (1, LAYER_S, cfg_j.d_model), np.float32)
    pos = jnp.arange(LAYER_S, dtype=jnp.int32)[None]
    want = jax_attention(_jax_layer(tree), jnp.asarray(x), pos, cfg_j,
                         impl="ref")
    _close(_gather(tmp_path, "layer", (1, WORLD)), np.asarray(want))


# ---------------------------------------------------------------------------
# the ring under autograd, over 2 gloo ranks
# ---------------------------------------------------------------------------

GRAD_WORLD = 2
GRAD_TIMEOUT_S = 120


def _grad_worker(rank, world, init_file, out_dir, arrays, tree):
    """One rank of a ring of ``world``: under grad, inputs that need
    gradients make ``ring_flash_attention`` and ``attention(impl="ring")``
    raise a ValueError naming K5; under ``no_grad`` the same call runs.
    Saves the error messages and the ``no_grad`` output shard."""
    torch.set_num_threads(1)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{init_file}",
                     timeout_s=GRAD_TIMEOUT_S)
    try:
        mesh = make_ring_mesh(world, device_type="cpu")
        group = mesh.get_group("seq")
        q, k, v = (shard_sequence(torch.from_numpy(a), mesh) for a in arrays)
        cfg_t = get_config("qwen3-4b").reduced().with_(dtype=torch.float32)
        layer = params_from_jax(tree, cfg_t, device="cpu").blocks[0].attn
        x = shard_sequence(torch.from_numpy(np.random.default_rng(12)
                           .standard_normal((1, LAYER_S, cfg_t.d_model),
                                            np.float32)), mesh)
        pos = shard_sequence(torch.arange(LAYER_S, dtype=torch.int32)[None],
                             mesh)
        calls = {
            "ring": lambda q_: ops.ring_flash_attention(q_, k, v, group=group),
            "layer": lambda x_: attention(layer, x_, pos, cfg_t, impl="ring",
                                          sp_group=group)}
        errors = []
        for name, call in calls.items():
            leaf = (q if name == "ring" else x).clone().requires_grad_()
            try:
                call(leaf)
            except ValueError as e:
                errors.append(str(e))
            else:
                errors.append(f"{name}: no error")
        with open(f"{out_dir}/errors-{rank}.txt", "w") as f:
            f.write("\n".join(errors))
        with torch.no_grad():
            out = calls["ring"](q.clone().requires_grad_())
        np.save(f"{out_dir}/nograd-{rank}.npy", out.numpy())
        dist.barrier()
    finally:
        dist.destroy_process_group()


def test_ring_under_grad_raises_naming_k5_on_two_gloo_ranks(tmp_path):
    rng = np.random.default_rng(7)
    arrays = _qkv(rng, 1, 64, 64, 4, 2, 32)
    tree, _, _ = _layer(seed=2)
    ctx = mp.start_processes(
        _grad_worker, args=(GRAD_WORLD, str(tmp_path / "rendezvous"),
                            str(tmp_path), arrays, tree),
        nprocs=GRAD_WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + GRAD_TIMEOUT_S
    try:
        while not ctx.join(timeout=1):
            assert time.monotonic() < deadline, "ring ranks timed out"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
    for rank in range(GRAD_WORLD):
        errors = (tmp_path / f"errors-{rank}.txt").read_text().splitlines()
        assert len(errors) == 2
        for msg in errors:
            assert "K5" in msg and "torch.no_grad()" in msg, msg
    want = jax_flash_ref(*map(jnp.asarray, arrays), causal=True)
    _close(_gather(tmp_path, "nograd", (1, GRAD_WORLD)), np.asarray(want))
