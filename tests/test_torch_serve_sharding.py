"""The port's sharded serving against the JAX package's rules and the
single-process port, on the CPU.

- Rule tables: ``runtime/sharding.py::decode_state_specs`` and
  ``paged_state_specs`` against JAX ``decode_state_shardings`` and
  ``paged_state_shardings`` on an ``AbstractMesh``, every leaf, for
  full-width qwen3-4b, mamba2-370m and zamba2-1.2b (the port's state on the
  ``meta`` device, JAX's from ``jax.eval_shape``), meshes (1, 1), (2, 2),
  (4, 1) and (1, 4), ``tp`` and ``shard_cache_seq`` on and off, a span
  that ``model`` divides and one it does not; and whisper-medium's
  encoder-decoder state (``init_encdec_decode_state`` at 2 + 2 layers: a
  layer's cross K/V, self cache and the shared index) at its decoder
  window and two
  spans that ``model`` does not divide.  The port's state holds one
  cache an attention call and one SSM state a layer where JAX stacks them
  (``"stacks"``, ``"shared_attn"``): each port leaf is held against its
  JAX leaf with the stacked layer entry dropped.
- The flash forward's row log-sum-exp on the CPU route
  (``kernels/ref.py::flash_attention_lse_ref`` through
  ``ops.flash_attention(return_lse=True)``) with ``q_offset`` and
  ``kv_len``, ``+inf`` on rows with no key, against a direct logsumexp;
  the context merge (``ShardContext.merge_context``) weighs such parts 0.
- Gloo ranks: a module fixture starts 4 ranks with
  ``launch/mesh.py::run_ranks`` (spawn, a ``file://`` rendezvous, one
  thread each, a 300 s limit) and serves reduced fp32 models bridged from
  JAX ``init_lm`` in every mode of the sharded executor: the paged engine
  with TP (KV heads over ``model``) and without; the dense-cache step with
  context over ``model`` (with and without TP), KV heads over ``model``
  (``shard_cache_seq=False``, and a span that ``model`` does not divide),
  lanes over ``data``, ZeRO; SSM heads over ``model`` for mamba2 and
  zamba2; the sharded ``make_prefill_step``.  Decode logits within 1e-5 of
  the largest of the single-process port's, the same greedy tokens, the
  same results and page table on every rank.  Lane 0 starts at position 0,
  so for its first steps its context lies wholly on ``model`` rank 0 (the
  other rank's part has ``lse = +inf``); two lanes wrap their ring.
- The JAX oracle: JAX ``serve`` (``ShardPolicy(tp=False, zero=False)``) on
  a (data 2, model 2) mesh of 4 fake CPU devices, beside the ranks; the
  port's context-sharded ``serve`` on (2, 2) gives its tokens.
- ``serve --ranks 4``: the paged CLI's tokens are the one-process CLI's;
  the dense engine's ``serve_ranks`` in fp32 gives the single process's.
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

from repro.configs import get_config as jax_get_config
from repro.models.encdec import init_encdec as jax_init_encdec
from repro.models.encdec import \
    init_encdec_decode_state as jax_init_encdec_state
from repro.models.transformer import init_decode_state as jax_init_decode
from repro.models.transformer import init_lm as jax_init_lm
from repro.models.transformer import init_paged_state as jax_init_paged
from repro.runtime.sharding import ShardPolicy as JaxPolicy
from repro.runtime.sharding import decode_state_shardings
from repro.runtime.sharding import paged_state_shardings
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.kernels import ops
from repro_torch.kernels.ref import flash_attention_lse_ref
from repro_torch.launch import serve as serve_cli
from repro_torch.launch.mesh import (init_distributed, make_local_mesh,
                                     make_ring_mesh, run_ranks)
from repro_torch.models import (init_decode_state, init_encdec,
                                init_encdec_decode_state, init_paged_state)
from repro_torch.models.attention import attention_decode
from repro_torch.runtime import (ShardContext, ShardPolicy,
                                 decode_state_specs, make_prefill_step,
                                 make_serve_step, paged_state_specs,
                                 shard_serving_params)
from repro_torch.serving import EngineConfig, ServeRequest, ServingEngine

torch.set_num_threads(1)

# --------------------------------------------------------------------------
# the rule tables against JAX's
# --------------------------------------------------------------------------

ARCHS = ("qwen3-4b", "mamba2-370m", "zamba2-1.2b")
MESHES = {"1x1": (1, 1), "2x2": (2, 2), "4x1": (4, 1), "1x4": (1, 4)}
NAMES = ("data", "model")
# 2048 splits over any model axis here; 2046 does not split over 4, 2047
# over 2 (a cache's KV heads then split, or it stays whole)
CONTEXTS = (2048, 2047, 2046)
LANES = 8


def _norm(entries, nd):
    """A spec as a tuple of nd tuples of axis names (a bare name as a
    one-name tuple, None as the empty tuple)."""
    entries = list(entries) + [None] * (nd - len(entries))
    return tuple(() if e is None else (e,) if isinstance(e, str)
                 else tuple(e) for e in entries)


def _want(sharding, nd, stacked):
    """A JAX leaf's spec over the port leaf's nd dims."""
    if stacked:
        return _norm(sharding.spec, nd + 1)[1:]
    return _norm(sharding.spec, nd)


@functools.lru_cache(maxsize=None)
def _jax_decode_state(arch, context):
    cfg = jax_get_config(arch)
    return jax.eval_shape(lambda: jax_init_decode(cfg, LANES, context))


@pytest.mark.parametrize("context", CONTEXTS)
@pytest.mark.parametrize("seq", (True, False), ids=("seq", "heads"))
@pytest.mark.parametrize("tp", (False, True), ids=("rep", "tp"))
@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_state_specs_equal_jax(arch, mesh, tp, seq, context):
    shape = MESHES[mesh]
    jpol = JaxPolicy(tp=tp, zero=False, shard_cache_seq=seq)
    js = decode_state_shardings(_jax_decode_state(arch, context),
                                AbstractMesh(shape, NAMES), jpol)
    cfg = get_config(arch)
    state = init_decode_state(cfg, LANES, context, device="meta")
    ps = decode_state_specs(state, dict(zip(NAMES, shape)),
                            ShardPolicy(tp=tp, zero=False,
                                        shard_cache_seq=seq))
    hybrid = cfg.arch_type == "hybrid"
    assert len(ps["caches"]) == (len(js.get("shared_attn", [])) if hybrid
                                 else cfg.n_layers * (cfg.arch_type ==
                                                      "dense"))
    n_leaves = 0
    for i, cache in enumerate(ps["caches"]):
        for k in ("k", "v"):
            want = (_want(js["shared_attn"][i][k], 4, False) if hybrid
                    else _want(js["stacks"][0][k], 4, True))
            assert _norm(cache[k], 4) == want, (i, k)
            n_leaves += 1
    for st, sst in zip(ps.get("ssm_states", ()),
                       state.get("ssm_states", ())):
        for k in ("ssm", "conv"):
            nd = sst[k].dim()
            assert _norm(st[k], nd) == _want(js["stacks"][0][k], nd, True), k
            n_leaves += 1
    assert _norm(ps["index"], 0) == _norm(js["index"].spec, 0)
    assert n_leaves == 2 * len(state["caches"]) + 2 * len(
        state.get("ssm_states", ()))


# whisper-medium's decoder window splits over any model axis here; 447
# does not split over 2, 446 not over 4
ENCDEC_CONTEXTS = (448, 447, 446)


@functools.lru_cache(maxsize=None)
def _encdec_states(context):
    """(JAX, port) decode states of whisper-medium at full width on 8
    lanes, 2 + 2 layers (the rule does not read the depth): JAX's from
    ``jax.eval_shape``, the port's on the ``meta`` device."""
    jcfg, cfg = (c("whisper-medium").with_(n_layers=2, n_enc_layers=2)
                 for c in (jax_get_config, get_config))
    frames = (LANES, jcfg.encoder_seq, jcfg.d_model)
    js = jax.eval_shape(lambda: jax_init_encdec_state(
        jax_init_encdec(jax.random.PRNGKey(0), jcfg),
        jnp.zeros(frames, jcfg.dtype), jcfg, context))
    ps = init_encdec_decode_state(
        init_encdec(cfg, device="meta"),
        torch.empty(frames, dtype=cfg.dtype, device="meta"), cfg, context)
    return js, ps


@pytest.mark.parametrize("context", ENCDEC_CONTEXTS)
@pytest.mark.parametrize("seq", (True, False), ids=("seq", "heads"))
@pytest.mark.parametrize("tp", (False, True), ids=("rep", "tp"))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_encdec_decode_state_specs_equal_jax(mesh, tp, seq, context):
    """The enc-dec decode state: each layer's cross K/V (lanes over the
    batch axes, held against JAX's stacked ``cross_kv``), each self cache
    (context or KV heads over ``model``) and the shared index."""
    shape = MESHES[mesh]
    jstate, state = _encdec_states(context)
    js = decode_state_shardings(
        jstate, AbstractMesh(shape, NAMES),
        JaxPolicy(tp=tp, zero=False, shard_cache_seq=seq))
    ps = decode_state_specs(state, dict(zip(NAMES, shape)),
                            ShardPolicy(tp=tp, zero=False,
                                        shard_cache_seq=seq))
    assert len(ps["cross_kv"]) == len(ps["self_cache"]) == 2
    for kv in ps["cross_kv"]:
        assert len(kv) == len(js["cross_kv"]) == 2
        for got, want in zip(kv, js["cross_kv"]):
            assert _norm(got, 4) == _want(want, 4, True)
    for cache in ps["self_cache"]:
        for k in ("k", "v"):
            assert _norm(cache[k], 4) == _want(js["self_cache"][k], 4, True)
    assert _norm(ps["index"], 0) == _norm(js["index"].spec, 0)


@pytest.mark.parametrize("tp", (False, True), ids=("rep", "tp"))
@pytest.mark.parametrize("mesh", list(MESHES))
def test_paged_state_specs_equal_jax(mesh, tp):
    shape = MESHES[mesh]
    jcfg, cfg = jax_get_config("qwen3-4b"), get_config("qwen3-4b")
    js = paged_state_shardings(
        jax.eval_shape(lambda: jax_init_paged(jcfg, 256, 16)),
        AbstractMesh(shape, NAMES), JaxPolicy(tp=tp, zero=False))
    pools = init_paged_state(cfg, 256, 16, device="meta")
    ps = paged_state_specs(pools, dict(zip(NAMES, shape)),
                           ShardPolicy(tp=tp, zero=False))
    assert len(ps) == cfg.n_layers
    for pool in ps:
        for k in ("k", "v"):
            assert _norm(pool[k], 4) == _want(js["stacks"][0][k], 4, True)


@pytest.mark.parametrize("mesh", ["2x2", "4x1"])
def test_other_leaves_take_the_reference_rule(mesh):
    """The rule's last branch on leaves the port's state does not hold:
    ``cross_kv`` and any other leaf of rank 2 or more take their lanes over
    the batch axes, at dim 1 when dim 0 is under 256 (a stacked layer
    dim), else at dim 0; the index stays whole."""
    shape = MESHES[mesh]
    leaves = [("cross_kv", (4, 8, 100, 64)), ("cross_kv", (300, 8, 64)),
              ("x", (300, 8)), ("y", (8, 3)), ("index", (8,))]
    js = decode_state_shardings(
        [{n: jax.ShapeDtypeStruct(s, jnp.float32)} for n, s in leaves],
        AbstractMesh(shape, NAMES), JaxPolicy())
    ps = decode_state_specs(
        [{n: torch.empty(s, device="meta")} for n, s in leaves],
        dict(zip(NAMES, shape)), ShardPolicy())
    for (n, s), got, want in zip(leaves, ps, js):
        assert _norm(got[n], len(s)) == _norm(want[n].spec, len(s)), (n, s)


# --------------------------------------------------------------------------
# the row log-sum-exp and the context merge
# --------------------------------------------------------------------------

def _direct_lse(q, k, causal, q_offset, kv_len):
    """logsumexp over the admissible keys, written out per row."""
    B, S, H, dh = q.shape
    T, KV = k.shape[1], k.shape[2]
    out = torch.empty(B, S, H, dtype=torch.float64)
    for b in range(B):
        for s in range(S):
            pos = (0 if q_offset is None else int(q_offset[b])) + s
            keys = [t for t in range(T)
                    if (kv_len is None or t < int(kv_len[b]))
                    and (not causal or t <= pos)]
            for h in range(H):
                if not keys:
                    out[b, s, h] = float("inf")
                    continue
                sc = torch.stack([q[b, s, h].double()
                                  @ k[b, t, h // (H // KV)].double()
                                  for t in keys]) / dh ** 0.5
                out[b, s, h] = torch.logsumexp(sc, 0)
    return out


LSE_CASES = {
    "context slice": dict(causal=False, kv_len=[0, 1, 5, 12]),
    "paged decode": dict(causal=True, q_offset=[0, 3, -1, 11]),
    "prefill": dict(causal=True, q_offset=[2, 2, 2, 2], kv_len=[5, 0, 12,
                                                                 4]),
}


@pytest.mark.parametrize("case", list(LSE_CASES))
def test_lse_ref_takes_the_lengths_and_offsets(case):
    g = torch.Generator().manual_seed(0)
    kw = dict(LSE_CASES[case])
    S = 3 if case == "prefill" else 1
    q = torch.randn(4, S, 4, 16, generator=g)
    k = torch.randn(4, 12, 2, 16, generator=g)
    v = torch.randn(4, 12, 2, 16, generator=g)
    for name in ("q_offset", "kv_len"):
        if name in kw:
            kw[name] = torch.tensor(kw[name], dtype=torch.int32)
    want = _direct_lse(q, k, kw["causal"], kw.get("q_offset"),
                       kw.get("kv_len"))
    got = flash_attention_lse_ref(q, k, v, **kw)
    empty = torch.isinf(want)
    assert empty.any()
    assert torch.equal(got == float("inf"), empty)
    assert torch.allclose(got[~empty].double(), want[~empty], atol=1e-5)
    out, lse = ops.flash_attention(q, k, v, return_lse=True, **kw)
    assert torch.equal(lse, got)
    assert torch.equal(out, ops.flash_attention(q, k, v, **kw))
    assert bool((out[empty] == 0).all())


def test_return_lse_refuses_inputs_that_need_grad():
    q = torch.randn(1, 2, 2, 16, requires_grad=True)
    k = torch.randn(1, 2, 2, 16)
    with pytest.raises(ValueError, match="need no gradient"):
        ops.flash_attention(q, k, k, return_lse=True)


def _merge_ctx(parts):
    """A stand-in ``model`` group of two ranks holding ``parts`` (out,
    lse) for ``ShardContext.merge_context``: its gather returns both
    ranks' packed parts."""
    packed = [torch.cat([o.float(), lse[..., None]], -1)[None]
              for o, lse in parts]
    return types.SimpleNamespace(
        n_model=2, gather_model=lambda x, dim: torch.cat(packed, dim))


def test_merge_weighs_a_part_without_keys_zero():
    """Split keys over two "ranks": the merged attention is the whole
    one, and a rank whose slots hold none of a lane's keys (``lse``
    ``+inf``) weighs 0; a lane with no key anywhere gives zeros."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(3, 1, 4, 16, generator=g)
    k = torch.randn(3, 12, 2, 16, generator=g)
    v = torch.randn(3, 12, 2, 16, generator=g)
    kv_len = torch.tensor([4, 10, 0], dtype=torch.int32)
    whole = ops.flash_attention(q, k, v, causal=False, kv_len=kv_len)
    parts = [ops.flash_attention(
        q, k[:, a:a + 6], v[:, a:a + 6], causal=False, return_lse=True,
        kv_len=(kv_len - a).clamp(0, 6).to(torch.int32)) for a in (0, 6)]
    assert bool(torch.isinf(parts[1][1][0]).all())      # lane 0: none
    merged = ShardContext.merge_context(_merge_ctx(parts), *parts[0])
    assert torch.allclose(merged, whole, atol=1e-6)
    assert torch.equal(merged[0], ops.flash_attention(
        q, k[:, :6], v[:, :6], causal=False, kv_len=kv_len.clamp(max=6)
        .to(torch.int32))[0])
    assert bool((merged[2] == 0).all())


# --------------------------------------------------------------------------
# gloo ranks
# --------------------------------------------------------------------------

WORLD = 4
TIMEOUT_S = 300
TOL = 1e-5
B, CONTEXT, STEPS = 4, 16, 10


def _cfgs(arch):
    """(JAX config, port config) of a case's reduced fp32 model."""
    layers = {"qwen": 2, "mamba2": 2, "zamba2": 4}[arch]
    name = {"qwen": "qwen3-4b", "mamba2": "mamba2-370m",
            "zamba2": "zamba2-1.2b"}[arch]
    kw = dict(n_layers=layers, **({"d_model": 256} if arch == "qwen"
                                  else {}))
    return (jax_get_config(name).reduced(**kw).with_(dtype=jnp.float32),
            get_config(name).reduced(**kw).with_(dtype=torch.float32))


# (name, arch, (data, model), policy, context); the reference's serving
# steps take no ZeRO policy, but the executor's gathers serve it too
TP, REP = dict(tp=True, zero=False), dict(tp=False, zero=False)
DENSE_CASES = [
    ("qwen-2x2-tp-seq", "qwen", (2, 2), TP, CONTEXT),
    ("qwen-2x2-tp-heads", "qwen", (2, 2), dict(TP, shard_cache_seq=False),
     CONTEXT),
    ("qwen-2x2-seq", "qwen", (2, 2), REP, CONTEXT),
    ("qwen-2x2-heads", "qwen", (2, 2), dict(REP, shard_cache_seq=False),
     CONTEXT),
    ("qwen-4x1-lanes", "qwen", (4, 1), REP, CONTEXT),
    ("qwen-2x2-tp-zero", "qwen", (2, 2), dict(tp=True, zero=True), CONTEXT),
    ("qwen-1x4-tp-odd-span", "qwen", (1, 4), TP, CONTEXT + 2),
    ("mamba2-2x2-tp", "mamba2", (2, 2), TP, CONTEXT),
    ("mamba2-2x2", "mamba2", (2, 2), REP, CONTEXT),
    ("zamba2-2x2-tp", "zamba2", (2, 2), TP, CONTEXT),
    ("zamba2-1x4", "zamba2", (1, 4), REP, CONTEXT),
]
DENSE_NAMES = [c[0] for c in DENSE_CASES]
# the layout each case's state takes, by decode_state_specs
LAYOUTS = {"qwen-2x2-tp-seq": ((0, 2), "seq"),
           "qwen-2x2-tp-heads": ((0, 2), "heads"),
           "qwen-2x2-seq": ((0, 2), "seq"),
           "qwen-2x2-heads": ((0, 2), "heads"),
           "qwen-4x1-lanes": ((0, 1), None),
           "qwen-2x2-tp-zero": ((0, 2), "seq"),
           "qwen-1x4-tp-odd-span": ((0, 4), "heads"),
           "mamba2-2x2-tp": ((0, 2), "seq"), "mamba2-2x2": ((0, 2), "seq"),
           "zamba2-2x2-tp": ((0, 2), "seq"), "zamba2-1x4": ((0, 4), "seq")}
PAGED_CASES = [("paged-2x2-tp", (2, 2), TP), ("paged-2x2", (2, 2), REP),
               ("paged-1x4-tp", (1, 4), TP)]
PAGED_NAMES = [c[0] for c in PAGED_CASES]
PREFILL_CASES = [("prefill-qwen-2x2-tp", "qwen"),
                 ("prefill-mamba2-2x2-tp", "mamba2"),
                 ("prefill-zamba2-2x2-tp", "zamba2")]
PREFILL_NAMES = [c[0] for c in PREFILL_CASES]
ECFG = EngineConfig(page_size=4, n_pages=32, decode_slots=4, max_context=32,
                    prefill_batch=2, prefill_chunk=8)


def _mesh(meshes, shape):
    if shape not in meshes:     # a collective: the same order everywhere
        meshes[shape] = make_local_mesh(shape[1], device_type="cpu")
    return meshes[shape]


def _tokens(vocab):
    return np.random.default_rng(5).integers(0, vocab, (STEPS, B),
                                             dtype=np.int32)


def _decode_steps(cfg, params, context, **kw):
    """STEPS decode steps of B lanes from positions 0, 3, C - 4 and C - 1
    (the last two wrap), on fixed tokens: the logits of each step."""
    step = make_serve_step(cfg, **kw)
    st = init_decode_state(cfg, B, context, device="cpu", shard=step.shard)
    st["index"] = torch.tensor([0, 3, context - 4, context - 1],
                               dtype=torch.int32)
    out = []
    for t in _tokens(cfg.vocab_size):
        logits, st = step(params, st, torch.from_numpy(t))
        out.append(logits.numpy())
    return np.stack(out)


def _requests(vocab, context):
    """6 requests on B lanes (recycled), the last one wrapping the ring."""
    rng = np.random.default_rng(6)
    lens = [3, 7, 5, 9, 4, context - 2]
    return [serve_cli.Request(i, rng.integers(0, vocab, n).tolist(), 6)
            for i, n in enumerate(lens)]


def _serve_tokens(cfg, params, context, **kw):
    reqs = _requests(cfg.vocab_size, context)
    serve_cli.serve(cfg, reqs, B, context, verbose=False, device="cpu",
                    params=params, **kw)
    return [r.generated for r in reqs]


def _paged(cfg, params, **kw):
    """One fixed prefill chunk and decode step on an engine's pools (the
    logits), then 6 requests through a fresh engine, two arriving later:
    the tokens and the page table at the end."""
    rng = np.random.default_rng(7)
    engine = ServingEngine(cfg, params, ECFG, device="cpu", **kw)
    rows = torch.arange(32, dtype=torch.int32).reshape(4, 8)
    pre = engine._prefill(
        params, engine.pools,
        torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 8),
                                      dtype=np.int32)), rows[:2], 0,
        torch.tensor([8, 5], dtype=torch.int32))
    dec = engine._decode(
        params, engine.pools,
        torch.from_numpy(rng.integers(0, cfg.vocab_size, 4, dtype=np.int32)),
        rows, torch.tensor([8, 5, -1, -1], dtype=torch.int32))
    engine = ServingEngine(cfg, params, ECFG, device="cpu", **kw)
    reqs = [ServeRequest(rid=str(i), prompt=rng.integers(
        0, cfg.vocab_size, n).tolist(), max_new=5,
        arrival_s=0.05 if i >= 4 else 0.0)
            for i, n in enumerate([3, 9, 12, 6, 5, 10])]
    engine.run(reqs)
    return {"prefill": pre.numpy(), "decode": dec.numpy(),
            "tokens": [r.tokens for r in reqs],
            "done": [r.done for r in reqs],
            "page_table": [t.numpy().tolist() for t in engine.state]}


def _prefill(cfg, params, **kw):
    tokens = torch.from_numpy(np.random.default_rng(8).integers(
        0, cfg.vocab_size, (2, 24), dtype=np.int32))
    return make_prefill_step(cfg, **kw)(params, {"tokens": tokens}).numpy()


def _all_ranks(value):
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, value)
    return got


def _worker(rank, world, init_file, out_dir, trees):
    """One rank: every case; rank 0 saves each case's results and the
    other ranks' agreement."""
    torch.set_num_threads(1)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{init_file}", timeout_s=TIMEOUT_S)
    try:
        meshes, out = {}, {}

        def placed(arch, mesh, pol):
            cfg = _cfgs(arch)[1]
            return cfg, shard_serving_params(
                params_from_jax(trees[arch], cfg, device="cpu"), mesh, pol,
                cfg=cfg)

        for name, arch, shape, pk, context in DENSE_CASES:
            mesh, pol = _mesh(meshes, shape), ShardPolicy(**pk)
            cfg, params = placed(arch, mesh, pol)
            logits = _decode_steps(cfg, params, context, mesh=mesh,
                                   policy=pol)
            layout = make_serve_step(cfg, mesh=mesh, policy=pol).shard \
                .decode_layout(B, context)
            tokens = _serve_tokens(cfg, params, context, mesh=mesh,
                                   policy=pol)
            same = _all_ranks((logits.tobytes(), tokens))
            out[name] = {"logits": logits.tolist(), "tokens": tokens,
                         "same": all(s == same[0] for s in same),
                         "layouts": _all_ranks([list(layout.lanes),
                                                layout.kv])}
        for name, shape, pk in PAGED_CASES:
            mesh, pol = _mesh(meshes, shape), ShardPolicy(**pk)
            cfg, params = placed("qwen", mesh, pol)
            res = _paged(cfg, params, mesh=mesh, policy=pol)
            same = _all_ranks((res["prefill"].tobytes(),
                               res["decode"].tobytes(), res["tokens"]))
            res.update(same=all(s == same[0] for s in same),
                       page_tables=_all_ranks(res["page_table"]),
                       prefill=res["prefill"].tolist(),
                       decode=res["decode"].tolist())
            out[name] = res
        for name, arch in PREFILL_CASES:
            mesh, pol = _mesh(meshes, (2, 2)), ShardPolicy(**TP)
            cfg, params = placed(arch, mesh, pol)
            block = _prefill(cfg, params, mesh=mesh, policy=pol)
            out[name] = _all_ranks(
                ([mesh.get_local_rank("data"), mesh.get_local_rank("model")],
                 block.tolist()))
        # a context-sharded cache refuses a window shorter than its span
        mesh, pol = _mesh(meshes, (2, 2)), ShardPolicy(**TP)
        cfg, params = placed("qwen", mesh, pol)
        step = make_serve_step(cfg, mesh=mesh, policy=pol)
        st = init_decode_state(cfg, B, CONTEXT, device="cpu",
                               shard=step.shard)
        x = torch.zeros(2, 1, cfg.d_model)
        try:
            attention_decode(params.blocks[0].attn, x, st["caches"][0],
                             torch.zeros(2, dtype=torch.int32), cfg,
                             window=4, shard=step.shard,
                             layout=st["layout"])
            out["window"] = None
        except ValueError as e:
            out["window"] = str(e)
        # the serving steps refuse a mesh without ("data", "model")
        ring = make_ring_mesh(2, 2, device_type="cpu")
        try:
            make_serve_step(cfg, mesh=ring)
            out["mesh"] = None
        except ValueError as e:
            out["mesh"] = str(e)
        # the JAX oracle's case: serve on (2, 2) with the reference's
        # serving policy
        mesh, pol = _mesh(meshes, (2, 2)), ShardPolicy(**REP)
        cfg, params = placed("qwen", mesh, pol)
        out["oracle"] = _serve_tokens(cfg, params, CONTEXT, mesh=mesh,
                                      policy=pol)
        if rank == 0:
            pathlib.Path(f"{out_dir}/results.json").write_text(
                json.dumps(out))
        dist.barrier()
    finally:
        dist.destroy_process_group()


JAX_SERVE = """
import json, jax, jax.numpy as jnp
import repro.launch.serve as S
from repro.configs import get_config
cfg = get_config("qwen3-4b").reduced(n_layers=2, d_model=256).with_(
    dtype=jnp.float32)
local = S.make_local_mesh
for name, mesh in (("2x2", jax.make_mesh((2, 2), ("data", "model"),
                                         devices=jax.devices()[:4])),
                   ("4x1", None)):
    S.make_local_mesh = local if mesh is None else (lambda m=mesh: m)
    reqs = [S.Request(i, p, n) for i, (p, n) in enumerate(REQUESTS)]
    try:
        S.serve(cfg, reqs, BATCH, CONTEXT, verbose=False)
        print("JAX", name, json.dumps([r.generated for r in reqs]))
    except Exception as e:
        print("JAX", name, json.dumps(type(e).__name__ + ": "
                                      + str(e).splitlines()[0][:200]))
"""


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case on 4 gloo ranks, the single-process references, and
    JAX ``serve`` on (2, 2) fake devices beside the ranks."""
    tmp = tmp_path_factory.mktemp("serve_sharding")
    trees, refs = {}, {}
    for arch in ("qwen", "mamba2", "zamba2"):
        cj, ct = _cfgs(arch)
        trees[arch] = jax.tree.map(
            np.asarray, jax_init_lm(jax.random.PRNGKey(0), cj))
    for name, arch, _, _, context in DENSE_CASES:
        ct = _cfgs(arch)[1]
        key = (arch, context)
        if key not in refs:
            params = params_from_jax(trees[arch], ct, device="cpu")
            refs[key] = {"logits": _decode_steps(ct, params, context),
                         "tokens": _serve_tokens(ct, params, context)}
    ct = _cfgs("qwen")[1]
    refs["paged"] = _paged(ct, params_from_jax(trees["qwen"], ct,
                                               device="cpu"))
    for name, arch in PREFILL_CASES:
        ct = _cfgs(arch)[1]
        refs[name] = _prefill(ct, params_from_jax(trees[arch], ct,
                                                  device="cpu"))
    reqs = _requests(ct.vocab_size, CONTEXT)
    code = (JAX_SERVE.replace("REQUESTS", repr([(r.prompt, r.max_new)
                                                for r in reqs]))
            .replace("BATCH", str(B)).replace("CONTEXT", str(CONTEXT)))
    with ThreadPoolExecutor(1) as pool:     # beside the ranks
        jax_run = pool.submit(run_subprocess, code, devices=4,
                              timeout=TIMEOUT_S)
        run_ranks(_worker, (WORLD, str(tmp / "rendezvous"), str(tmp),
                            trees), WORLD, timeout_s=TIMEOUT_S)
        jax_out = jax_run.result()
    jax_res = {line.split(" ", 2)[1]: json.loads(line.split(" ", 2)[2])
               for line in jax_out.splitlines() if line.startswith("JAX ")}
    return types.SimpleNamespace(
        res=json.loads((tmp / "results.json").read_text()), refs=refs,
        jax=jax_res)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / np.abs(want).max()


@pytest.mark.parametrize("case", DENSE_CASES, ids=DENSE_NAMES)
def test_sharded_decode_logits_match_the_single_process(runs, case):
    name, arch, _, _, context = case
    got, want = runs.res[name]["logits"], runs.refs[(arch, context)]
    assert _rel(got, want["logits"]) <= TOL
    assert np.array_equal(np.argmax(got, -1), np.argmax(want["logits"], -1))
    assert runs.res[name]["same"]           # every rank the same bits


@pytest.mark.parametrize("case", DENSE_CASES, ids=DENSE_NAMES)
def test_sharded_serve_gives_the_single_process_tokens(runs, case):
    """``serve`` with recycled lanes and a request that wraps the ring."""
    name, arch, _, _, context = case
    assert runs.res[name]["tokens"] == runs.refs[(arch, context)]["tokens"]


@pytest.mark.parametrize("case", DENSE_CASES, ids=DENSE_NAMES)
def test_decode_state_layout(runs, case):
    """Lanes over ``data`` (each data rank its share), the cache's context
    or KV heads over ``model`` as ``decode_state_specs`` says."""
    name, _, shape, _, _ = case
    lanes, kv = LAYOUTS[name]
    b = lanes[1] - lanes[0]
    want = [[[d * b, (d + 1) * b] if b < B else [0, B], kv]
            for d in range(shape[0]) for _ in range(shape[1])]
    assert runs.res[name]["layouts"] == want


@pytest.mark.parametrize("case", PAGED_CASES, ids=PAGED_NAMES)
def test_sharded_paged_logits_match_the_single_process(runs, case):
    res, ref = runs.res[case[0]], runs.refs["paged"]
    for part in ("prefill", "decode"):
        assert _rel(res[part], ref[part]) <= TOL, part
        assert np.array_equal(np.argmax(res[part], -1),
                              np.argmax(ref[part], -1))
    assert res["same"]


@pytest.mark.parametrize("case", PAGED_CASES, ids=PAGED_NAMES)
def test_sharded_paged_engine_gives_the_single_process_tokens(runs, case):
    """Two requests arrive later: every rank admits them alike (rank 0's
    clock) and every request completes with the single process's
    tokens."""
    res = runs.res[case[0]]
    assert all(res["done"])
    assert res["tokens"] == runs.refs["paged"]["tokens"]


@pytest.mark.parametrize("case", PAGED_CASES, ids=PAGED_NAMES)
def test_page_table_is_the_same_on_every_rank(runs, case):
    tables = runs.res[case[0]]["page_tables"]
    assert all(t == tables[0] for t in tables)
    assert tables[0] == runs.refs["paged"]["page_table"]


@pytest.mark.parametrize("case", PREFILL_CASES, ids=PREFILL_NAMES)
def test_sharded_prefill_gives_each_rank_its_block(runs, case):
    """Each rank's logits are its lanes (over ``data``) and vocabulary
    columns (over ``model``) of the single process's."""
    full = runs.refs[case[0]]
    for (d, m), block in runs.res[case[0]]:
        b, v = full.shape[0] // 2, full.shape[2] // 2
        want = full[d * b:(d + 1) * b, :, m * v:(m + 1) * v]
        assert np.asarray(block).shape == want.shape
        assert _rel(block, want) * np.abs(want).max() \
            <= TOL * np.abs(full).max()


def test_context_shard_refuses_a_window_shorter_than_the_span(runs):
    msg = runs.res["window"]
    assert msg is not None and "_ring_in_order" in msg


def test_serving_steps_refuse_a_mesh_without_data_and_model(runs):
    msg = runs.res["mesh"]
    assert msg is not None and "('data', 'model')" in msg


def test_context_sharded_serve_matches_jax_serve(runs):
    """JAX ``serve`` with ``ShardPolicy(tp=False, zero=False)``, the
    reference's serving policy, on 4 fake devices.  On a (data 2, model 2)
    mesh the JAX step raises a ``ShardingTypeError`` on its cache write
    (``cache.at[...].set`` into a context split over ``model``), so the
    port's context-sharded ``serve`` on (2, 2) is held against JAX
    ``serve`` on its own driver's mesh, ``make_local_mesh()`` (data 4,
    model 1: the cache unsplit over ``model``), and the single-process
    port.  Should the JAX step run on (2, 2), its tokens are held too."""
    want = runs.refs[("qwen", CONTEXT)]["tokens"]
    assert runs.jax["4x1"] == want
    assert runs.res["oracle"] == runs.jax["4x1"]
    if isinstance(runs.jax["2x2"], list):
        assert runs.res["oracle"] == runs.jax["2x2"]
    else:
        assert runs.jax["2x2"].startswith("ShardingTypeError")


# --------------------------------------------------------------------------
# serve --ranks
# --------------------------------------------------------------------------

def _cli(argv):
    reqs = serve_cli.main(["--device", "cpu", "--requests", "5", "--batch",
                           "4", "--max-new", "6", *argv])
    return [r.generated for r in reqs]


def test_serve_cli_ranks_paged_gives_the_one_process_tokens():
    """``serve --ranks 4``: ("data" 4, "model" 1), the paged engine's
    lanes whole on every rank."""
    assert _cli(["--ranks", "4"]) == _cli(["--ranks", "1"])


def test_serve_ranks_dense_fp32_gives_the_single_process_tokens():
    """The dense engine's lanes split over ``data`` (one a rank)."""
    cfg = _cfgs("qwen")[1]
    args = serve_cli.parse_args(["--device", "cpu", "--engine", "dense",
                                 "--requests", "6", "--batch", "4",
                                 "--max-new", "6", "--context", "16",
                                 "--ranks", "4"])
    one = serve_cli.synthetic_requests(cfg, args)
    serve_cli._run_engine(cfg, args, one, "cpu", verbose=False)
    many = serve_cli.serve_ranks(cfg, args,
                                 serve_cli.synthetic_requests(cfg, args), 4)
    assert [r.generated for r in many] == [r.generated for r in one]
    assert all(len(r.generated) == 6 for r in many)
