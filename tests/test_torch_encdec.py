"""The port's encoder-decoder serving path against the JAX package's.

Reduced whisper-medium (``get_config("whisper-medium").reduced()``: 2 + 2
layers, d 256, 4 heads of dh 64, 32 encoder frames) in fp32 on the CPU,
where the port's flash attention takes its plain version.  Weights come
from JAX ``init_encdec(max_dec_len=64)``, bridged with
``repro_torch.bridge``; frames and tokens are made with numpy from a seed.
Tolerances are against the JAX function, over the largest magnitude of
its output: the layers (``layer_norm``, ``gelu``, ``gelu_mlp``,
``precompute_cross_kv``, ``cross_attention``) within 1e-6, ``encode``,
``decode_train`` and ``make_prefill_step`` within 1e-5 (the same fp32
arithmetic summed in another order through 2 + 2 layers), and 8 steps of
``make_serve_step`` within 1e-4 with greedy tokens identical to JAX
``encdec_decode_step``, once from position 0 and once across the end of
the 64-row learned position table and of a 16-slot self-attention ring.
The bridge carries the enc-dec tree bit for bit both ways in bf16.
On a one-rank mesh the sharded steps build and run (4 ranks are held in
``test_torch_encdec_sharding.py``); the paged steps and ``serve`` of an
enc-dec config raise NotImplementedError; what the JAX ``serve`` does with
one is shown as a fact about the reference.  Training is held against JAX in
``test_torch_encdec_train.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch.mesh import make_local_mesh as jax_make_local_mesh
from repro.launch.serve import Request as JaxRequest
from repro.launch.serve import serve as jax_serve
from repro.launch.serve import serve_paged as jax_serve_paged
from repro.models import attention as jax_attn
from repro.models import encdec as jax_encdec
from repro.models import layers as jax_layers
from repro.models import mlp as jax_mlp
from repro.runtime import executor as jax_executor
from repro.runtime.sharding import ShardPolicy as JaxShardPolicy
from repro.serving import EngineConfig as JaxEngineConfig
from repro_torch.bridge import params_from_jax, tree_from_params
from repro_torch.configs import get_config
from repro_torch.launch import serve as serve_mod
from repro_torch.launch.mesh import init_distributed, make_local_mesh
from repro_torch.models import (EncDec, build_stacks, decode_train,
                                encdec_decode_step, encode, init_encdec,
                                init_encdec_decode_state)
from repro_torch.models.attention import (cross_attention, init_attention,
                                          precompute_cross_kv)
from repro_torch.models.layers import gelu, layer_norm
from repro_torch.models.mlp import GeluMLP, gelu_mlp
from repro_torch.runtime.executor import (init_serving_params,
                                          init_train_state,
                                          make_paged_decode_step,
                                          make_paged_prefill_step,
                                          make_prefill_step, make_serve_step,
                                          make_train_step)

torch.set_num_threads(1)

ARCH = "whisper-medium"
MAX_DEC_LEN = 64
LAYER_TOL, MODEL_TOL, STEP_TOL = 1e-6, 1e-5, 1e-4


def _cfgs(dtype="float32"):
    return (jax_get_config(ARCH).reduced().with_(dtype=getattr(jnp, dtype)),
            get_config(ARCH).reduced().with_(dtype=getattr(torch, dtype)))


def _rel(got, want) -> float:
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else got
    want = np.asarray(want, np.float32)
    return float(np.abs(np.asarray(got, np.float32) - want).max()
                 / np.abs(want).max())


@pytest.fixture(scope="module")
def model():
    """(cfg_j, cfg_t, JAX params, port params) of reduced fp32 whisper."""
    cfg_j, cfg_t = _cfgs()
    params_j = jax_encdec.init_encdec(jax.random.PRNGKey(0), cfg_j,
                                      max_dec_len=MAX_DEC_LEN)
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    return cfg_j, cfg_t, params_j, params_t


def _frames(cfg, B=2, seed=0):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, cfg.encoder_seq, cfg.d_model),
                               np.float32)


def _tokens(cfg, B=2, S=12, seed=1):
    rng = np.random.default_rng(seed)
    return rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("shape", [(3, 256), (2, 5, 1024)])
def test_layer_norm_and_gelu_match_jax(shape):
    rng = np.random.default_rng(sum(shape))
    x = rng.standard_normal(shape, np.float32) * 3 + 1
    w = rng.standard_normal(shape[-1:], np.float32)
    b = rng.standard_normal(shape[-1:], np.float32)
    got = layer_norm(*(torch.from_numpy(a) for a in (x, w, b)), 1e-5)
    want = jax_layers.layer_norm(jnp.asarray(x), jnp.asarray(w),
                                 jnp.asarray(b), 1e-5)
    assert got.dtype == torch.float32
    assert _rel(got, want) <= LAYER_TOL
    assert _rel(gelu(torch.from_numpy(x)),
                jax_layers.gelu(jnp.asarray(x))) <= LAYER_TOL


def test_layer_norm_computes_in_fp32_and_returns_x_dtype():
    x = torch.randn(4, 64).bfloat16()
    w, b = torch.ones(64).bfloat16(), torch.zeros(64).bfloat16()
    got = layer_norm(x, w, b)
    assert got.dtype == torch.bfloat16
    want = torch.nn.functional.layer_norm(x.float(), (64,), eps=1e-5)
    assert torch.equal(got, want.bfloat16())


def test_gelu_mlp_matches_jax(model):
    cfg_j, cfg_t, params_j, params_t = model
    p_j = jax.tree.map(lambda a: a[0], params_j["enc_blocks"]["mlp"])
    p_t = params_t.enc_blocks[0].mlp
    assert isinstance(p_t, GeluMLP)
    x = np.random.default_rng(2).standard_normal((2, 7, cfg_t.d_model),
                                                 np.float32)
    got = gelu_mlp(p_t, torch.from_numpy(x))
    assert _rel(got, jax_mlp.gelu_mlp(p_j, jnp.asarray(x))) <= LAYER_TOL


def test_cross_attention_matches_jax(model):
    """``precompute_cross_kv`` and ``cross_attention`` of the first decoder
    layer: S = 5 queries over the T = 32 encoder rows (S != T)."""
    cfg_j, cfg_t, params_j, params_t = model
    p_j = jax.tree.map(lambda a: a[0], params_j["dec_blocks"]["cross_attn"])
    p_t = params_t.dec_blocks[0].cross_attn
    rng = np.random.default_rng(3)
    enc = rng.standard_normal((2, cfg_t.encoder_seq, cfg_t.d_model),
                              np.float32)
    x = rng.standard_normal((2, 5, cfg_t.d_model), np.float32)
    kv_t = precompute_cross_kv(p_t, torch.from_numpy(enc), cfg_t)
    kv_j = jax_attn.precompute_cross_kv(p_j, jnp.asarray(enc), cfg_j)
    for a, b in zip(kv_t, kv_j):
        assert a.shape == (2, cfg_t.encoder_seq, cfg_t.n_kv_heads, cfg_t.dh)
        assert _rel(a, b) <= LAYER_TOL
    got = cross_attention(p_t, torch.from_numpy(x), kv_t, cfg_t)
    want = jax_attn.cross_attention(p_j, jnp.asarray(x), kv_j, cfg_j)
    assert _rel(got, want) <= LAYER_TOL


def test_cross_attention_block_has_no_qkv_bias():
    cfg = get_config(ARCH).reduced().with_(qkv_bias=True)
    g = torch.Generator().manual_seed(0)
    kw = dict(generator=g, device=torch.device("cpu"))
    assert init_attention(cfg, **kw).bq is not None
    assert init_attention(cfg, cross=True, **kw).bq is None


def test_encode_and_decode_train_match_jax(model):
    cfg_j, cfg_t, params_j, params_t = model
    frames, tokens = _frames(cfg_t), _tokens(cfg_t)
    enc_t = encode(params_t, torch.from_numpy(frames), cfg_t)
    enc_j = jax_encdec.encode(params_j, jnp.asarray(frames), cfg_j)
    assert enc_t.shape == frames.shape
    assert _rel(enc_t, enc_j) <= MODEL_TOL
    logits_t = decode_train(params_t, torch.from_numpy(tokens), enc_t, cfg_t)
    logits_j = jax_encdec.decode_train(params_j, jnp.asarray(tokens), enc_j,
                                       cfg_j)
    assert logits_t.shape == (*tokens.shape, cfg_t.vocab_size)
    assert _rel(logits_t, logits_j) <= MODEL_TOL
    # both differentiate (the training path); the prefill step does not
    assert enc_t.requires_grad and logits_t.requires_grad
    prefill = make_prefill_step(cfg_t)(params_t, {
        "tokens": torch.from_numpy(tokens),
        "frames": torch.from_numpy(frames)})
    assert not prefill.requires_grad and torch.is_inference(prefill)


def test_decode_train_wraps_positions_past_the_learned_table(model):
    """A sequence longer than the 64-row table takes row ``s % 64``, as the
    reference's (positions 64..69 reuse rows 0..5)."""
    cfg_j, cfg_t, params_j, params_t = model
    frames, tokens = _frames(cfg_t, B=1), _tokens(cfg_t, B=1, S=70)
    enc_j = jax_encdec.encode(params_j, jnp.asarray(frames), cfg_j)
    logits_j = jax_encdec.decode_train(params_j, jnp.asarray(tokens), enc_j,
                                       cfg_j)
    logits_t = decode_train(params_t, torch.from_numpy(tokens),
                            torch.from_numpy(np.array(enc_j)), cfg_t)
    assert _rel(logits_t, logits_j) <= MODEL_TOL


def test_make_prefill_step_matches_jax(model):
    """The port's prefill step against JAX ``make_prefill_step`` on a
    one-device mesh: ``decode_train`` of the tokens over ``encode`` of the
    frames."""
    cfg_j, cfg_t, params_j, params_t = model
    frames, tokens = _frames(cfg_t), _tokens(cfg_t)
    batch = {"tokens": jax.ShapeDtypeStruct(tokens.shape, jnp.int32),
             "frames": jax.ShapeDtypeStruct(frames.shape, jnp.float32)}
    mesh = jax_make_local_mesh()
    with mesh:
        step = jax_executor.make_prefill_step(
            cfg_j, mesh, JaxShardPolicy(tp=False, zero=False), batch)
        want = step.fn(params_j, {"tokens": jnp.asarray(tokens),
                                  "frames": jnp.asarray(frames)})
    got = make_prefill_step(cfg_t)(params_t, {
        "tokens": torch.from_numpy(tokens),
        "frames": torch.from_numpy(frames)})
    assert _rel(got, want) <= MODEL_TOL


@pytest.mark.parametrize("start", [0, MAX_DEC_LEN - 4],
                         ids=["from-0", "wrap"])
def test_serve_steps_match_jax_encdec_decode_step(model, start):
    """8 greedy steps of ``make_serve_step`` against JAX
    ``encdec_decode_step`` on a 16-slot cache: logits within 1e-4, the same
    greedy tokens.  ``wrap`` starts both states at index 60, so the steps
    cross the end of the 64-row learned table (rows 60..63, then 0..3) and
    the 16-slot ring wraps."""
    cfg_j, cfg_t, params_j, params_t = model
    frames = _frames(cfg_t, seed=4)
    context = 16
    state_j = jax_encdec.init_encdec_decode_state(
        params_j, jnp.asarray(frames), cfg_j, context)
    state_t = init_encdec_decode_state(params_t, torch.from_numpy(frames),
                                       cfg_t, context)
    state_j["index"] = jnp.asarray(start, jnp.int32)
    state_t["index"] = torch.tensor(start, dtype=torch.int32)
    for (k_t, v_t), (k_j, v_j) in zip(state_t["cross_kv"], zip(
            *(list(a) for a in state_j["cross_kv"]))):
        assert _rel(k_t, k_j) <= MODEL_TOL and _rel(v_t, v_j) <= MODEL_TOL
    step_j = jax.jit(lambda p, s, t: jax_encdec.encdec_decode_step(
        p, s, t, cfg_j))
    step_t = make_serve_step(cfg_t)
    assert step_t.shard is None
    tok = np.array([3, 500], np.int32)
    worst = 0.0
    for _ in range(8):
        logits_j, state_j = step_j(params_j, state_j, jnp.asarray(tok))
        logits_t, state_t = step_t(params_t, state_t, torch.from_numpy(tok))
        worst = max(worst, _rel(logits_t, logits_j))
        nxt_j = np.asarray(jnp.argmax(logits_j, -1)).astype(np.int32)
        nxt_t = logits_t.argmax(-1).numpy().astype(np.int32)
        assert np.array_equal(nxt_t, nxt_j)
        tok = nxt_t
    assert worst <= STEP_TOL
    assert int(state_t["index"]) == int(state_j["index"]) == start + 8
    for cache_t, k_j in zip(state_t["self_cache"],
                            state_j["self_cache"]["k"]):
        assert _rel(cache_t["k"], k_j) <= MODEL_TOL


def test_serve_steps_agree_with_the_teacher_forced_prefill(model):
    """On the port alone: each decode step's logits against the
    teacher-forced prefill's at that position (``tests/
    test_models_numerics.py``'s check for the reference), fp32 1e-4."""
    _, cfg_t, _, params_t = model
    frames, tokens = _frames(cfg_t, seed=5), _tokens(cfg_t, S=10, seed=6)
    full = make_prefill_step(cfg_t)(params_t, {
        "tokens": torch.from_numpy(tokens),
        "frames": torch.from_numpy(frames)})
    state = init_encdec_decode_state(params_t, torch.from_numpy(frames),
                                     cfg_t, 16)
    for t in range(tokens.shape[1]):
        logits, state = encdec_decode_step(
            params_t, state, torch.from_numpy(tokens[:, t]), cfg_t)
        assert _rel(logits, full[:, t]) <= STEP_TOL


def _flat(tree):
    return dict(jax.tree_util.tree_flatten_with_path(tree)[0])


def test_bridge_carries_the_encdec_tree_bit_for_bit_both_ways():
    cfg_j, cfg_t = _cfgs("bfloat16")
    tree = jax.tree.map(np.asarray, jax_encdec.init_encdec(
        jax.random.PRNGKey(1), cfg_j, max_dec_len=MAX_DEC_LEN))
    params = params_from_jax(tree, cfg_t, device="cpu")
    assert isinstance(params, EncDec)
    assert sum(p.numel() for p in params.parameters()) == sum(
        a.size for a in jax.tree.leaves(tree))
    assert params.dec_blocks[0].self_attn.wq.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params.dec_blocks[1].cross_attn.wk.detach().view(torch.int16).numpy(),
        tree["dec_blocks"]["cross_attn"]["wk"][1].view(np.int16))
    back = tree_from_params(params)
    a, b = _flat(tree), _flat(back)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape, k
        assert a[k].tobytes() == b[k].tobytes(), k


@pytest.mark.parametrize("where", ["top", "enc_blocks", "dec_blocks"])
def test_bridge_raises_on_an_encdec_key_it_does_not_map(where):
    cfg_j, cfg_t = _cfgs()
    tree = jax.tree.map(np.asarray, jax_encdec.init_encdec(
        jax.random.PRNGKey(0), cfg_j, max_dec_len=8))
    node = tree if where == "top" else tree[where]
    node["projector"] = np.zeros(3, np.float32)
    with pytest.raises(ValueError, match="projector"):
        params_from_jax(tree, cfg_t, device="cpu")


def test_init_encdec_has_the_reference_tree():
    """The port's random init has JAX ``init_encdec``'s leaves (names,
    shapes, dtypes), so ``tree_from_params`` of it is a JAX tree."""
    cfg_j, cfg_t = _cfgs("bfloat16")
    want = jax.eval_shape(lambda k: jax_encdec.init_encdec(
        k, cfg_j, max_dec_len=MAX_DEC_LEN), jax.random.PRNGKey(0))
    got = tree_from_params(init_encdec(cfg_t, max_dec_len=MAX_DEC_LEN,
                                       device="cpu"))
    a, b = _flat(want), _flat(got)
    assert a.keys() == b.keys()
    for k in a:
        assert (a[k].shape, a[k].dtype) == (b[k].shape, b[k].dtype), k


def test_init_serving_params_builds_the_encdec():
    _, cfg_t = _cfgs()
    params = init_serving_params(cfg_t, device="cpu")
    assert isinstance(params, EncDec)
    assert len(params.enc_blocks) == cfg_t.n_enc_layers
    assert len(params.dec_blocks) == cfg_t.n_layers


@pytest.fixture
def one_rank_mesh(tmp_path):
    init_distributed(0, 1, backend="gloo",
                     init_method=f"file://{tmp_path}/rendezvous")
    try:
        yield make_local_mesh(device_type="cpu")
    finally:
        torch.distributed.destroy_process_group()


def test_sharded_encdec_raises(one_rank_mesh):
    """No serving or training step, nor state initialiser, raises on a
    mesh: on a (1, 1) mesh each builds and runs, and gives the one-device
    results; the paged steps, decoder-only as in the reference, raise
    naming the enc-dec.  ``tests/test_torch_encdec_sharding.py`` holds 4 ranks
    against one process."""
    _, cfg_t = _cfgs()
    frames = torch.from_numpy(_frames(cfg_t))
    tokens = torch.from_numpy(_tokens(cfg_t, S=8)).long()
    batch = {"tokens": tokens, "frames": frames, "labels": tokens}
    one = init_serving_params(cfg_t, device="cpu")
    sharded = init_serving_params(cfg_t, mesh=one_rank_mesh, device="cpu")
    for a, b in zip(one.parameters(), sharded.parameters()):
        assert torch.equal(a, b)
    want = make_prefill_step(cfg_t)(one, batch)
    got = make_prefill_step(cfg_t, mesh=one_rank_mesh)(sharded, batch)
    assert _rel(got, want) <= MODEL_TOL
    step = make_serve_step(cfg_t, mesh=one_rank_mesh)
    state = init_encdec_decode_state(sharded, frames, cfg_t, 16,
                                     shard=step.shard)
    want_lg, _ = make_serve_step(cfg_t)(
        one, init_encdec_decode_state(one, frames, cfg_t, 16), tokens[:, 0])
    got_lg, state = step(sharded, state, tokens[:, 0])
    assert _rel(got_lg, want_lg) <= MODEL_TOL and int(state["index"]) == 1
    params, opt = init_train_state(cfg_t, mesh=one_rank_mesh, device="cpu")
    ref, ref_opt = init_train_state(cfg_t, device="cpu")
    m = make_train_step(cfg_t, mesh=one_rank_mesh)(params, opt, batch)
    m_ref = make_train_step(cfg_t)(ref, ref_opt, batch)
    assert float(m["loss"]) == pytest.approx(float(m_ref["loss"]), rel=1e-6)
    for build in (make_paged_decode_step, make_paged_prefill_step):
        with pytest.raises(NotImplementedError, match="encoder-decoder"):
            build(cfg_t, mesh=one_rank_mesh)


def test_training_and_decoder_only_setup_raise_naming_encdec():
    """The decoder-only builder still refuses an encoder-decoder, naming
    where it is built and trained; the training state is now
    ``init_encdec``'s (the refusal this test asserted before the training
    slice is lifted)."""
    _, cfg_t = _cfgs()
    with pytest.raises(NotImplementedError, match="encoder-decoder.*"
                       "encdec_loss"):
        build_stacks(cfg_t)
    params, opt = init_train_state(cfg_t, device="cpu")
    assert isinstance(params, EncDec)
    assert len(opt["master"]) == len(list(params.parameters()))


@pytest.mark.parametrize("engine", ["paged", "dense"])
def test_serve_cli_raises_for_whisper(engine):
    with pytest.raises(NotImplementedError, match="make_serve_step"):
        serve_mod.main(["--arch", ARCH, "--engine", engine, "--device",
                        "cpu", "--requests", "2", "--max-new", "2"])
    _, cfg_t = _cfgs()
    with pytest.raises(NotImplementedError, match="make_serve_step"):
        serve_mod.serve(cfg_t, [serve_mod.Request(0, [1, 2], 2)], 2, 16,
                        device="cpu")


def test_reference_serve_does_not_serve_whisper():
    """A fact about the reference: JAX ``serve`` on whisper-medium builds
    ``init_lm``'s decoder-only tree (embed, final_norm, stacks) and hands
    it to ``make_serve_step``, whose shardings are the enc-dec tree's, so
    it fails with a ValueError on the mismatch; JAX ``serve_paged`` refuses
    the arch with NotImplementedError.  The port's ``serve`` raises
    NotImplementedError on both engines (above)."""
    cfg_j, _ = _cfgs()
    with pytest.raises(ValueError, match="enc_blocks"):
        jax_serve(cfg_j, [JaxRequest(0, [1, 2], 2)], 2, 16, verbose=False)
    ecfg = JaxEngineConfig(page_size=8, n_pages=8, decode_slots=2,
                           max_context=32, prefill_batch=2, prefill_chunk=8)
    with pytest.raises(NotImplementedError, match="audio"):
        jax_serve_paged(cfg_j, [JaxRequest(0, [1, 2], 2)], ecfg,
                        verbose=False)


def test_whisper_config_is_the_reference_config():
    want = dataclasses.asdict(jax_get_config(ARCH))
    got = dataclasses.asdict(get_config(ARCH))
    assert want.pop("dtype") is jnp.bfloat16
    assert got.pop("dtype") == torch.bfloat16
    assert got == want
