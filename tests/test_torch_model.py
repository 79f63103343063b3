"""The port's paged prefill and decode against the JAX package's.

Reduced qwen3-4b weights come from JAX ``init_lm`` and are bridged into the
port (``repro_torch.bridge.params_from_jax``); both sides then run two
prefill chunks (base 0 and base 8) and one decode step on the same pools,
page rows, lengths and tokens.  Compared: the logits of live lanes (a
padding lane with prompt_len 0 and an inactive decode lane attend to no key:
the port gives zeros there, the JAX path a uniform average, and nothing
reads them) and the pool rows after every step.

fp32 tolerances: logits 1e-4, pool rows 1e-5 (the same arithmetic in
another order).  bf16: logits 0.1 and pool rows 0.05 — the two frameworks
round matmul outputs and activations to bf16 at different places, so
differences of a few bf16 ulps (1/128 relative) build up over the layers.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models.transformer import init_lm as jax_init_lm
from repro.models.transformer import init_paged_state as jax_init_paged_state
from repro.models.transformer import paged_decode_step as jax_decode
from repro.models.transformer import paged_prefill_step as jax_prefill
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_config
from repro_torch.models import (init_paged_state, paged_decode_step,
                                paged_prefill_step)

torch.set_num_threads(1)

N_PAGES, PSZ, CHUNK = 16, 4, 8
# lane 0: 13-token prompt over scattered pages; lane 1: 6 tokens; lane 2:
# padding.  Lane 0's fourth page holds decode position 13.
PAGE_ROWS = np.array([[7, 2, 11, 4, -1, -1],
                      [0, 9, -1, -1, -1, -1],
                      [-1] * 6], np.int32)
PROMPT_LEN = np.array([13, 6, 0], np.int32)
LIVE = [0, 1]


def test_port_config_matches_jax_config():
    for reduce in (False, True):
        cj, ct = jax_get_config("qwen3-4b"), get_config("qwen3-4b")
        if reduce:
            cj, ct = cj.reduced(), ct.reduced()
        aj, at = dataclasses.asdict(cj), dataclasses.asdict(ct)
        assert str(aj.pop("dtype").__name__) == str(at.pop("dtype")).split(".")[-1]
        assert aj == at
        assert (cj.dh, cj.q_dim, cj.kv_dim) == (ct.dh, ct.q_dim, ct.kv_dim)


def _run_both(dtype: str):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    cfg_j = jax_get_config("qwen3-4b").reduced().with_(dtype=jdt)
    cfg_t = get_config("qwen3-4b").reduced().with_(dtype=tdt)
    params_j = jax.jit(lambda k: jax_init_lm(k, cfg_j))(jax.random.PRNGKey(0))
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    pools_j = jax_init_paged_state(cfg_j, N_PAGES, PSZ)
    pools_t = init_paged_state(cfg_t, N_PAGES, PSZ, device="cpu")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg_t.vocab_size, (3, 2 * CHUNK), np.int32)
    steps = []

    def record(logits_j, logits_t):
        steps.append((np.asarray(logits_j.astype(jnp.float32)),
                      logits_t.float().numpy(),
                      [np.asarray(pools_j["stacks"][0][n].astype(jnp.float32))
                       for n in ("k", "v")],
                      [np.stack([p[n][:N_PAGES].float().numpy()
                                 for p in pools_t]) for n in ("k", "v")]))

    prefill_j = jax.jit(lambda p, pl, t, r, b, n: jax_prefill(
        p, pl, t, r, b, n, cfg_j))
    for base in (0, CHUNK):
        toks = prompts[:, base:base + CHUNK]
        lj, pools_j = prefill_j(params_j, pools_j, jnp.asarray(toks),
                                jnp.asarray(PAGE_ROWS), jnp.int32(base),
                                jnp.asarray(PROMPT_LEN))
        with torch.inference_mode():
            lt = paged_prefill_step(params_t, pools_t, torch.from_numpy(toks),
                                    torch.from_numpy(PAGE_ROWS), base,
                                    torch.from_numpy(PROMPT_LEN), cfg_t)
        record(lj, lt)
    token = rng.integers(0, cfg_t.vocab_size, 3, np.int32)
    lengths = np.array([13, 6, -1], np.int32)
    lj, pools_j = jax.jit(lambda p, pl, t, r, n: jax_decode(
        p, pl, t, r, n, cfg_j))(params_j, pools_j, jnp.asarray(token),
                                jnp.asarray(PAGE_ROWS), jnp.asarray(lengths))
    with torch.inference_mode():
        lt = paged_decode_step(params_t, pools_t, torch.from_numpy(token),
                               torch.from_numpy(PAGE_ROWS),
                               torch.from_numpy(lengths), cfg_t)
    record(lj, lt)
    return params_j, params_t, steps


@pytest.mark.parametrize("dtype,logit_tol,pool_tol",
                         [("float32", 1e-4, 1e-5), ("bfloat16", 0.1, 0.05)])
def test_paged_prefill_and_decode_match_jax(dtype, logit_tol, pool_tol):
    _, _, steps = _run_both(dtype)
    for i, (lj, lt, pj, pt) in enumerate(steps):
        assert np.all(np.isfinite(lt[LIVE]))
        np.testing.assert_allclose(lt[LIVE], lj[LIVE], atol=logit_tol,
                                   rtol=0, err_msg=f"logits, step {i}")
        for a, b in zip(pj, pt):
            np.testing.assert_allclose(b, a, atol=pool_tol, rtol=0,
                                       err_msg=f"pools, step {i}")
    # the rows the three steps wrote: 13 + 6 prompt tokens, 2 decode tokens
    assert np.count_nonzero(np.abs(steps[-1][3][0][0]).sum(-1).sum(-1)) == 21
    if dtype == "float32":    # the decode step's greedy tokens agree
        assert (steps[-1][0][LIVE].argmax(-1)
                == steps[-1][1][LIVE].argmax(-1)).all()


def test_bridge_moves_bf16_bits_exactly():
    cfg_j = jax_get_config("qwen3-4b").reduced()
    params_j = jax.tree.map(np.asarray, jax_init_lm(jax.random.PRNGKey(1),
                                                    cfg_j))
    params_t = params_from_jax(params_j, get_config("qwen3-4b").reduced(),
                               device="cpu")
    stack = params_j["stacks"][0]
    pairs = [(params_j["embed"], params_t.embed),
             (params_j["head"], params_t.head),
             (stack["attn"]["wq"][1], params_t.blocks[1].attn.wq),
             (stack["attn"]["k_norm"][0], params_t.blocks[0].attn.k_norm),
             (stack["mlp"]["w_down"][1], params_t.blocks[1].mlp.w_down)]
    for a, t in pairs:
        assert t.dtype == torch.bfloat16
        np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                      a.view(np.int16))
    n_port = sum(p.numel() for p in params_t.parameters())
    assert n_port == sum(a.size for a in jax.tree.leaves(params_j))
