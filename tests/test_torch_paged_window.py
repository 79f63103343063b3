"""The port's paged prefill and decode with a sliding window, against the
JAX package's.

Reduced fp32 qwen3-4b weights come from JAX ``init_lm`` and are bridged
into the port; both sides run two prefill chunks (base 0 and base 8) and one
decode step on the same pools, page rows, lengths and tokens, with the
config's ``sliding_window`` set.  Each lane has 6 pages of 4 rows, so the
gathered view of the pool holds T = 24 keys.  A window of 8 masks keys
inside the context; a window of 32 is longer than T and masks nothing, as
it does in the JAX path, whose mask is built in jnp (the flash kernel
refuses a window longer than its keys, so the port passes it on as full
attention).

Compared: the logits of live lanes and the pool rows after every step, to
1e-5 of each one's largest magnitude (the same fp32 arithmetic in another
order).  A padding lane (prompt_len 0) and an inactive decode lane attend
to no key; the port gives zeros there and nothing reads them.
"""
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
# 6 pages of 4 per lane: T = 24.  Lane 0: 13-token prompt over scattered
# pages, decoding at position 13; lane 1: 6 tokens; lane 2: padding.
PAGE_ROWS = np.array([[7, 2, 11, 4, -1, -1],
                      [0, 9, -1, -1, -1, -1],
                      [-1] * 6], np.int32)
T = PAGE_ROWS.shape[1] * PSZ
PROMPT_LEN = np.array([13, 6, 0], np.int32)
LIVE = [0, 1]
REL_TOL = 1e-5


def _assert_close(got, want, what):
    tol = REL_TOL * max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, atol=tol, rtol=0, err_msg=what)


@pytest.mark.parametrize("window", [8, 32])
def test_paged_window_matches_jax(window):
    cfg_j = jax_get_config("qwen3-4b").reduced().with_(
        dtype=jnp.float32, sliding_window=window)
    cfg_t = get_config("qwen3-4b").reduced().with_(
        dtype=torch.float32, sliding_window=window)
    assert cfg_t.sliding_window == window and (window > T) == (window == 32)
    params_j = jax.jit(lambda k: jax_init_lm(k, cfg_j))(jax.random.PRNGKey(0))
    params_t = params_from_jax(jax.tree.map(np.asarray, params_j), cfg_t,
                               device="cpu")
    pools_j = jax_init_paged_state(cfg_j, N_PAGES, PSZ)
    pools_t = init_paged_state(cfg_t, N_PAGES, PSZ, device="cpu")
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg_t.vocab_size, (3, 2 * CHUNK), np.int32)

    def check(step, logits_j, logits_t):
        lt = logits_t.numpy()[LIVE]
        assert np.all(np.isfinite(lt))
        _assert_close(lt, np.asarray(logits_j)[LIVE], f"logits, {step}")
        for n in ("k", "v"):
            pj = np.asarray(pools_j["stacks"][0][n])
            pt = np.stack([p[n][:N_PAGES].numpy() for p in pools_t])
            _assert_close(pt, pj, f"pool {n}, {step}")

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
        check(f"prefill base {base}", lj, lt)
    token = rng.integers(0, cfg_t.vocab_size, 3, np.int32)
    lengths = np.array([13, 6, -1], np.int32)
    lj, pools_j = jax.jit(lambda p, pl, t, r, n: jax_decode(
        p, pl, t, r, n, cfg_j))(params_j, pools_j, jnp.asarray(token),
                                jnp.asarray(PAGE_ROWS), jnp.asarray(lengths))
    with torch.inference_mode():
        lt = paged_decode_step(params_t, pools_t, torch.from_numpy(token),
                               torch.from_numpy(PAGE_ROWS),
                               torch.from_numpy(lengths), cfg_t)
    check("decode", lj, lt)
