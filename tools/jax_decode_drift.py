#!/usr/bin/env python3
"""How far the JAX package's decode drifts from its prefill with depth.

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/jax_decode_drift.py \\
        --arch mamba2-370m --layers 1,12,48 --tokens 32

For each depth, random weights from ``init_lm(PRNGKey(0))`` at the arch's
full width, 2 lanes of random tokens: ``decode_step`` logits at every
position against ``lm_forward`` logits on the same tokens, as max |diff| /
max |logit| per position (worst and mean), in fp32 and bf16.  This is the
reference's own distance, the yardstick for the port's (``chip_smoke.py``
phase 12, which prints the same measure on the card).
"""
import argparse
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_config
from repro.models import decode_step, init_decode_state, init_lm, lm_forward


def drift(arch: str, layers: int, tokens: int, dtype) -> tuple:
    cfg = get_config(arch).with_(dtype=dtype, n_layers=layers)
    params = init_lm(jax.random.PRNGKey(0), cfg)
    toks = jax.random.randint(jax.random.PRNGKey(3), (2, tokens), 0,
                              cfg.vocab_size)
    full, _ = jax.jit(lambda p, t: lm_forward(p, t, cfg))(params, toks)
    full = np.asarray(full.astype(jnp.float32))
    step = jax.jit(lambda p, s, t: decode_step(p, s, t, cfg))
    state = init_decode_state(cfg, 2, tokens)
    errs = []
    for t in range(tokens):
        logits, state = step(params, state, toks[:, t])
        got, want = np.asarray(logits.astype(jnp.float32)), full[:, t]
        errs.append(np.abs(got - want).max() / np.abs(want).max())
    return max(errs), float(np.mean(errs))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-370m")
    ap.add_argument("--layers", default="1,12,48",
                    help="comma-separated depths")
    ap.add_argument("--tokens", type=int, default=32)
    args = ap.parse_args()
    for layers in map(int, args.layers.split(",")):
        for name, dtype in (("float32", jnp.float32),
                            ("bfloat16", jnp.bfloat16)):
            t0 = time.perf_counter()
            worst, mean = drift(args.arch, layers, args.tokens, dtype)
            print(f"{args.arch} layers {layers:3d} {name:8s}: decode vs "
                  f"lm_forward, max |diff| / max |logit|: worst {worst:.3e}, "
                  f"mean {mean:.3e} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)


if __name__ == "__main__":
    main()
