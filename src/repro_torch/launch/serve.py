"""Serving entry point of the port: the paged continuous-batching engine.

    python -m repro_torch.launch.serve --arch qwen3-4b --no-reduced \\
        --requests 16 --batch 8 --max-new 32

Runs on the CUDA device unless ``--device cpu`` is given.  The JAX
package's ``--engine dense`` reference and ``--plan`` (a searched v3 plan's
serving section) are not ported yet (``ROADMAP.md``).
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.models import init_lm
from repro_torch.models.common import ModelConfig
from repro_torch.serving import (EngineConfig, ServeMetrics, ServeRequest,
                                 ServingEngine)


class Request:
    def __init__(self, rid: int, prompt: List[int], max_new: int):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.generated: List[int] = []
        self.done = False


def serve_paged(cfg: ModelConfig, requests: List[Request],
                ecfg: EngineConfig, *, seed: int = 0, verbose: bool = True,
                device: torch.device = "cuda") -> ServeMetrics:
    """Continuous-batching serve over the paged KV cache with random
    weights from ``seed``.

    Returns the engine's :class:`~repro_torch.serving.ServeMetrics`;
    generated tokens are written back into each :class:`Request`."""
    params = init_lm(cfg, seed=seed, device=device)
    engine = ServingEngine(cfg, params, ecfg, device=device)
    sreqs = [ServeRequest(rid=str(r.rid), prompt=list(r.prompt),
                          max_new=r.max_new) for r in requests]
    metrics = engine.run(sreqs, verbose=False)
    for r, s in zip(requests, sreqs):
        r.generated = list(s.tokens)
        r.done = s.done
    if verbose:
        summ = metrics.summary()
        print(f"served {summ['completed']} requests, {summ['new_tokens']} "
              f"tokens in {summ['wall_s']:.2f}s "
              f"({summ['tok_per_s']:.1f} tok/s, "
              f"{summ['decode_steps']} decode steps, "
              f"{summ['prefill_chunks']} prefill chunks, "
              f"peak page occupancy {summ['page_occupancy_max']:.2f})")
    return metrics


def engine_config_from_args(args: argparse.Namespace) -> EngineConfig:
    """The paged-engine geometry from the CLI flags (0 = default)."""
    context = args.context or 128
    batch = args.batch or 4
    page_size = args.page_size or 16
    context = -(-context // page_size) * page_size   # round up to pages
    return EngineConfig(
        page_size=page_size,
        n_pages=args.pages or (batch * (context // page_size)),
        decode_slots=batch,
        max_context=context,
        prefill_batch=min(4, batch),
        prefill_chunk=args.prefill_chunk or min(32, context),
        eos_id=args.eos_id)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        prog="serve.py",
        description="Serve synthetic requests with the paged "
                    "continuous-batching engine (PyTorch port).")
    ap.add_argument("--arch", choices=list_archs(), default="qwen3-4b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="shrink the model for local runs "
                         "(--no-reduced serves the full config)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=0,
                    help="decode lanes (0 = default 4)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--context", type=int, default=0,
                    help="per-lane context cap (0 = default 128)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="tokens per KV page (0 = default 16)")
    ap.add_argument("--pages", type=int, default=0,
                    help="shared pool pages per layer (0 = lanes x context)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="prompt tokens per prefill call (0 = default 32)")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rng = np.random.default_rng(args.seed)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=4).tolist(),
                    args.max_new) for i in range(args.requests)]
    serve_paged(cfg, reqs, engine_config_from_args(args), seed=args.seed,
                device=args.device)
    for r in reqs[:3]:
        print(f"req {r.rid}: prompt={r.prompt} -> {r.generated[:8]}...")


if __name__ == "__main__":
    main()
