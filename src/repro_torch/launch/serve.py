"""Serving entry point of the port.

Two engines behind one CLI, as in the JAX package:

  * ``--engine paged`` (default): the continuous-batching engine over the
    paged KV cache (``repro_torch.serving``).
  * ``--engine dense``: the dense-cache reference, one KV ring buffer per
    lane at full ``--context`` (and one SSM state per lane and layer),
    prompts fed one token per decode step (:func:`serve`).  It is the only
    engine that serves SSM and hybrid models.

    python -m repro_torch.launch.serve --arch qwen3-4b --no-reduced \\
        --requests 16 --batch 8 --max-new 32 [--engine dense]
    python -m repro_torch.launch.serve --engine dense --arch zamba2-1.2b \\
        --no-reduced --requests 16 --batch 8 --context 2048

Runs on the CUDA device unless ``--device cpu`` is given.  The JAX
package's ``--plan`` (a searched v3 plan's serving section) is not ported
yet (``ROADMAP.md``).
"""
from __future__ import annotations

import argparse
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.models import (LM, init_decode_state, init_lm,
                                reset_decode_lane)
from repro_torch.models.common import ModelConfig
from repro_torch.runtime.executor import make_serve_step
from repro_torch.serving import (EngineConfig, ServeMetrics, ServeRequest,
                                 ServingEngine)


class Request:
    def __init__(self, rid: int, prompt: List[int], max_new: int):
        self.rid = rid
        self.prompt = prompt
        self.max_new = max_new
        self.generated: List[int] = []
        self.done = False


def serve(cfg: ModelConfig, requests: List[Request], batch: int,
          context: int, *, eos_id: Optional[int] = None, greedy: bool = True,
          seed: int = 0, verbose: bool = True, device: torch.device = "cuda",
          params: Optional[LM] = None) -> List[Request]:
    """Dense-cache reference: one KV cache an attention call and one SSM
    state an SSM layer (:func:`init_decode_state`), a slot a lane.

    Each lane carries its own cache index, so a recycled slot restarts at
    position 0 and the decode mask hides the previous request's K/V; its
    rows of every SSM state and conv history are zeroed
    (:func:`reset_decode_lane`), so no request reads its predecessor's
    context.  (The JAX ``serve`` resets only the index, and on SSM models a
    recycled lane carries the previous request's state.)  Prompts are fed
    one token a step; a lane stepped idle still advances its index.
    ``params`` defaults to random weights from ``seed`` (:func:`init_lm`);
    non-greedy sampling draws from a generator seeded with ``seed``.
    Generated tokens are written into each request."""
    dev = resolve_device(device)
    step = make_serve_step(cfg)
    if params is None:
        params = init_lm(cfg, seed=seed, device=dev)
    elif params.embed.device != dev:
        raise ValueError(f"params lie on {params.embed.device}, serve runs "
                         f"on {dev}")
    gen = None if greedy else torch.Generator(device=dev).manual_seed(seed)
    with torch.inference_mode():
        state = init_decode_state(cfg, batch, context, device=dev)
        # the shared index -> per-lane positions
        state["index"] = torch.zeros((batch,), dtype=torch.int32, device=dev)
        queue = deque(requests)
        lanes: List[Optional[Request]] = [None] * batch
        cursor = [0] * batch                  # next prompt position per lane
        tok = np.zeros((batch,), np.int32)
        n_steps = 0
        t0 = time.perf_counter()
        while queue or any(lane is not None for lane in lanes):
            for i in range(batch):
                if lanes[i] is None and queue:
                    r = queue.popleft()
                    lanes[i] = r
                    cursor[i] = 1
                    tok[i] = r.prompt[0]
                    reset_decode_lane(state, i)
            logits, state = step(params, state, torch.tensor(tok, device=dev))
            n_steps += 1
            if greedy:
                nxt = logits.argmax(-1).cpu().numpy()
            else:
                probs = torch.softmax(logits.float(), -1)
                nxt = torch.multinomial(probs, 1, generator=gen)[:, 0]
                nxt = nxt.cpu().numpy()
            for i in range(batch):
                r = lanes[i]
                if r is None:
                    continue
                if cursor[i] < len(r.prompt):     # still feeding the prompt
                    tok[i] = r.prompt[cursor[i]]
                    cursor[i] += 1
                    continue
                t = int(nxt[i])
                r.generated.append(t)
                tok[i] = t
                if (eos_id is not None and t == eos_id) or \
                        len(r.generated) >= r.max_new:
                    r.done = True
                    lanes[i] = None
        dt = time.perf_counter() - t0
    if verbose:
        total_new = sum(len(r.generated) for r in requests)
        print(f"served {len(requests)} requests, {total_new} tokens in "
              f"{dt:.2f}s ({total_new / dt:.1f} tok/s, {n_steps} steps)")
    return requests


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
                    "continuous-batching engine or the dense reference "
                    "(PyTorch port).")
    ap.add_argument("--arch", choices=list_archs(), default="qwen3-4b")
    ap.add_argument("--reduced", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="shrink the model for local runs "
                         "(--no-reduced serves the full config)")
    ap.add_argument("--engine", choices=("paged", "dense"), default="paged")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default cuda)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=0,
                    help="decode lanes (0 = default 4)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--context", type=int, default=0,
                    help="per-lane context cap (0 = default 128)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged engine: tokens per KV page (0 = default 16)")
    ap.add_argument("--pages", type=int, default=0,
                    help="paged engine: shared pool pages per layer "
                         "(0 = lanes x context)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="paged engine: prompt tokens per prefill call "
                         "(0 = default 32)")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    rng = np.random.default_rng(args.seed)
    reqs = [Request(i, rng.integers(0, cfg.vocab_size, size=4).tolist(),
                    args.max_new) for i in range(args.requests)]
    if args.engine == "paged":
        serve_paged(cfg, reqs, engine_config_from_args(args), seed=args.seed,
                    device=args.device)
    else:
        serve(cfg, reqs, args.batch or 4, args.context or 128,
              eos_id=args.eos_id, seed=args.seed, device=args.device)
    for r in reqs[:3]:
        print(f"req {r.rid}: prompt={r.prompt} -> {r.generated[:8]}...")


if __name__ == "__main__":
    main()
