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

    python -m repro_torch.launch.serve --plan plan.json --no-reduced \\
        --requests 8 --batch 8 --max-new 16

Runs on the CUDA device unless ``--device cpu`` is given.  ``--plan`` sizes
the paged engine from a searched v3 plan's serving section (``search
--slo-sweep``), verified on load; flags override its fields where set, as
in the JAX driver (:func:`engine_config_from_args`).

``--ranks N`` (default: the CUDA devices; 1 with ``--device cpu``) above 1
serves on N gloo ranks, as the JAX drivers serve on every local device:
``make_local_mesh()``, ``("data" N, "model" 1)``, with the reference's
``ShardPolicy(tp=False, zero=False)``.  The ranks are spawned as ``train
--ranks`` spawns them (a ``file://`` rendezvous in a temporary directory;
ranks share cards round-robin); the dense engine's lanes split over
``data``, the paged engine runs every lane on every rank.  Rank 0 prints
the summary; every rank must generate the same tokens.

    python -m repro_torch.launch.serve --ranks 4 --engine dense \
        --arch qwen3-4b --no-reduced --requests 16 --batch 8
"""
from __future__ import annotations

import argparse
import json
import pathlib
import tempfile
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.configs import get_config, list_archs
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import join_rank, make_local_mesh, run_ranks
from repro_torch.models import LM, init_decode_state, reset_decode_lane
from repro_torch.models.common import ModelConfig
from repro_torch.runtime.executor import (SERVING_POLICY, init_serving_params,
                                          make_serve_step)
from repro_torch.runtime.sharding import ShardPolicy, check_shardable
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
          params: Optional[LM] = None, mesh: Optional[DeviceMesh] = None,
          policy: Optional[ShardPolicy] = None) -> List[Request]:
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
    Generated tokens are written into each request.

    With a ``mesh``, every rank of it calls ``serve`` with the same
    requests: the step is sharded under ``policy`` (``make_serve_step``;
    ``params``, if given, the rank's shards from ``init_serving_params``)
    and every rank takes the same tokens."""
    dev = resolve_device(device)
    step = make_serve_step(cfg, mesh=mesh, policy=policy)
    if params is None:
        params = init_serving_params(cfg, mesh=mesh, policy=policy,
                                     seed=seed, device=dev)
    elif params.embed.device != dev:
        raise ValueError(f"params lie on {params.embed.device}, serve runs "
                         f"on {dev}")
    gen = None if greedy else torch.Generator(device=dev).manual_seed(seed)
    with torch.inference_mode():
        state = init_decode_state(cfg, batch, context, device=dev,
                                  shard=step.shard)
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
                device: torch.device = "cuda",
                mesh: Optional[DeviceMesh] = None,
                policy: Optional[ShardPolicy] = None) -> ServeMetrics:
    """Continuous-batching serve over the paged KV cache with random
    weights from ``seed`` (on a ``mesh``, each rank's shards under
    ``policy``: :class:`~repro_torch.serving.ServingEngine`).

    Returns the engine's :class:`~repro_torch.serving.ServeMetrics`;
    generated tokens are written back into each :class:`Request`."""
    params = init_serving_params(cfg, mesh=mesh, policy=policy, seed=seed,
                                 device=device)
    engine = ServingEngine(cfg, params, ecfg, device=device, mesh=mesh,
                           policy=policy)
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
    """Resolve the paged-engine geometry: ``--plan``'s serving section when
    given, CLI flags otherwise (flags override plan fields when set; 0 =
    default)."""
    page_size, n_pages = args.page_size, args.pages
    batch, context = args.batch, args.context
    prefill_chunk, eos = args.prefill_chunk, args.eos_id
    if args.plan:
        from repro_torch.analysis import load_plan_file
        plan, _ = load_plan_file(args.plan)
        sv = plan.serving
        if sv is None:
            raise SystemExit(
                f"{args.plan}: plan has no serving section (a v3 serving "
                "plan comes from `search --slo-sweep`)")
        page_size = sv.page_size
        context = min(sv.max_context, context) if context else sv.max_context
        batch = min(sv.decode_batch, batch) if batch else sv.decode_batch
        prefill_chunk = prefill_chunk or sv.prefill_chunk
        n_pages = n_pages or sv.kv_pool_pages
    context = context or 128
    batch = batch or 4
    page_size = page_size or 16
    context = -(-context // page_size) * page_size   # round up to pages
    n_pages = n_pages or (batch * (context // page_size))
    return EngineConfig(
        page_size=page_size, n_pages=n_pages, decode_slots=batch,
        max_context=context,
        prefill_batch=min(4, batch),
        prefill_chunk=prefill_chunk or min(32, context),
        eos_id=eos)


def _serve_rank(rank: int, world: int, run_dir: str, cfg: ModelConfig,
                args: argparse.Namespace, reqs: List[Request]) -> None:
    """One rank of ``--ranks``: the engine on ``make_local_mesh()`` under
    the reference's serving policy; rank 0 prints.  Writes the tokens it
    generated to ``run_dir/rank<r>.json``."""
    dev = join_rank(rank, world, run_dir, args.device)
    try:
        mesh = make_local_mesh(device_type=dev.type)
        _run_engine(cfg, args, reqs, dev, verbose=rank == 0, mesh=mesh,
                    policy=SERVING_POLICY)
        peak = (torch.cuda.max_memory_allocated(dev) / 1e9
                if dev.type == "cuda" else None)
        pathlib.Path(run_dir, f"rank{rank}.json").write_text(json.dumps(
            {"tokens": [r.generated for r in reqs], "peak_mem_gb": peak}))
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _run_engine(cfg: ModelConfig, args: argparse.Namespace,
                reqs: List[Request], device, **kw) -> None:
    if args.engine == "paged":
        serve_paged(cfg, reqs, engine_config_from_args(args), seed=args.seed,
                    device=device, **kw)
    else:
        serve(cfg, reqs, args.batch or 4, args.context or 128,
              eos_id=args.eos_id, seed=args.seed, device=device, **kw)


def serve_ranks(cfg: ModelConfig, args: argparse.Namespace,
                reqs: List[Request], n_ranks: int) -> List[Request]:
    """``--ranks``: serve ``reqs`` on ``n_ranks`` spawned gloo ranks
    (:func:`_serve_rank`); rank 0's tokens are written into ``reqs``.
    Raises RuntimeError when a rank fails or the ranks' tokens differ, and
    NotImplementedError for a MoE model (``check_shardable``)."""
    check_shardable(cfg)
    print(f"serving on {n_ranks} ranks: mesh={{'data': {n_ranks}, "
          f"'model': 1}}, policy={SERVING_POLICY}",
          flush=True)
    with tempfile.TemporaryDirectory(prefix="repro_torch_serve_") as d:
        run_ranks(_serve_rank, (n_ranks, d, cfg, args, reqs), n_ranks)
        ranks = [json.loads(pathlib.Path(d, f"rank{r}.json").read_text())
                 for r in range(n_ranks)]
    if any(r["tokens"] != ranks[0]["tokens"] for r in ranks):
        raise RuntimeError("the ranks generated different tokens")
    for r, toks in zip(reqs, ranks[0]["tokens"]):
        r.generated, r.done = toks, True
    if ranks[0]["peak_mem_gb"] is not None:
        print("peak memory by rank (GB): "
              f"{[round(r['peak_mem_gb'], 3) for r in ranks]}")
    return reqs


def parse_args(argv=None) -> argparse.Namespace:
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
    ap.add_argument("--plan", default=None, metavar="PLAN.json",
                    help="drive the paged engine from a searched v3 plan's "
                         "serving section (verified load)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=0,
                    help="decode lanes (0 = from plan, default 4)")
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--context", type=int, default=0,
                    help="per-lane context cap (0 = from plan, default 128)")
    ap.add_argument("--page-size", type=int, default=0,
                    help="paged engine: tokens per KV page (0 = from plan, "
                         "default 16)")
    ap.add_argument("--pages", type=int, default=0,
                    help="paged engine: shared pool pages per layer "
                         "(0 = from plan, lanes x context)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="paged engine: prompt tokens per prefill call "
                         "(0 = from plan, default 32)")
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to serve on (default: the CUDA devices; 1 "
                         "with --device cpu): above 1, the engine on "
                         "make_local_mesh() over that many gloo ranks")
    return ap.parse_args(argv)


def synthetic_requests(cfg: ModelConfig,
                       args: argparse.Namespace) -> List[Request]:
    """The CLI's requests: ``args.requests`` prompts of 4 tokens drawn
    from ``args.seed``, ``args.max_new`` new tokens each."""
    rng = np.random.default_rng(args.seed)
    return [Request(i, rng.integers(0, cfg.vocab_size, size=4).tolist(),
                    args.max_new) for i in range(args.requests)]


def main(argv=None) -> List[Request]:
    args = parse_args(argv)
    cfg = get_config(args.arch)
    if args.reduced:
        cfg = cfg.reduced()
    reqs = synthetic_requests(cfg, args)
    dev = resolve_device(args.device)
    n_ranks = args.ranks or (torch.cuda.device_count()
                             if dev.type == "cuda" else 1)
    if n_ranks > 1:
        serve_ranks(cfg, args, reqs, n_ranks)
    else:
        _run_engine(cfg, args, reqs, args.device)
    for r in reqs[:3]:
        print(f"req {r.rid}: prompt={r.prompt} -> {r.generated[:8]}...")
    return reqs


if __name__ == "__main__":
    main()
