"""Training entry point of the port: a Galvatron-BMW plan, searched or
loaded, then training of a dense, MoE, SSM or hybrid model on synthetic or
byte-level text batches, on one device, sharded over ranks, or through the
pipeline runtime; or of the encoder-decoder (whisper-medium) on one
device or sharded, its batches carrying the synthetic stream's random
frames; or of the VLM (internvl2-26b) on one device or sharded, its
batches carrying the synthetic stream's random vision patches.

    python -m repro_torch.launch.train --arch mamba2-370m \\
        --steps 10 --batch 8 --seq 2048
    python -m repro_torch.launch.train --plan plan.json --layers 28 \\
        --seq 4096 --batch 2 --steps 3 --lr 3e-5
    python -m repro_torch.launch.train --device cpu --reduced \\
        --arch qwen3-4b --steps 5 --ckpt-dir ckpt --ckpt-every 5
    python -m repro_torch.launch.train --pipeline --ranks 4 \\
        --plan plan.json --layers 16 --seq 4096 --batch 4 --steps 3
    python -m repro_torch.launch.train --ranks 4 --plan plan.json \\
        --layers 8 --seq 4096 --batch 4 --steps 3
    python -m repro_torch.launch.train --arch whisper-medium --batch 8 \\
        --seq 448 --steps 3
    python -m repro_torch.launch.train --arch internvl2-26b --layers 6 \\
        --batch 1 --seq 4096 --steps 3

Runs on the CUDA device unless ``--device cpu`` is given.  The weights are
random from seed 0.  As in the JAX driver, the plan comes from ``--plan``
(verified on load; ``--strict`` rejects deprecated v0/v1 files) or from the
paper's search (:func:`search_plan`, on the 64-GPU H100 preset), and
``--plan-out`` writes it.  The driver takes remat from the plan as the JAX
driver does (:func:`remat_from_plan`).  ``--ckpt-dir`` saves the model and
AdamW state every ``--ckpt-every`` steps in the JAX package's layout
(``checkpointing/store.py``), on one device or gathered from the ranks of
``--ranks`` (``save_sharded_train_state``); as in the JAX driver, nothing
resumes from them, and ``--pipeline`` saves none.

With ``--ranks N`` above 1 (default: the CUDA devices) the plan is applied
as the JAX driver applies it (:func:`run_sharded`): the policy of its
middle strategy (``ShardPolicy.from_strategy``, remat from the first) on
``make_local_mesh()``, ``("data" N, "model" 1)``, over N gloo ranks that
the driver starts itself; each rank draws its shards of ``init_lm(cfg,
seed=0)`` and trains on its rows of the same batches.  With one rank the
model trains on one device and the plan's sharding degrees and micro-batch
count are printed, not applied.  An encoder-decoder takes ``--ranks``
too (each rank draws its shards of ``init_encdec(cfg, seed=0)``; the
batches carry ``frames``), while ``--pipeline`` raises the pipeline
runtime's ValueError (one homogeneous stack), as the reference asserts.
So does a VLM: ``--ranks`` trains it on its rows of the batches with
their ``patches``, and ``--pipeline`` raises (the pipeline's loss reads
tokens only).

``--pipeline`` executes the plan's searched schedule through the pipeline
runtime (``runtime/pipeline.py``), scaled down by the JAX driver's rules
(:func:`pipeline_layout`) to what ``--ranks`` ranks (default: the CUDA
devices) and the layer count support.  It starts the ranks itself
(``torch.multiprocessing`` spawn, a ``file://`` rendezvous in a temporary
directory, gloo); with fewer cards than ranks, ranks share cards.  Each rank
draws its own stage of ``init_lm(cfg, seed=0)`` (:func:`init_stage`) and
never holds the whole model.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import pathlib
import tempfile
import time
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.specs import layerspecs_for
from repro_torch.core import (ClusterSpec, GalvatronOptimizer, ParallelPlan,
                              galvatron_variant, h100_cluster)
from repro_torch.data import (DataConfig, synthetic_lm_batches,
                              text_corpus_batches)
from repro_torch.checkpointing import (save_sharded_train_state,
                                       save_train_state)
from repro_torch.device import resolve_device
from repro_torch.launch.mesh import join_rank
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import build_stacks
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.executor import (abstract_params, init_train_state,
                                          make_train_step)
from repro_torch.runtime.sharding import ShardPolicy


def search_plan(cfg: ModelConfig, seq_len: int, n_devices: int = 64, *,
                cluster: Optional[ClusterSpec] = None,
                batch_grid: Sequence[int] = (64, 128, 256),
                profiled_times: Optional[Dict[str, float]] = None
                ) -> ParallelPlan:
    """The JAX driver's search (``repro/launch/train.py::search_plan``):
    the same ``bmw`` settings and schedules, on ``cluster`` (default
    :func:`~repro_torch.core.hardware.h100_cluster` of ``n_devices``) over
    ``batch_grid`` (default the JAX driver's), priced with
    ``profiled_times`` ({layer name: s/sample},
    ``core/profiler.py::profile_layerspecs``) where given."""
    specs = layerspecs_for(cfg, seq_len)
    ocfg = galvatron_variant("bmw")
    ocfg.batch_grid = list(batch_grid)
    ocfg.n_bins = 96
    ocfg.micro_candidates = 2
    ocfg.max_pp = 4
    # the schedule is a searched dimension: plain 1F1B vs interleaved
    # virtual stages vs zero-bubble ZB-H1
    ocfg.schedules = ("1f1b", "1f1b-interleaved", "zb-h1")
    ocfg.vpp_candidates = (2,)
    plan = GalvatronOptimizer(specs, cluster or h100_cluster(n_devices),
                              ocfg, profiled_times=profiled_times).optimize()
    if plan is None:
        raise RuntimeError("no feasible plan")
    return plan


def plan_from_args(cfg: ModelConfig, args: argparse.Namespace
                   ) -> ParallelPlan:
    """``--plan`` verified on load, else a fresh :func:`search_plan`;
    printed, and written to ``--plan-out`` when given."""
    if args.plan:
        from repro_torch.analysis import load_plan_file
        plan, report = load_plan_file(args.plan, strict=args.strict)
        for d in report.warnings():
            print(d.format())
        print(f"loaded plan {args.plan} (verified: "
              f"{len(report.warnings())} warning(s))")
    else:
        plan = search_plan(cfg, args.seq)
    print("plan:", plan.summary())
    print(f"schedule: {plan.schedule} vpp={plan.vpp_degree} "
          f"m={plan.n_micro}")
    if args.plan_out:
        pathlib.Path(args.plan_out).write_text(plan.dumps())
    return plan


def remat_from_plan(plan: ParallelPlan) -> List[bool]:
    """``remat_segments`` as the JAX driver takes it from a plan: the first
    strategy's (the embed layer's) ``ckpt``, one entry, which covers every
    segment (``lm_loss`` repeats the last entry)."""
    return [s.ckpt for s in plan.strategies[:1]]


def config_from_args(args: argparse.Namespace) -> ModelConfig:
    """The model config with the JAX driver's ``--reduced`` / ``--layers`` /
    ``--d-model`` arithmetic."""
    cfg = get_config(args.arch)
    if args.reduced:
        return cfg.reduced(n_layers=args.layers or 2,
                           d_model=args.d_model or 256)
    if args.layers or args.d_model:
        return cfg.with_(n_layers=args.layers or cfg.n_layers,
                         d_model=args.d_model or cfg.d_model)
    return cfg


def batches(cfg: ModelConfig, args: argparse.Namespace):
    """The driver's batches: ``--corpus`` as byte-level text, else the
    synthetic stream of the JAX driver's ``DataConfig``, whose batches for
    an encoder-decoder also carry ``frames`` (B, encoder_seq, d_model), and
    for a VLM ``patches`` (B, vision_tokens, d_vision)."""
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab_size=cfg.vocab_size,
                      vision_tokens=cfg.vision_tokens, d_vision=cfg.d_vision,
                      encoder_seq=cfg.encoder_seq, d_model=cfg.d_model)
    return (text_corpus_batches(args.corpus, dcfg) if args.corpus
            else synthetic_lm_batches(dcfg))


def train(cfg: ModelConfig, args: argparse.Namespace) -> List[Dict[str, float]]:
    """Resolve the plan, then run ``args.steps`` steps; return each step's
    loss, grad norm and lr."""
    dev = resolve_device(args.device)
    plan = plan_from_args(cfg, args)
    remat = remat_from_plan(plan)
    gen = batches(cfg, args)
    opt_cfg = AdamWConfig(lr=args.lr)
    params, opt = init_train_state(cfg, seed=0, opt_cfg=opt_cfg,
                                   device=dev)
    step = make_train_step(cfg, opt_cfg, remat_segments=remat)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"model: {args.arch} ({n_params / 1e6:.1f}M params), "
          f"device={dev}, remat_segments={remat}; the plan's "
          f"{plan.strategies[len(plan.strategies) // 2]} and "
          f"m={plan.n_micro} are not applied on one device")
    history = []
    t0 = time.time()
    tokens_seen = 0
    for i in range(1, args.steps + 1):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in next(gen).items()}
        metrics = step(params, opt, batch)
        tokens_seen += args.batch * args.seq
        history.append({k: float(v) for k, v in metrics.items()})
        if i % args.log_every == 0 or i == args.steps:
            dt = time.time() - t0
            print(f"step {i:5d}  loss={history[-1]['loss']:.4f}  "
                  f"gnorm={history[-1]['grad_norm']:.3f}  "
                  f"tok/s={tokens_seen / dt:,.0f}")
        if args.ckpt_dir and i % args.ckpt_every == 0:
            d = save_train_state(i, params, opt, args.ckpt_dir)
            print(f"  checkpoint -> {d}")
    print("done.")
    return history


# --------------------------------------------------------------------------
# --pipeline: the searched schedule through the pipeline runtime
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PipelineLayout:
    schedule: str
    n_stages: int       # P
    n_chunks: int       # V
    n_micro: int        # m
    n_data: int


def pipeline_layout(plan: ParallelPlan, n_ranks: int, n_layers: int,
                    batch: int) -> PipelineLayout:
    """The JAX driver's degeneration rules (``run_pipeline``), with its
    local devices as ``n_ranks``: P is the largest divisor of the ranks and
    of the layers at most ``min(ranks, plan.pp_degree, L)``; V shrinks
    until ``P·V`` divides L; ``1f1b-interleaved`` with V 1 becomes
    ``1f1b``; ``m = gcd(plan.n_micro, batch)``; the data axis is
    ``gcd(ranks // P, batch // m)`` (spare ranks idle)."""
    P = 1
    for cand in range(min(n_ranks, plan.pp_degree, n_layers), 0, -1):
        if n_ranks % cand == 0 and n_layers % cand == 0:
            P = cand
            break
    sched, V = plan.schedule, plan.vpp_degree
    while V > 1 and n_layers % (P * V):
        V -= 1
    if V == 1 and sched == "1f1b-interleaved":
        sched = "1f1b"          # interleaving degenerated away locally
    m = math.gcd(plan.n_micro, batch)
    n_data = math.gcd(n_ranks // P, batch // m)
    return PipelineLayout(sched, P, V, m, n_data)


def _rank_steps(rank: int, cfg: ModelConfig, args: argparse.Namespace,
                dev: torch.device, step_fn,
                after_step=None) -> List[Dict[str, float]]:
    """``args.steps`` steps of ``step_fn(batch)`` on the driver's batches
    (the global batch as numpy arrays, the same on every rank), each
    timed to a synchronize; rank 0 prints them.  ``after_step(i)`` runs
    after step ``i``'s timing and print."""
    gen = batches(cfg, args)
    history = []
    t0 = time.time()
    tokens_seen = 0
    for step in range(1, args.steps + 1):
        b = next(gen)
        ts = time.perf_counter()
        metrics = step_fn(b)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        history.append({"loss": float(metrics["loss"]),
                        "grad_norm": float(metrics["grad_norm"]),
                        "lr": float(metrics["lr"]),
                        "step_ms": (time.perf_counter() - ts) * 1e3})
        tokens_seen += args.batch * args.seq
        if rank == 0 and (step % args.log_every == 0 or step == args.steps):
            dt = time.time() - t0
            print(f"step {step:5d}  loss={history[-1]['loss']:.4f}  "
                  f"gnorm={history[-1]['grad_norm']:.3f}  "
                  f"tok/s={tokens_seen / dt:,.0f}", flush=True)
        if after_step is not None:
            after_step(step)
    return history


def _rank_done(rank: int, run_dir: str, dev: torch.device,
               history: List[Dict[str, float]], **extra) -> None:
    """Write the rank's history and peak memory to ``run_dir/rank<r>.json``
    and wait for the others."""
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)
    pathlib.Path(run_dir, f"rank{rank}.json").write_text(json.dumps(
        {"history": history, "peak_mem_gb": peak, **extra}))
    dist.barrier()


def _spawn(fn, world: int, args: tuple, dev: torch.device, prefix: str
           ) -> List[Dict[str, float]]:
    """``fn(rank, world, run_dir, *args)`` on ``world`` spawned ranks;
    returns rank 0's history, each step with ``peak_mem_gb_rank<r>`` of
    every rank on a CUDA device.  Raises RuntimeError when a rank fails."""
    from repro_torch.launch.mesh import run_ranks

    with tempfile.TemporaryDirectory(prefix=prefix) as d:
        run_ranks(fn, (world, d, *args), world)
        ranks = [json.loads(pathlib.Path(d, f"rank{r}.json").read_text())
                 for r in range(world)]
    history = ranks[0]["history"]
    if dev.type == "cuda":
        for h in history:
            h.update({f"peak_mem_gb_rank{r}": res["peak_mem_gb"]
                      for r, res in enumerate(ranks)})
    print("done.")
    return history


def _pipeline_rank(rank: int, world: int, run_dir: str, cfg: ModelConfig,
                   layout: PipelineLayout, args: argparse.Namespace) -> None:
    """One rank of :func:`run_pipeline`: its stage, AdamW on its leaves with
    the global grad norm, ``args.steps`` steps; rank 0 prints the steps.
    Writes its history and peak memory to ``run_dir/rank<r>.json``."""
    from repro_torch.launch.mesh import make_pipeline_mesh
    from repro_torch.optim import adamw_init, adamw_update
    from repro_torch.runtime.pipeline import (init_stage, make_pipeline_loss,
                                              pipeline_grad_norm)

    dev = join_rank(rank, world, run_dir, args.device)
    try:
        P, V, m = layout.n_stages, layout.n_chunks, layout.n_micro
        mesh = make_pipeline_mesh(P, layout.n_data, device_type=dev.type)
        i = mesh.get_local_rank("pipe")
        loss_fn = make_pipeline_loss(cfg, mesh, m, schedule=layout.schedule,
                                     n_chunks=V)
        stage = init_stage(cfg, P, V, i, seed=0, device=dev)
        leaves = list(stage.parameters())
        ocfg = AdamWConfig(lr=args.lr)
        opt = adamw_init(leaves, ocfg)

        def step(b):
            batch = {k: torch.from_numpy(v).reshape(m, args.batch // m,
                                                    args.seq)
                     for k, v in b.items()}
            loss, grads = loss_fn(stage, batch)
            gnorm = pipeline_grad_norm(stage, grads, mesh)
            metrics = adamw_update(leaves, grads, opt, ocfg, grad_norm=gnorm)
            return dict(metrics, loss=loss)

        history = _rank_steps(rank, cfg, args, dev, step)
        _rank_done(rank, run_dir, dev, history, stage=i, layers=stage.chunks)
    finally:
        dist.destroy_process_group()


def run_pipeline(cfg: ModelConfig, args: argparse.Namespace
                 ) -> List[Dict[str, float]]:
    """Execute the plan's searched schedule (:func:`plan_from_args`, after
    the one-stack check) through the pipeline runtime on ``args.ranks``
    ranks (scaled down by :func:`pipeline_layout`); returns rank 0's
    history, each step with ``peak_mem_gb_rank<r>`` of every rank on a
    CUDA device.  Raises ValueError for a model of more than one stack,
    RuntimeError when a rank fails."""
    from repro_torch.runtime.pipeline import _check_stack

    dev = resolve_device(args.device)
    n_ranks = args.ranks or (torch.cuda.device_count()
                             if dev.type == "cuda" else 1)
    _check_stack(cfg)
    plan = plan_from_args(cfg, args)
    layout = pipeline_layout(plan, n_ranks, cfg.n_layers, args.batch)
    print(f"pipeline runtime: schedule={layout.schedule} "
          f"P={layout.n_stages} V={layout.n_chunks} m={layout.n_micro} "
          f"(plan asked {plan.schedule} P={plan.pp_degree} "
          f"V={plan.vpp_degree} m={plan.n_micro})")
    world = layout.n_stages * layout.n_data
    print(f"ranks: {world} of {n_ranks} (pipe {layout.n_stages} x data "
          f"{layout.n_data}) on {dev.type}", flush=True)
    return _spawn(_pipeline_rank, world, (cfg, layout, args), dev,
                  "repro_torch_pipeline_")


# --------------------------------------------------------------------------
# --ranks N: the plan's policy through the sharded executor
# --------------------------------------------------------------------------

def middle_strategy_policy(plan: ParallelPlan) -> ShardPolicy:
    """The JAX driver's policy: its middle strategy's DP/SDP/TP choice,
    remat as :func:`remat_from_plan`."""
    return ShardPolicy.from_strategy(
        plan.strategies[len(plan.strategies) // 2],
        remat_segments=remat_from_plan(plan))


def _sharded_rank(rank: int, world: int, run_dir: str, cfg: ModelConfig,
                  policy: ShardPolicy, args: argparse.Namespace) -> None:
    """One rank of :func:`run_sharded`: ``make_local_mesh()``, its shards
    of the model and AdamW state, ``args.steps`` sharded steps; rank 0
    prints the steps.  With ``args.ckpt_dir`` every rank takes part in
    saving the whole state every ``args.ckpt_every`` steps.  Writes its
    history (with the bytes it sent through gloo each step) and peak
    memory to ``run_dir/rank<r>.json``."""
    from repro_torch.launch.mesh import make_local_mesh

    dev = join_rank(rank, world, run_dir, args.device)
    try:
        mesh = make_local_mesh(device_type=dev.type)
        ocfg = AdamWConfig(lr=args.lr)
        params, opt = init_train_state(cfg, mesh=mesh, policy=policy,
                                       seed=0, opt_cfg=ocfg, device=dev)
        step = make_train_step(cfg, ocfg, mesh=mesh, policy=policy)
        sent = []

        def run(b):
            before = step.shard.traffic.bytes_sent
            metrics = step(params, opt,
                           {k: torch.from_numpy(v) for k, v in b.items()})
            sent.append(step.shard.traffic.bytes_sent - before)
            return metrics

        def save(i):
            if args.ckpt_dir and i % args.ckpt_every == 0:
                d = save_sharded_train_state(i, params, opt, step.shard,
                                             args.ckpt_dir)
                if rank == 0:
                    print(f"  checkpoint -> {d}", flush=True)

        history = _rank_steps(rank, cfg, args, dev, run, save)
        for h, n in zip(history, sent):
            h["gloo_bytes_sent"] = n
        _rank_done(rank, run_dir, dev, history)
    finally:
        dist.destroy_process_group()


def run_sharded(cfg: ModelConfig, args: argparse.Namespace, n_ranks: int
                ) -> List[Dict[str, float]]:
    """Train ``args.steps`` steps on ``n_ranks`` gloo ranks, each holding
    its shards under the plan's policy (:func:`plan_from_args`,
    :func:`middle_strategy_policy`) on ``make_local_mesh()``; returns rank
    0's history, each step with ``peak_mem_gb_rank<r>`` of every rank on a
    CUDA device.  An encoder-decoder's batches carry ``frames``.  Raises
    NotImplementedError, before the search, for an arch the port does not
    build, and RuntimeError when a rank fails."""
    dev = resolve_device(args.device)
    if not cfg.is_encoder_decoder:
        build_stacks(cfg)
    policy = middle_strategy_policy(plan_from_args(cfg, args))
    n_params = sum(p.numel() for p in abstract_params(cfg).parameters())
    print(f"model: {args.arch} ({n_params / 1e6:.1f}M params), "
          f"mesh={{'data': {n_ranks}, 'model': 1}} on {dev.type}, "
          f"policy={policy}", flush=True)
    return _spawn(_sharded_rank, n_ranks, (cfg, policy, args), dev,
                  "repro_torch_sharded_")


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="train.py",
        description="Train a model on one device or through the pipeline "
                    "runtime (PyTorch port).")
    ap.add_argument("--arch", choices=list_archs(), default="qwen3-4b")
    ap.add_argument("--reduced", action="store_true",
                    help="shrink the model for local runs")
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--d-model", type=int, default=None)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--corpus", default=None, help="text file (byte-level LM)")
    ap.add_argument("--plan", default=None, metavar="FILE",
                    help="load a searched plan JSON (verified by "
                         "repro_torch.analysis on load) instead of "
                         "re-searching")
    ap.add_argument("--strict", action="store_true",
                    help="reject deprecated v0/v1 --plan files with a "
                         "structured deprecation diagnostic (PLN001)")
    ap.add_argument("--plan-out", default=None)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="save the model and AdamW state here (the JAX "
                         "package's layout)")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--pipeline", action="store_true",
                    help="execute the searched pipeline schedule through "
                         "the pipeline runtime over --ranks ranks instead "
                         "of training on one device")
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks to train on (default: the CUDA devices; 1 "
                         "with --device cpu): the pipeline's with "
                         "--pipeline, else above 1 the plan's policy "
                         "through the sharded executor")
    return ap.parse_args(argv)


def main(argv=None) -> List[Dict[str, float]]:
    args = parse_args(argv)
    cfg = config_from_args(args)
    dev = resolve_device(args.device)
    if args.pipeline:
        return run_pipeline(cfg, args)
    n_ranks = args.ranks or (torch.cuda.device_count()
                             if dev.type == "cuda" else 1)
    if n_ranks > 1:
        return run_sharded(cfg, args, n_ranks)
    return train(cfg, args)


if __name__ == "__main__":
    main()
