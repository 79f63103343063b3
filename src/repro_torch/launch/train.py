"""Training entry point of the port: a Galvatron-BMW plan, searched or
loaded, then single-device training of a dense or SSM model on synthetic or
byte-level text batches.

    python -m repro_torch.launch.train --arch mamba2-370m \\
        --steps 10 --batch 8 --seq 2048
    python -m repro_torch.launch.train --plan plan.json --layers 28 \\
        --seq 4096 --batch 2 --steps 3 --lr 3e-5
    python -m repro_torch.launch.train --device cpu --reduced \\
        --arch qwen3-4b --steps 5

Runs on the CUDA device unless ``--device cpu`` is given.  The weights are
random from seed 0.  As in the JAX driver, the plan comes from ``--plan``
(verified on load; ``--strict`` rejects deprecated v0/v1 files) or from the
paper's search (:func:`search_plan`, on the 64-GPU H100 preset), and
``--plan-out`` writes it.  The driver takes remat from the plan as the JAX
driver does (:func:`remat_from_plan`); the plan's sharding degrees and
micro-batch count are printed, not applied, as on the JAX driver's
one-device path.  ``--pipeline`` and checkpoints are not ported yet
(``ROADMAP.md``).
"""
from __future__ import annotations

import argparse
import pathlib
import time
from typing import Dict, List, Optional, Sequence

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.specs import layerspecs_for
from repro_torch.core import (ClusterSpec, GalvatronOptimizer, ParallelPlan,
                              galvatron_variant, h100_cluster)
from repro_torch.data import (DataConfig, synthetic_lm_batches,
                              text_corpus_batches)
from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.executor import init_train_state, make_train_step


def search_plan(cfg: ModelConfig, seq_len: int, n_devices: int = 64, *,
                cluster: Optional[ClusterSpec] = None,
                batch_grid: Sequence[int] = (64, 128, 256)) -> ParallelPlan:
    """The JAX driver's search (``repro/launch/train.py::search_plan``):
    the same ``bmw`` settings and schedules, on ``cluster`` (default
    :func:`~repro_torch.core.hardware.h100_cluster` of ``n_devices``) over
    ``batch_grid`` (default the JAX driver's)."""
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
                              ocfg).optimize()
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


def train(cfg: ModelConfig, args: argparse.Namespace) -> List[Dict[str, float]]:
    """Resolve the plan, then run ``args.steps`` steps; return each step's
    loss, grad norm and lr."""
    dev = resolve_device(args.device)
    plan = plan_from_args(cfg, args)
    remat = remat_from_plan(plan)
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab_size=cfg.vocab_size)
    gen = (text_corpus_batches(args.corpus, dcfg) if args.corpus
           else synthetic_lm_batches(dcfg))
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
    print("done.")
    return history


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(
        prog="train.py",
        description="Train a model on one device (PyTorch port).")
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
    return ap.parse_args(argv)


def main(argv=None) -> List[Dict[str, float]]:
    args = parse_args(argv)
    return train(config_from_args(args), args)


if __name__ == "__main__":
    main()
