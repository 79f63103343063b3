"""Training entry point of the port: single-device training of a dense or
SSM model on synthetic or byte-level text batches.

    python -m repro_torch.launch.train --arch mamba2-370m \\
        --steps 10 --batch 8 --seq 2048
    python -m repro_torch.launch.train --device cpu --reduced \\
        --arch qwen3-4b --steps 5

Runs on the CUDA device unless ``--device cpu`` is given.  The weights are
random from seed 0.  The JAX driver's plan search, ``--plan``,
``--pipeline`` and checkpoints are not ported yet (``ROADMAP.md``); remat
comes from a plan there, so this driver trains without it
(:func:`~repro_torch.runtime.executor.make_train_step` takes
``remat_segments``).
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List

import torch

from repro_torch.configs import get_config, list_archs
from repro_torch.data import (DataConfig, synthetic_lm_batches,
                              text_corpus_batches)
from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.optim import AdamWConfig
from repro_torch.runtime.executor import init_train_state, make_train_step


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
    """Run ``args.steps`` steps; return each step's loss, grad norm and lr."""
    dev = resolve_device(args.device)
    dcfg = DataConfig(seq_len=args.seq, global_batch=args.batch,
                      vocab_size=cfg.vocab_size)
    gen = (text_corpus_batches(args.corpus, dcfg) if args.corpus
           else synthetic_lm_batches(dcfg))
    opt_cfg = AdamWConfig(lr=args.lr)
    params, opt = init_train_state(cfg, seed=0, opt_cfg=opt_cfg,
                                   device=dev)
    step = make_train_step(cfg, opt_cfg)
    n_params = sum(p.numel() for p in params.parameters())
    print(f"model: {args.arch} ({n_params / 1e6:.1f}M params), "
          f"device={dev}")
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
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default cuda)")
    return ap.parse_args(argv)


def main(argv=None) -> List[Dict[str, float]]:
    args = parse_args(argv)
    return train(config_from_args(args), args)


if __name__ == "__main__":
    main()
