"""The readings that the limits of ``correct`` are set from, in one process.

    python3 perfbench/calibrate.py --workload <name> --seeds <n> ... \\
        [--control-seeds <n> ...] [--fault-seeds <n> ...] [--out <file>]

For each of ``--seeds``: the program's first steps against the plain
reference in fp32 (the lower readings: sound runs).  For each of
``--control-seeds``: the control, the reference computed in fp8 (e4m3
operands, e5m2 gradients) in the program's place, against the fp32
reference.  For each of ``--fault-seeds``: the fault "half of the batch
left out, the mean taken over the rest", planted in the reference put in
the program's place.  A step that leaves the state unchanged reads 1 on
``change_gap`` and needs no run.  For each of ``--witness-seeds`` (among
``--seeds``): the program against a reference that keeps its live
weights in the configuration's dtypes beside fp32 master weights, as the
program does (a witness, not the reference).  Prints one JSON line a
reading and writes them all to ``--out``.  Needs a CUDA device, as a run does.
"""
from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import pathlib
import statistics
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--witness-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    # several references live in turn in one process: keep the allocator
    # from fragmenting (no time or peak is measured here)
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF",
                          "expandable_segments:True")
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from perfbench import judge, spec, traffic, train

    if not torch.cuda.is_available():
        print("calibrate needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload, ROOT)
    n = int(cell.spec["checked_steps"])
    rows = []

    def emit(kind, seed, g, t, a=None, b=None):
        row = {"kind": kind, "seed": seed, "seconds": t,
               **{k: g[k] for k in ("loss_gap", "loss_gaps", "grad_gap",
                                    "grad_leaf", "change_gap",
                                    "change_leaf")}}
        if a is not None:
            for what in ("grad", "change"):
                lg = judge.leaf_gaps(a[what], b[what], sorted(b[what]))
                top = sorted(lg.items(), key=lambda kv: -kv[1])
                row[f"{what}_leaf_gaps"] = {
                    "median": statistics.median(lg.values()),
                    "p90": sorted(lg.values())[int(0.9 * len(lg))],
                    "top": top[:6]}
        rows.append(row)
        print(json.dumps(row), flush=True)

    refs = {}
    for seed in args.seeds:
        t = time.perf_counter()
        pg = train.build(cell, seed, dev)
        prog = train.program_readings(pg.step, pg.params, pg.opt_state,
                                      pg.batches[:n], pg.leaves, seed,
                                      pg.beta1, dev)
        leaves, batches = pg.leaves, pg.batches[:n]
        del pg
        gc.collect()
        torch.cuda.empty_cache()
        refs[seed] = (leaves, batches, train.reference_readings(
            cell, leaves, seed, batches, dev))
        emit("program", seed, judge.gaps(prog, refs[seed][2]),
             time.perf_counter() - t, prog, refs[seed][2])
        if seed in args.witness_seeds:
            t = time.perf_counter()
            wit = train.reference_readings(cell, leaves, seed, batches, dev,
                                           live_dtypes=True)
            emit("witness_program_vs_bf16_live_reference", seed,
                 judge.gaps(prog, wit), time.perf_counter() - t)
            emit("witness_bf16_live_reference_vs_reference", seed,
                 judge.gaps(wit, refs[seed][2]), 0.0)

    def fp32_of(seed):
        if seed not in refs:
            fam = importlib.import_module(
                f"perfbench.families.{cell.config['family']}")
            leaves = fam.leaves(cell.config)
            batches = traffic.make_batches(cell.traffic,
                                           fam.vocab(cell.config), seed)[:n]
            refs[seed] = (leaves, batches, train.reference_readings(
                cell, leaves, seed, batches, dev))
        return refs[seed]

    for seed in args.control_seeds:
        t = time.perf_counter()
        leaves, batches, ref = fp32_of(seed)
        ctl = train.reference_readings(cell, leaves, seed, batches, dev,
                                       "fp8")
        emit("control_fp8", seed, judge.gaps(ctl, ref),
             time.perf_counter() - t, ctl, ref)
    for seed in args.fault_seeds:
        t = time.perf_counter()
        leaves, batches, ref = fp32_of(seed)
        half = [{k: v[:v.shape[0] // 2] for k, v in b.items()}
                for b in batches]
        bad = train.reference_readings(cell, leaves, seed, half, dev)
        emit("fault_half_batch", seed, judge.gaps(bad, ref),
             time.perf_counter() - t, bad, ref)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
