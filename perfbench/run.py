"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

The cell, its configuration, traffic and metrics come from
``BENCHMARK.json`` and the files under ``perfbench/``.  The run needs as
many CUDA devices as the cell asks for, and fails without them: it never
measures on the CPU.  The kernels' build and every compiler cache live
under ``build/`` in the checkout.  The last lines on standard error are the
numbers that decide ``correct``, each beside its limit; the last line on
standard output is the result (JSON).
"""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
BANNED = {"jax", "jaxlib", "flax", "repro"}


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def power_limit() -> str:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"not read ({e.__class__.__name__})"
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else (
        "not read")


def banned_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & BANNED)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    cache = ROOT / "build" / "cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)

    from perfbench import spec
    cell = spec.load_cell(args.workload, ROOT)
    chips = int(cell.entry["chips"])

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"{args.workload} needs {chips} CUDA device(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            ": no result")
        return 2
    from perfbench import train
    device = torch.device("cuda", 0)
    out = train.run(cell, args.seed, args.seconds, bool(args.trace), device,
                    T0, log=log)
    found = banned_modules()
    if found:
        log(f"the run loaded {found}: the benchmark must not import JAX or "
            "the JAX package; no result")
        return 3
    if "trace" in out:
        log(f"traced {out['trace']['steps']} steps; device ops whose launch "
            f"the trace did not link: {out['trace']['unlinked']}")
    line = train.last_line(out, chips, power_limit())
    for text in train.limits_line(out["checks"]):
        log(text)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
