"""Static-verifier CLI (``python -m repro_torch.analysis``;
``repro/launch/lint.py``).

Runs the plan and schedule passes and exits non-zero when error-severity
diagnostics exist (docs/analysis.md has the rule catalog):

    # certify every legal schedule combo on the acceptance grid
    PYTHONPATH=src python -m repro_torch.analysis --all-schedules

    # a custom grid: P=2,4 x m=1..8 x V=1,2
    PYTHONPATH=src python -m repro_torch.analysis \\
        --all-schedules "P=2,4;m=1..8;V=1,2"

    # lint plan files (schedule table included), writing the
    # machine-readable report
    PYTHONPATH=src python -m repro_torch.analysis --plan plan.json \\
        --report lint-report.json

``--strict`` escalates deprecated-plan-version warnings (PLN001) to
errors.  Exit status: 0 clean, 1 error diagnostics, 2 usage error.  The
reference's ``--src`` pass lints JAX source for JAX pitfalls
(``repro/analysis/jax_lint.py``); it is JAX-specific and not ported, and
``--src`` exits 2 saying so.
"""
from __future__ import annotations

import argparse
import re
import sys
from typing import List, Sequence, Tuple

from repro_torch.analysis import (DEFAULT_GRID, DiagnosticReport,
                                  certify_plan_json, schedule_grid,
                                  verify_program)

_AXIS = {"P": 0, "m": 1, "V": 2}


def parse_grid(spec: str) -> Tuple[Tuple[int, ...], ...]:
    """Parse ``"P=1,2,4,8;m=1..16;V=1,2"`` (any subset of axes; missing
    axes fall back to the acceptance grid)."""
    axes = list(DEFAULT_GRID)
    for part in filter(None, (p.strip() for p in spec.split(";"))):
        m = re.fullmatch(r"([PmV])=([0-9.,]+)", part)
        if not m:
            raise ValueError(
                f"bad grid component {part!r}; want e.g. P=1,2,4 or m=1..16")
        vals: List[int] = []
        for tok in m.group(2).split(","):
            if ".." in tok:
                lo, hi = tok.split("..", 1)
                vals.extend(range(int(lo), int(hi) + 1))
            elif tok:
                vals.append(int(tok))
        if not vals:
            raise ValueError(f"empty axis in grid component {part!r}")
        axes[_AXIS[m.group(1)]] = tuple(vals)
    return tuple(axes)


def _run_schedule_grid(spec: str, report: DiagnosticReport,
                       verbose: bool) -> int:
    from repro_torch.runtime.schedules import compile_schedule

    stages, micros, chunks = parse_grid(spec) if spec else DEFAULT_GRID
    n = 0
    for name, P, m, V in schedule_grid(stages, micros, chunks):
        pr = compile_schedule(name, P, m, V if V > 1 else None)
        diags = verify_program(pr)
        report.extend(d for d in diags
                      if verbose or d.severity != "info")
        n += 1
    print(f"schedule grid: certified {n} legal (schedule, P, m, V) "
          f"combo(s) over P={list(stages)} m={list(micros)} "
          f"V={list(chunks)}")
    return n


def _run_plan(path: str, strict: bool, report: DiagnosticReport,
              verbose: bool) -> None:
    import json

    from repro_torch.analysis.diagnostics import error
    from repro_torch.runtime.schedules import compile_schedule

    try:
        with open(path) as f:
            d = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        report.extend([error("PLN009", path, f"cannot read plan: {e}")])
        return
    plan_report = certify_plan_json(d, strict=strict, location=path)
    report.extend(x for x in plan_report.diagnostics
                  if verbose or x.severity != "info")
    if plan_report.ok:
        # the plan parses and is legal: certify the schedule it prescribes
        prog = compile_schedule(d.get("schedule", "1f1b"), d["pp_degree"],
                                d["n_micro"], d.get("vpp_degree", 1))
        report.extend(x for x in verify_program(prog)
                      if verbose or x.severity != "info")
    print(f"plan {path}: {len(plan_report.errors())} error(s), "
          f"{len(plan_report.warnings())} warning(s)")


def main(argv: Sequence[str] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static verifier: schedule happens-before "
                    "certification and plan lint "
                    "(rule catalog: docs/analysis.md).")
    ap.add_argument("--plan", action="append", default=[], metavar="FILE",
                    help="plan JSON file to verify (repeatable); the "
                         "schedule it prescribes is certified too")
    ap.add_argument("--all-schedules", nargs="?", const="", default=None,
                    metavar="GRID",
                    help="certify every legal schedule combo; optional "
                         "grid spec like 'P=1,2,4,8;m=1..16;V=1,2' "
                         "(default: that acceptance grid)")
    ap.add_argument("--src", action="append", default=[], metavar="DIR",
                    help="not ported: the reference's JAX-pitfall lint "
                         "(exits 2)")
    ap.add_argument("--strict", action="store_true",
                    help="escalate deprecated plan versions (v0/v1) to "
                         "errors")
    ap.add_argument("--report", metavar="FILE",
                    help="write the full diagnostic report as JSON")
    ap.add_argument("--verbose", action="store_true",
                    help="keep info-severity certification telemetry in "
                         "the output/report")
    args = ap.parse_args(argv)

    if args.src:
        ap.error("--src is the reference's JAX-pitfall pass "
                 "(repro/analysis/jax_lint.py): it lints JAX source and is "
                 "not ported")
    if not args.plan and args.all_schedules is None:
        ap.error("nothing to do: pass --plan and/or --all-schedules")

    report = DiagnosticReport()
    if args.all_schedules is not None:
        try:
            _run_schedule_grid(args.all_schedules, report, args.verbose)
        except ValueError as e:
            ap.error(str(e))
    for path in args.plan:
        _run_plan(path, args.strict, report, args.verbose)

    out = report.format(min_severity="info" if args.verbose else "warning")
    print(out)
    if args.report:
        with open(args.report, "w") as f:
            f.write(report.dumps() + "\n")
        print(f"wrote {args.report}")
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())
