"""Budget-sweep strategy search CLI (the frontier engine, DESIGN.md §6);
the port's copy of ``repro/launch/search.py``, with the same flags.

Computes the paper's throughput-vs-memory story in one invocation: either a
single plan (``--budget``) or the whole Pareto frontier over a budget axis
(``--budget-sweep``), searched in ~one pass instead of one full search per
budget.

    # 8-point frontier for the paper's BERT-Huge-32 on the 8-GPU cluster
    PYTHONPATH=src python -m repro_torch.launch.search --model bert-huge-32 \\
        --cluster 8x-rtx-titan-pcie --budget-sweep 4,6,...,18 \\
        --out frontier.json

    # assigned architecture on one H100 of an 8-GPU node
    PYTHONPATH=src python -m repro_torch.launch.search --arch qwen3-4b \\
        --seq 4096 --cluster 8x-h100-sxm-nvlink --devices 1 --out plan.json

    # a 64-GPU H100 cluster, process-pool (B, P) fan-out
    PYTHONPATH=src python -m repro_torch.launch.search --arch qwen3-4b \\
        --seq 2048 --cluster 64x-h100-sxm-ib400 --budget-sweep 8,16,...,80 \\
        --backend processes --jobs 8

``--budget-sweep`` takes GB values: an explicit comma list (``4,6,8``) or an
arithmetic ellipsis ``a,b,...,z`` expanded with step ``b - a`` (so
``8,16,...,80`` means 8, 16, 24, …, 80).  The frontier (budgets, plans,
predicted throughputs, knee points) is printed as a table and written as
JSON via ``PlanFrontier.dumps`` when ``--out`` is given; a single-budget
run writes the plan JSON instead.  ``--backend`` picks how the independent
(B, P) outer candidates execute (serial / threads / processes pools /
vectorized stacked-DP batching; ``--jobs`` sizes the pools) and
frontier-guided batch-axis pruning is on unless ``--no-prune`` — every
combination returns byte-identical plans with aggregated cache + pruning
telemetry in the summary line (docs/search.md).

The model comes from ``--arch`` (an assigned architecture id, searched at
``--seq``) or ``--model`` (a paper evaluation model, fixed geometry).  The
cluster comes from ``--cluster`` (a preset name from ``repro_torch.core.CLUSTERS``)
with optional ``--devices`` override.
"""
from __future__ import annotations

import argparse
import pathlib
import sys
from typing import List

from repro_torch.core import (CLUSTERS, GalvatronOptimizer, galvatron_variant)
from repro_torch.core.optimizer import SEARCH_BACKENDS, normalize_batch_grid

GB = 1024 ** 3


def certify_plans(plans, *, strict: bool = False, log=print) -> bool:
    """Run the static verifier on every plan the search is about to emit.

    Every plan is checked by the plan verifier (``repro_torch.analysis``) and
    its prescribed schedule table by the happens-before certifier —
    the search can never serialize an uncertified plan.  Error-severity
    findings (and, under ``strict``, warnings too) veto serialization;
    diagnostics are printed either way.

    Returns True when every plan certifies.
    """
    from repro_torch.analysis import verify_plan_json, verify_program
    from repro_torch.runtime.schedules import compile_schedule

    ok = True
    for k, plan in enumerate(plans):
        loc = f"plan[{k}]" if len(plans) > 1 else "plan"
        diags = verify_plan_json(plan.to_json(), location=loc)
        if not any(d.severity == "error" for d in diags):
            diags += verify_program(compile_schedule(
                plan.schedule, plan.pp_degree, plan.n_micro,
                plan.vpp_degree))
        bad = [d for d in diags if d.severity == "error"
               or (strict and d.severity == "warning")]
        for d in bad:
            log(d.format())
        if bad:
            ok = False
    return ok


def parse_sweep_values(text: str) -> List[float]:
    """Comma list ``4,6,8`` or arithmetic ellipsis ``a,b,...,z`` (step
    ``b - a``), unit-free."""
    parts = [p.strip() for p in text.split(",") if p.strip()]
    if "..." in parts:
        i = parts.index("...")
        if i < 2 or i != len(parts) - 2:
            raise ValueError(
                f"ellipsis sweep must look like a,b,...,z  (got {text!r})")
        head = [float(p) for p in parts[:i]]
        stop = float(parts[i + 1])
        step = head[-1] - head[-2]
        if step <= 0:
            raise ValueError(f"non-increasing ellipsis step in {text!r}")
        vals = list(head)
        while vals[-1] + step <= stop + 1e-9:
            vals.append(vals[-1] + step)
        return vals
    return [float(p) for p in parts]


def parse_budget_sweep(text: str) -> List[float]:
    """GB values: ``4,6,8`` or arithmetic ellipsis ``a,b,...,z``."""
    return [v * GB for v in parse_sweep_values(text)]


def _specs_for(args):
    if args.model:
        from repro_torch.configs.paper_models import paper_model_specs
        return paper_model_specs(args.model), args.model
    if args.arch:
        from repro_torch.configs import get_config
        from repro_torch.configs.specs import layerspecs_for
        cfg = get_config(args.arch)
        return layerspecs_for(cfg, args.seq), f"{args.arch}@seq{args.seq}"
    raise SystemExit("one of --arch / --model is required")


def _cluster_for(args):
    if args.cluster not in CLUSTERS:
        raise SystemExit(f"unknown cluster {args.cluster!r}; "
                         f"have {sorted(CLUSTERS)}")
    cluster = CLUSTERS[args.cluster]
    if args.devices:
        cluster = cluster.with_devices(args.devices)
    return cluster


def build_optimizer(specs, cluster, args) -> GalvatronOptimizer:
    """Construct the search engine from parsed CLI args.

    Args:
      specs: per-layer :class:`~repro_torch.core.layerspec.LayerSpec` workload.
      cluster: the :class:`~repro_torch.core.hardware.ClusterSpec` to plan for.
      args: the parsed ``argparse`` namespace (see ``--help``).

    Returns:
      A configured :class:`~repro_torch.core.GalvatronOptimizer`.

    Raises:
      ValueError: unknown ``--variant`` preset.
    """
    ocfg = galvatron_variant(args.variant)
    if args.batch_grid:
        # validate + canonicalize here (dedupe / sort / reject non-positive
        # entries) so a bad --batch-grid fails loudly at startup instead of
        # silently corrupting the two-consecutive-OOM batch stop
        ocfg.batch_grid = normalize_batch_grid(
            [int(b) for b in args.batch_grid.split(",")])
    ocfg.n_bins = args.n_bins
    ocfg.micro_candidates = args.micro_candidates
    if args.max_pp:
        ocfg.max_pp = args.max_pp
    if args.schedules:
        ocfg.schedules = tuple(args.schedules.split(","))
    if getattr(args, "backend", ""):
        ocfg.search_backend = args.backend
    if getattr(args, "jobs", 0):
        ocfg.jobs = args.jobs
    ocfg.prune_batch_axis = bool(getattr(args, "prune", False))
    if getattr(args, "sp", False):
        ocfg.use_sp = True
    if getattr(args, "max_sp", 0):
        ocfg.max_sp = args.max_sp
    if getattr(args, "ep", False):
        ocfg.use_ep = True
    if getattr(args, "max_ep", 0):
        ocfg.max_ep = args.max_ep
    cost_cfg = None
    if getattr(args, "min_samples_per_device", 0.0):
        from repro_torch.core.cost_model import CostModelConfig
        cost_cfg = CostModelConfig(
            min_samples_per_device=args.min_samples_per_device)
    return GalvatronOptimizer(specs, cluster, ocfg, cost_cfg)


def main(argv=None) -> int:
    """CLI entry point (see module docstring and ``--help``).

    Args:
      argv: argument list (default: ``sys.argv[1:]``).

    Returns:
      Process exit code — 0 on success, 1 when no feasible plan exists
      under a single ``--budget``.
    """
    ap = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    src = ap.add_argument_group("model")
    src.add_argument("--arch", help="assigned architecture id (see configs)")
    src.add_argument("--model", help="paper evaluation model name")
    src.add_argument("--seq", type=int, default=2048,
                     help="sequence length for --arch models")
    ap.add_argument("--cluster", default="8x-rtx-titan-pcie",
                    help="cluster preset name from repro_torch.core.CLUSTERS")
    ap.add_argument("--devices", type=int, default=0,
                    help="override the preset's device count")
    ap.add_argument("--budget", type=float, default=0.0,
                    help="single memory budget in GB (one optimize() plan)")
    ap.add_argument("--budget-sweep", default="",
                    help='GB list "4,6,8" or ellipsis "8,16,...,80"')
    srv = ap.add_argument_group("serving (SLO-axis search)")
    srv.add_argument("--slo-sweep", default="",
                     help="per-token latency SLOs in ms "
                          '("20,30,50" or ellipsis "10,20,...,80"): decode '
                          "is bandwidth-bound, so each SLO maps to the byte "
                          "budget slo * hbm_bw * efficiency and rides the "
                          "same frontier engine as --budget-sweep; emitted "
                          "plans carry a v3 serving section "
                          "(docs/serving.md)")
    srv.add_argument("--max-context", type=int, default=2048,
                     help="serving plans: per-request context ceiling")
    srv.add_argument("--mean-context", type=float, default=0.0,
                     help="serving plans: expected mean context for KV "
                          "traffic/pool sizing (default max-context / 2)")
    srv.add_argument("--ttft-slo", type=float, default=0.0,
                     help="serving plans: optional TTFT target in ms "
                          "(recorded in the serving section)")
    ap.add_argument("--quant", type=float, default=0.0,
                    help="quantization-grid anchor in GB (default: the "
                         "largest swept budget).  The DP resolves memory in "
                         "quant/n-bins steps, so a wide sweep quantizes its "
                         "small budgets coarsely; anchor at the smallest "
                         "budget for dedicated-search resolution everywhere "
                         "at higher search cost")
    ap.add_argument("--backend", default="", choices=("",) + SEARCH_BACKENDS,
                    help="candidate execution backend: serial (the oracle), "
                         "threads / processes (pooled (B, P) fan-out), or "
                         "vectorized (stage DPs batched into one stacked "
                         "NumPy evaluation).  Plans are byte-identical "
                         "across backends (default: serial)")
    ap.add_argument("--jobs", type=int, default=0,
                    help="worker count for the threads/processes backends "
                         "(default: one per core)")
    ap.add_argument("--no-prune", dest="prune", action="store_false",
                    help="disable frontier-guided batch-axis pruning "
                         "(pruning skips (B, P) candidates whose certified "
                         "optimistic bound is dominated or over-budget; "
                         "plans are identical either way, it only saves "
                         "search time)")
    ap.add_argument("--parallel", action="store_true",
                    help="fan (B, P) candidates across a thread pool "
                         "(same as --backend threads)")
    ap.add_argument("--workers", type=int, default=0,
                    help="thread-pool size for --parallel (default: auto)")
    ap.add_argument("--variant", default="bmw",
                    help="galvatron_variant search-space preset: dp+tp / "
                         "dp+pp / galvatron / base / 1f1b-biobj / bmw")
    ap.add_argument("--batch-grid", default="",
                    help='comma global-batch sizes to sweep, e.g. "16,32,64" '
                         "(default: the geometric+linear Alg. 1 grid)")
    ap.add_argument("--n-bins", type=int, default=128,
                    help="DP memory-quantization bins (more = finer plans, "
                         "slower search)")
    ap.add_argument("--micro-candidates", type=int, default=3,
                    help="micro-batch counts tried per (B, P), doubling "
                         "from P")
    ap.add_argument("--max-pp", type=int, default=0,
                    help="cap the searched pipeline degree (0 = no cap)")
    ap.add_argument("--sp", action="store_true",
                    help="add ring-attention sequence parallelism to the "
                         "searched paradigms (plan format v4 sp_degree; "
                         "needed for long contexts where no sp=1 plan "
                         "fits the budget — docs/architecture.md §SP)")
    ap.add_argument("--max-sp", type=int, default=0,
                    help="cap the searched sequence-parallel degree "
                         "(0 = no cap; implies nothing without --sp)")
    ap.add_argument("--ep", action="store_true",
                    help="add expert parallelism to the searched paradigms "
                         "(plan format v5 ep_degree; MoE expert weights "
                         "shard over an expert axis with all-to-all "
                         "dispatch/combine — docs/architecture.md §EP)")
    ap.add_argument("--max-ep", type=int, default=0,
                    help="cap the searched expert-parallel degree "
                         "(0 = no cap; implies nothing without --ep)")
    ap.add_argument("--min-samples-per-device", type=float, default=0.0,
                    help="physical per-device batch floor: reject "
                         "strategies whose DP/SDP span leaves fewer "
                         "samples per device (data parallelism cannot "
                         "split one sequence; set 1.0 for long-context "
                         "searches so SP is priced honestly; 0 = the "
                         "paper's unconstrained linear model)")
    ap.add_argument("--schedules", default="",
                    help="comma list of pipeline-schedule candidates the "
                         "search sweeps per (B, P): any of gpipe, 1f1b, "
                         "1f1b-interleaved, zb-h1 "
                         '(e.g. "1f1b,1f1b-interleaved,zb-h1"; '
                         "default: the variant's single schedule)")
    ap.add_argument("--verbose", action="store_true",
                    help="print every improving (B, P, budget) candidate")
    ap.add_argument("--strict", action="store_true",
                    help="fail (exit 2) if an emitted plan carries any "
                         "verifier warnings, not just errors; plan files "
                         "read elsewhere also reject deprecated v0/v1 "
                         "under strict")
    ap.add_argument("--out", default="", help="write frontier/plan JSON here")
    args = ap.parse_args(argv)

    specs, model_name = _specs_for(args)
    cluster = _cluster_for(args)
    opt = build_optimizer(specs, cluster, args)
    if args.quant:
        opt.cfg.quant_bytes = args.quant * GB
    print(f"model={model_name} ({len(specs)} layers)  cluster={cluster.name} "
          f"x{cluster.n_devices}")

    workers = args.jobs or args.workers or None
    if args.slo_sweep:
        import json as _json

        from repro_torch.serving.slo_search import ServingPlanSearch
        slos = parse_sweep_values(args.slo_sweep)
        search = ServingPlanSearch(specs, cluster, config=opt.cfg)
        points, frontier = search.sweep_slos(
            slos, max_context=args.max_context,
            mean_context=args.mean_context or None,
            ttft_slo_ms=args.ttft_slo,
            backend=args.backend or None, verbose=args.verbose)
        for pt in points:
            if pt.plan is None or pt.plan.serving is None:
                print(f"{pt.slo_ms:8.1f} ms  infeasible "
                      f"({pt.budget_bytes / GB:.1f} GB streamable/step)")
                continue
            sv = pt.plan.serving
            print(f"{pt.slo_ms:8.1f} ms  tp{sv.decode_tp} pp{sv.decode_pp} "
                  f"b={sv.decode_batch} page={sv.page_size} "
                  f"pool={sv.kv_pool_pages}p  "
                  f"est {sv.est_tok_ms:.2f} ms/tok, "
                  f"{sv.est_tok_per_s:.0f} tok/s, "
                  f"ttft {sv.est_ttft_ms:.1f} ms")
        emitted = [pt.plan for pt in points if pt.plan is not None]
        if not emitted:
            print("no SLO point is feasible", file=sys.stderr)
            return 1
        if len(emitted) == 1:
            payload = emitted[0].dumps()     # directly servable plan file
        else:
            payload = _json.dumps(
                {"slo_points": [
                    {"slo_ms": pt.slo_ms, "budget_bytes": pt.budget_bytes,
                     "plan": (pt.plan.to_json() if pt.plan else None)}
                    for pt in points]}, indent=2)
    elif args.budget_sweep:
        budgets = parse_budget_sweep(args.budget_sweep)
        frontier = opt.sweep_budgets(
            budgets, parallel=args.parallel, max_workers=workers,
            backend=args.backend or None, verbose=args.verbose)
        print(frontier.summary())
        knees = frontier.knee_points()
        print(f"{len(frontier.feasible_points())}/{len(frontier.points)} "
              f"budgets feasible, {len(knees)} knee points; "
              f"search {opt.stats['search_seconds']:.2f}s "
              f"({opt.stats['stage_cache_hits']:.0f} cache hits / "
              f"{opt.stats['stage_cache_misses']:.0f} misses; "
              f"{opt.stats['bp_pruned_infeasible']:.0f} candidates pruned "
              f"over-budget + {opt.stats['bp_pruned_dominated']:.0f} "
              f"dominated of {opt.stats['bp_candidates']:.0f}, "
              f"{opt.stats['bp_forced']:.0f} forced)")
        emitted = [p.plan for p in frontier.feasible_points()]
        payload = frontier.dumps()
    else:
        # a 1-point sweep is byte-identical to optimize() and honours the
        # --backend / --parallel (B, P) fan-out
        budget = args.budget * GB if args.budget else cluster.budget()
        plan = opt.sweep_budgets(
            [budget], parallel=args.parallel, max_workers=workers,
            backend=args.backend or None,
            verbose=args.verbose).points[0].plan
        if plan is None:
            print(f"no feasible plan under {budget / GB:.1f} GB", file=sys.stderr)
            return 1
        print(f"{budget / GB:7.1f} GB  {plan.est_throughput:10.2f} samples/s  "
              f"{plan.summary()}")
        emitted = [plan]
        payload = plan.dumps()

    # the verifier gates serialization: an uncertified plan is never
    # written (docs/analysis.md)
    if not certify_plans(emitted, strict=args.strict,
                         log=lambda s: print(s, file=sys.stderr)):
        print(f"verification failed for {len(emitted)} emitted plan(s); "
              "not writing output", file=sys.stderr)
        return 2

    if args.out:
        pathlib.Path(args.out).write_text(payload + "\n")
        print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
