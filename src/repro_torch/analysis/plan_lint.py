# The port's copy of repro/analysis/plan_lint.py: the same names and arithmetic.
"""Plan verifier: static checks on ``ParallelPlan`` JSON, every format
version (rule ids ``PLN001``–``PLN012``, catalog in ``docs/analysis.md``).

The search emits a plan; the runtime executes it — possibly in a
different process, weeks later, from a file somebody hand-edited.  This
pass certifies the *file*: field presence and types (so a malformed plan
is a structured diagnostic naming the offending field, not a bare
``KeyError``), format-version sanity, degree arithmetic against the mesh
the launcher will build (``launch/mesh.py``), per-layer strategy totals,
stage-boundary sharding hand-offs (``runtime/sharding.py`` policy
reduction), schedule legality (shared with the schedule verifier's
``schedule_legal``), and estimator self-consistency.

Two entry points:

  * :func:`verify_plan_json` — raw ``dict`` (any version, possibly
    malformed); structural rules run first and semantic rules only on a
    loadable plan.
  * :func:`verify_plan` — an already-typed :class:`ParallelPlan`.

``load_plan_file`` wraps both into the loading path used by the train
CLI: parse, verify, raise :class:`DiagnosticError` on error severity.
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional, Tuple

from repro_torch.core.plan import PLAN_FORMAT_VERSION, ParallelPlan
from repro_torch.core.strategy import Strategy

from .diagnostics import (Diagnostic, DiagnosticReport, error, info, warning)
from .schedule_lint import schedule_legal

#: required keys in every plan JSON, with the Python types we accept
_REQUIRED = {
    "n_devices": int,
    "pp_degree": int,
    "partition": list,
    "strategies": list,
    "global_batch": int,
    "n_micro": int,
}

_SINGLE_CHUNK = ("gpipe", "1f1b", "zb-h1")


def detect_format_version(d: Dict) -> int:
    """Infer the format version of a raw plan dict (see core/plan.py):
    explicit ``format_version`` stamp (v2+), else a non-default
    ``ep_degree`` implies v5, else a non-default ``sp_degree``/``seq_len``
    implies v4, else a non-null ``serving`` section implies v3, else
    ``vpp_degree`` implies v1, else v0.  Like ``serving: null``, the
    v4/v5 keys at their defaults (1 / 0 / 1) carry no version signal —
    an older file is indistinguishable from one."""
    if "format_version" in d:
        return int(d["format_version"])
    if isinstance(d, dict) and d.get("ep_degree", 1) != 1:
        return 5
    if isinstance(d, dict) and (d.get("sp_degree", 1) != 1
                                or d.get("seq_len", 0)):
        return 4
    if isinstance(d, dict) and d.get("serving") is not None:
        return 3
    return 1 if ("vpp_degree" in d or "schedule" in d) else 0


# ---------------------------------------------------------------------------
# structural checks on the raw dict
# ---------------------------------------------------------------------------

def _check_structure(d: Dict, loc: str, out: List[Diagnostic]) -> bool:
    """PLN009: field presence + types.  Returns True when the dict is
    structurally loadable (semantic checks can proceed)."""
    ok = True
    if not isinstance(d, dict):
        out.append(error("PLN009", loc,
                         f"plan JSON must be an object, got "
                         f"{type(d).__name__}"))
        return False
    for key, typ in _REQUIRED.items():
        if key not in d:
            out.append(error(
                "PLN009", f"{loc}.{key}",
                f"required field {key!r} is missing",
                "every plan version carries this field; the file is "
                "truncated or not a plan"))
            ok = False
        elif not isinstance(d[key], typ) or isinstance(d[key], bool):
            out.append(error(
                "PLN009", f"{loc}.{key}",
                f"field {key!r} must be {typ.__name__}, got "
                f"{type(d[key]).__name__} ({d[key]!r})"))
            ok = False
    if not ok:
        return False
    for j, s in enumerate(d["strategies"]):
        floc = f"{loc}.strategies[{j}]"
        if (not isinstance(s, dict) or "levels" not in s
                or "ckpt" not in s):
            out.append(error(
                "PLN009", floc,
                "strategy entries need 'levels' and 'ckpt' keys",
                "see docs/plan-format.md for the per-layer schema"))
            ok = False
            continue
        try:
            Strategy.from_json(s)
        except (TypeError, ValueError, KeyError) as e:
            out.append(error(
                "PLN009", floc,
                f"strategy does not parse: {e!r}"))
            ok = False
    return ok


def _check_version(d: Dict, loc: str, strict: bool,
                   out: List[Diagnostic]) -> None:
    """PLN001: format_version sanity + deprecation policy."""
    ver = detect_format_version(d)
    if ver > PLAN_FORMAT_VERSION:
        out.append(error(
            "PLN001", f"{loc}.format_version",
            f"plan declares format_version={ver}, but this build reads "
            f"<= {PLAN_FORMAT_VERSION}: fields added by the newer writer "
            "would be silently dropped",
            "re-emit the plan with this build's search CLI"))
        return
    if ver < 0:
        out.append(error(
            "PLN001", f"{loc}.format_version",
            f"format_version={ver} is not a known version"))
        return
    if ver < PLAN_FORMAT_VERSION:
        mk = error if strict else warning
        out.append(mk(
            "PLN001", f"{loc}.format_version",
            f"deprecated v{ver} plan (current is v{PLAN_FORMAT_VERSION}): "
            "missing keys are filled with the defaults that version "
            "implied (schedule='1f1b', vpp_degree=1, serving=None, "
            "sp_degree=1, ep_degree=1)"
            + (" — rejected under --strict" if strict else ""),
            "re-emit with the current search CLI to pin the schedule "
            "explicitly"))


# ---------------------------------------------------------------------------
# semantic checks on a typed plan
# ---------------------------------------------------------------------------

def verify_plan(plan: ParallelPlan, *, location: str = "plan"
                ) -> List[Diagnostic]:
    """Semantic rules (PLN002–PLN008) on a typed plan."""
    out: List[Diagnostic] = []
    loc = location
    P, n_dev = plan.pp_degree, plan.n_devices

    # --- PLN002: degree divisibility --------------------------------------
    if P < 1 or n_dev < 1:
        out.append(error("PLN002", f"{loc}.pp_degree",
                         f"degrees must be >= 1 "
                         f"(n_devices={n_dev}, pp_degree={P})"))
        return out
    if n_dev % P:
        out.append(error(
            "PLN002", f"{loc}.pp_degree",
            f"n_devices={n_dev} is not divisible by pp_degree={P}: "
            "stages would get ragged device groups",
            "pp_degree must divide the device count"))
        return out
    group = n_dev // P
    for j, s in enumerate(plan.strategies):
        if s.total != group:
            out.append(error(
                "PLN002", f"{loc}.strategies[{j}]",
                f"strategy {s.name()} uses {s.total} device(s), but each "
                f"stage's group has {group} (n_devices/pp_degree)",
                "every layer's level degrees must multiply to the stage "
                "group size"))

    # --- PLN003: partition shape ------------------------------------------
    part = plan.partition
    if len(part) != P:
        out.append(error(
            "PLN003", f"{loc}.partition",
            f"partition has {len(part)} entries for pp_degree={P}"))
    if any(p < 1 for p in part):
        out.append(error(
            "PLN003", f"{loc}.partition",
            f"every stage needs >= 1 layer, got {part}"))
    if sum(part) != len(plan.strategies):
        out.append(error(
            "PLN003", f"{loc}.partition",
            f"partition sums to {sum(part)} layers but the plan carries "
            f"{len(plan.strategies)} per-layer strategies",
            "len(strategies) must equal sum(partition)"))
    if plan.vpp_degree > 1 and part and min(part) < plan.vpp_degree:
        out.append(error(
            "PLN003", f"{loc}.partition",
            f"vpp_degree={plan.vpp_degree} needs >= that many layers per "
            f"stage to form virtual chunks, got min(partition)="
            f"{min(part)}"))

    # --- PLN004: schedule legality ----------------------------------------
    sched, V, m = plan.schedule, plan.vpp_degree, plan.n_micro
    from repro_torch.runtime.schedules import SCHEDULE_NAMES
    if sched not in SCHEDULE_NAMES:
        out.append(error(
            "PLN004", f"{loc}.schedule",
            f"unknown schedule {sched!r} (known: "
            f"{', '.join(SCHEDULE_NAMES)})"))
    elif sched in _SINGLE_CHUNK and V != 1:
        out.append(error(
            "PLN004", f"{loc}.vpp_degree",
            f"{sched} is a single-chunk schedule; vpp_degree must be 1, "
            f"got {V}"))
    elif not schedule_legal(sched, P, m, V):
        why = ("zb-h1 needs pp_degree > 1 and n_micro >= pp_degree (a "
               "full pipeline to hide deferred W ticks)"
               if sched == "zb-h1" else
               "1f1b-interleaved needs pp_degree > 1, vpp_degree >= 2 "
               "and n_micro divisible by pp_degree (ragged groups change "
               "the bubble the model prices)")
        out.append(error(
            "PLN004", f"{loc}.schedule",
            f"schedule={sched} is illegal for pp_degree={P}, "
            f"n_micro={m}, vpp_degree={V}: {why}",
            "the optimizer's _schedule_candidates never proposes this "
            "combo; hand-edited plans must respect it too"))

    # --- PLN005: batch divisibility ---------------------------------------
    if plan.global_batch % m:
        out.append(error(
            "PLN005", f"{loc}.n_micro",
            f"global_batch={plan.global_batch} is not divisible by "
            f"n_micro={m}: micro-batches would be uneven"))

    # --- PLN006: mesh factorization (launch/mesh.py) ----------------------
    # the pipeline runtime builds a (pipe=P, data=group) mesh; each stage's
    # dominant strategy must factor into it: tp divides the group, and all
    # layers of one stage agree on the tp degree (the bridge reduces a
    # segment to one policy — disagreement means silent resharding).
    if len(part) == P and sum(part) == len(plan.strategies):
        for st in range(P):
            ss = plan.stage_strategies(st)
            tps = sorted({s.tp for s in ss})
            if any(group % tp for tp in tps):
                out.append(error(
                    "PLN006", f"{loc}.strategies (stage {st})",
                    f"tp degree(s) {tps} do not divide the stage group "
                    f"({group}): no ('pipe','data') x model mesh "
                    "factorization exists (launch/mesh.py)"))
            elif len(tps) > 1:
                out.append(warning(
                    "PLN006", f"{loc}.strategies (stage {st})",
                    f"stage mixes tp degrees {tps}; the runtime bridge "
                    "(runtime/plan_bridge.py) collapses a stage to one "
                    "policy, so the minority layers silently reshard",
                    "prefer homogeneous tp within a stage"))

    # --- PLN007: stage-boundary sharding hand-off -------------------------
    if len(part) == P and sum(part) == len(plan.strategies) and P > 1:
        mb = plan.global_batch // m if m and plan.global_batch % m == 0 \
            else plan.global_batch
        for st in range(P):
            ss = plan.stage_strategies(st)
            if not ss:
                continue
            for which, s in (("first", ss[0]), ("last", ss[-1])):
                if mb % s.data_degree:
                    out.append(warning(
                        "PLN007", f"{loc}.strategies (stage {st})",
                        f"micro-batch {mb} does not shard over the "
                        f"{which} layer's data degree "
                        f"{s.data_degree} ({s.name()}): the cost model "
                        "prices this, but the shard_map runtime would "
                        "see ragged per-device activation shapes",
                        "pick n_micro so micro_batch % data_degree == 0 "
                        "before executing (estimates are unaffected)"))
        for st in range(P - 1):
            a, b = plan.stage_strategies(st), plan.stage_strategies(st + 1)
            if not a or not b:
                continue                 # empty stage already a PLN003 error
            out_deg, in_deg = a[-1].data_degree, b[0].data_degree
            if out_deg != in_deg:
                out.append(warning(
                    "PLN007", f"{loc}.strategies (stage {st}->{st + 1})",
                    f"boundary activation leaves stage {st} sharded "
                    f"{out_deg}-way but stage {st + 1} expects "
                    f"{in_deg}-way: the hand-off needs an extra "
                    "all-to-all beside the point-to-point send "
                    "(runtime/sharding.py prices only the send)",
                    "match the data degrees across stage boundaries or "
                    "accept the resharding cost"))

    # --- PLN010: serving section vs mesh/degree arithmetic ----------------
    sv = plan.serving
    if sv is not None:
        sloc = f"{loc}.serving"
        for phase, tp, pp in (("decode", sv.decode_tp, sv.decode_pp),
                              ("prefill", sv.prefill_tp, sv.prefill_pp)):
            if tp < 1 or pp < 1:
                out.append(error(
                    "PLN010", f"{sloc}.{phase}_tp",
                    f"{phase} degrees must be >= 1 (tp={tp}, pp={pp})"))
            elif n_dev % (tp * pp):
                out.append(error(
                    "PLN010", f"{sloc}.{phase}_tp",
                    f"{phase} tp*pp = {tp * pp} does not divide "
                    f"n_devices={n_dev}: no serving mesh factorization "
                    "exists (launch/mesh.py)",
                    "tp * pp must divide the device count for each phase"))
        if sv.page_size < 1:
            out.append(error(
                "PLN010", f"{sloc}.page_size",
                f"page_size must be >= 1, got {sv.page_size}"))
        else:
            if sv.page_size & (sv.page_size - 1):
                out.append(warning(
                    "PLN010", f"{sloc}.page_size",
                    f"page_size={sv.page_size} is not a power of two: "
                    "page-index arithmetic compiles to divisions instead "
                    "of shifts on most backends"))
            if sv.max_context < 1 or sv.max_context % sv.page_size:
                out.append(error(
                    "PLN010", f"{sloc}.max_context",
                    f"max_context={sv.max_context} must be a positive "
                    f"multiple of page_size={sv.page_size} (the page "
                    "table addresses whole pages)"))
        if sv.decode_batch < 1:
            out.append(error(
                "PLN010", f"{sloc}.decode_batch",
                f"decode_batch must be >= 1, got {sv.decode_batch}"))
        elif sv.kv_pool_pages and sv.kv_pool_pages < sv.decode_batch:
            out.append(error(
                "PLN010", f"{sloc}.kv_pool_pages",
                f"kv_pool_pages={sv.kv_pool_pages} < decode_batch="
                f"{sv.decode_batch}: the pool cannot give every decode "
                "lane even one page, so full-batch decode deadlocks"))
        if sv.prefill_chunk < 1:
            out.append(error(
                "PLN010", f"{sloc}.prefill_chunk",
                f"prefill_chunk must be >= 1, got {sv.prefill_chunk}"))
        if sv.slo_ms <= 0:
            out.append(error(
                "PLN010", f"{sloc}.slo_ms",
                f"slo_ms must be > 0, got {sv.slo_ms}"))
        elif sv.est_tok_ms > sv.slo_ms > 0:
            out.append(warning(
                "PLN010", f"{sloc}.est_tok_ms",
                f"predicted per-token latency ({sv.est_tok_ms:.2f} ms) "
                f"exceeds the plan's own SLO ({sv.slo_ms:.2f} ms): the "
                "search emitted a best-effort point, not an SLO-meeting "
                "one"))

    # --- PLN011: sequence parallelism (sp_degree) -------------------------
    spd = plan.sp_degree
    if spd > 1:
        if n_dev % (P * spd):
            out.append(error(
                "PLN011", f"{loc}.sp_degree",
                f"sp_degree={spd} x pp_degree={P} = {P * spd} does not "
                f"divide n_devices={n_dev}: the seq mesh axis cannot be "
                "factored out of the stage groups (launch/mesh.py)",
                "sp_degree must divide n_devices / pp_degree"))
        if plan.seq_len > 0 and plan.seq_len % spd:
            out.append(error(
                "PLN011", f"{loc}.seq_len",
                f"seq_len={plan.seq_len} is not divisible by "
                f"sp_degree={spd}: sequence shards would be ragged and "
                "the ring hand-off panels unequal "
                "(kernels/ring_attention.py)",
                "pick sp_degree dividing the sequence length"))
        elif plan.seq_len == 0:
            out.append(warning(
                "PLN011", f"{loc}.seq_len",
                f"sp_degree={spd} but the plan does not record seq_len: "
                "the seq_len % sp_degree divisibility cannot be checked "
                "statically",
                "re-emit with the current search CLI to stamp seq_len"))
    if plan.strategies:
        layer_sp = sorted({s.sp for s in plan.strategies})
        if layer_sp[-1] > spd:
            out.append(error(
                "PLN011", f"{loc}.sp_degree",
                f"per-layer strategies reach sp={layer_sp[-1]} but the "
                f"plan stamps sp_degree={spd}: the launcher would build a "
                "seq mesh axis too small for those layers",
                "sp_degree must be max(layer sp degrees)"))
        elif spd > 1 and len(layer_sp) > 1:
            out.append(warning(
                "PLN011", f"{loc}.strategies",
                f"layers mix sp degrees {layer_sp}; boundaries between "
                "differently-sharded sequences reshard tokens "
                "(all-to-all) beside the priced hand-offs",
                "prefer one sp degree across a stage"))

    # --- PLN012: expert parallelism (ep_degree) ---------------------------
    epd = plan.ep_degree
    if epd > 1:
        if n_dev % (P * spd * epd):
            out.append(error(
                "PLN012", f"{loc}.ep_degree",
                f"ep_degree={epd} x sp_degree={spd} x pp_degree={P} = "
                f"{P * spd * epd} does not divide n_devices={n_dev}: the "
                "expert mesh axis cannot be factored out of the stage "
                "groups (launch/mesh.py)",
                "pp_degree * sp_degree * ep_degree must divide n_devices"))
    if plan.strategies:
        layer_ep = sorted({s.ep for s in plan.strategies})
        if layer_ep[-1] > epd:
            out.append(error(
                "PLN012", f"{loc}.ep_degree",
                f"per-layer strategies reach ep={layer_ep[-1]} but the "
                f"plan stamps ep_degree={epd}: the launcher would build an "
                "expert mesh axis too small for those layers",
                "ep_degree must be max(layer ep degrees)"))
        elif epd > 1 and layer_ep == [1]:
            out.append(warning(
                "PLN012", f"{loc}.ep_degree",
                f"ep_degree={epd} but no layer strategy carries an ep "
                "level: the search only emits ep on MoE-bearing stacks "
                "(the cost model poisons ep > 1 on non-MoE layers and "
                "when n_experts % ep != 0), so the stamp claims an "
                "expert axis nothing uses",
                "re-emit the plan, or drop the ep_degree stamp"))
        elif epd > 1 and len(layer_ep) > 1:
            out.append(info(
                "PLN012", f"{loc}.strategies",
                f"layers mix ep degrees {layer_ep} — the expected shape "
                "for dense+MoE stacks (only MoE layers can shard the "
                "expert axis; the cost model poisons ep > 1 elsewhere)"))

    # --- PLN008: estimator self-consistency -------------------------------
    if plan.est_stage_mem is not None and len(plan.est_stage_mem) != P:
        out.append(warning(
            "PLN008", f"{loc}.est_stage_mem",
            f"est_stage_mem has {len(plan.est_stage_mem)} entries for "
            f"pp_degree={P}"))
    if plan.est_iter_time > 0 and plan.est_throughput > 0:
        implied = plan.global_batch / plan.est_iter_time
        if abs(implied - plan.est_throughput) > 0.05 * plan.est_throughput:
            out.append(warning(
                "PLN008", f"{loc}.est_throughput",
                f"est_throughput={plan.est_throughput:.3f} but "
                f"global_batch/est_iter_time={implied:.3f} "
                "(>5% apart): the estimates were not produced together"))
    if not any(d.severity == "error" for d in out):
        out.append(info(
            "PLN000", loc,
            f"plan certifies: {plan.summary()}"))
    return out


def verify_plan_json(d: Dict, *, strict: bool = False,
                     location: str = "plan") -> List[Diagnostic]:
    """Structural + version + semantic rules on a raw plan dict."""
    out: List[Diagnostic] = []
    if not _check_structure(d, location, out):
        return out
    _check_version(d, location, strict, out)
    if any(x.severity == "error" for x in out):
        return out                # a version error makes loading unsafe
    try:
        plan = ParallelPlan.from_json(d)
    except (ValueError, TypeError) as e:
        out.append(error(
            "PLN009", location,
            f"plan does not construct: {e}",
            "fix the named field"))
        return out
    out.extend(verify_plan(plan, location=location))
    return out


def certify_plan_json(d: Dict, *, strict: bool = False,
                      location: str = "plan") -> DiagnosticReport:
    return DiagnosticReport().extend(
        verify_plan_json(d, strict=strict, location=location))


# ---------------------------------------------------------------------------
# structured loading path (train CLI, tests)
# ---------------------------------------------------------------------------

def load_plan_json(d: Dict, *, strict: bool = False, location: str = "plan"
                   ) -> Tuple[ParallelPlan, DiagnosticReport]:
    """Verify then load a raw plan dict.  Raises
    :class:`~repro_torch.analysis.diagnostics.DiagnosticError` (with the
    offending field in each diagnostic's location) instead of leaking a
    bare ``KeyError`` from ``ParallelPlan.from_json``."""
    report = certify_plan_json(d, strict=strict, location=location)
    report.raise_if_errors(context=location)
    return ParallelPlan.from_json(d), report


def load_plan_file(path: str, *, strict: bool = False
                   ) -> Tuple[ParallelPlan, DiagnosticReport]:
    """Read, verify and load a plan JSON file (the ``--plan`` path of the
    train CLI and the lint CLI)."""
    with open(path) as f:
        try:
            d = json.load(f)
        except json.JSONDecodeError as e:
            report = DiagnosticReport().extend([error(
                "PLN009", f"{path}:{e.lineno}",
                f"not valid JSON: {e.msg}")])
            report.raise_if_errors(context=path)
    report = certify_plan_json(d, strict=strict, location=path)
    report.raise_if_errors(context=path)
    return ParallelPlan.from_json(d), report
