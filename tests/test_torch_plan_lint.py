"""The port's plan and schedule verifiers against the JAX package's.

The same plan dicts (the corrupted plans of ``tests/test_plan_lint.py``,
the SP, EP and serving rules' cases, every example plan) go through both
packages' ``verify_plan_json`` / ``load_plan_json`` / ``load_plan_file``:
the diagnostics must be equal, rule, severity, location, message and hint,
in the same order.  ``compile_schedule`` must give equal tick tables over
the verifier's acceptance grid (``DEFAULT_GRID``), and ``verify_program``
equal verdicts on those tables and on ``tests/test_schedule_lint.py``'s
seeded mutations.
"""
import copy
import dataclasses
import importlib
import json
import pathlib

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
EXAMPLE_PLANS = sorted((REPO / "examples" / "plans").glob("*.plan.json"))
PKGS = ("repro", "repro_torch")


def _m(pkg, name):
    return importlib.import_module(f"{pkg}.{name}")


def _diags(diags):
    return [d.to_json() for d in diags]


def _base_plan(**kw):
    """``tests/test_plan_lint.py::make_plan()`` as a dict."""
    from repro_torch.core import ParallelPlan, enumerate_strategies
    base = dict(n_devices=8, pp=2, layers=8, schedule="1f1b", m=4, V=1,
                batch=32, strategy=None)
    base.update(kw)
    pp, layers = base["pp"], base["layers"]
    s = base["strategy"] or enumerate_strategies(base["n_devices"] // pp)[0]
    per = layers // pp
    return ParallelPlan(
        n_devices=base["n_devices"], pp_degree=pp,
        partition=[per] * (pp - 1) + [layers - per * (pp - 1)],
        strategies=[s] * layers, global_batch=base["batch"],
        n_micro=base["m"], schedule=base["schedule"],
        vpp_degree=base["V"]).to_json()


def _set(**fields):
    def mutate(d):
        d.update(fields)
    return mutate


def _drop(*keys):
    def mutate(d):
        for k in keys:
            d.pop(k, None)
    return mutate


def _strategy(j, value):
    def mutate(d):
        d["strategies"][j] = value
    return mutate


def _serving(**fields):
    def mutate(d):
        d["serving"].update(fields)
    return mutate


V0_KEYS = ("format_version", "schedule", "vpp_degree", "est_iter_time",
           "est_throughput", "est_stage_mem", "alpha_t", "alpha_m",
           "searched_by", "search_stats")
SLO_PLAN = "bert-huge-32_8dev_slo30ms.plan.json"
SP_PLAN = "qwen3-4b_seq128k_16dev_32gb_sp.plan.json"
EP_PLAN = "moe-8e_8dev_6gb_ep.plan.json"

# (name, base plan dict or example file, mutation)
PLAN_CASES = [
    ("valid", None, lambda d: None),
    ("partition-sum", None, _set(partition=[3, 4])),
    ("partition-empty-stage", None, _set(partition=[8, 0])),
    ("missing-partition", None, _drop("partition")),
    ("missing-n_micro", None, _drop("n_micro")),
    ("future-version", None, _set(format_version=6)),
    ("v0", None, _drop(*V0_KEYS)),
    ("v1", None, _drop("vpp_degree", "search_stats")),
    ("wrong-strategy-total", None,
     lambda d: d.update(strategies=[{"levels": [["dp", 3]], "ckpt": False}]
                        * 8)),
    ("broken-strategy-entry", None, _strategy(2, {"levels": "zzz"})),
    ("interleaved-without-vpp", None, _set(schedule="1f1b-interleaved")),
    ("zb-h1-m-below-pp", None, _set(schedule="zb-h1", n_micro=1)),
    ("unknown-schedule", None, _set(schedule="pipedream")),
    ("pp-not-dividing", None, _set(pp_degree=3, partition=[3, 3, 2])),
    ("batch-not-divisible", None, _set(n_micro=3)),
    ("serving-clean", SLO_PLAN, lambda d: None),
    ("serving-tp", SLO_PLAN, _serving(decode_tp=3)),
    ("serving-page-size", SLO_PLAN, _serving(page_size=0)),
    ("serving-context", SLO_PLAN, _serving(max_context=500)),
    ("serving-pool", SLO_PLAN, _serving(kv_pool_pages=1)),
    ("serving-batch", SLO_PLAN, _serving(decode_batch=0)),
    ("serving-est", SLO_PLAN, _serving(est_tok_ms=99.0)),
    ("sp-clean", SP_PLAN, lambda d: None),
    ("sp-degree-3", SP_PLAN, _set(sp_degree=3)),
    ("sp-seq-not-dividing", SP_PLAN, _set(seq_len=131071)),
    ("sp-no-seq", SP_PLAN, _set(seq_len=0)),
    ("ep-clean", EP_PLAN, lambda d: None),
    ("ep-degree-3", EP_PLAN, _set(ep_degree=3)),
    ("ep-degree-2", EP_PLAN, _set(ep_degree=2)),
    ("ep-unused-axis", None, _set(ep_degree=2)),
]


def _plan_dict(base, mutate):
    d = (_base_plan() if base is None else
         json.loads((REPO / "examples" / "plans" / base).read_text()))
    d = copy.deepcopy(d)
    mutate(d)
    return d


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("name,base,mutate", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_plan_lint_diagnostics_equal_the_reference(name, base, mutate,
                                                   strict):
    d = _plan_dict(base, mutate)
    ref, port = (_diags(_m(pkg, "analysis").verify_plan_json(
        copy.deepcopy(d), strict=strict)) for pkg in PKGS)
    assert port == ref
    if name != "valid" and not name.endswith("-clean"):
        assert port, f"{name}: the corruption raised no diagnostic"


def _load(pkg, d, strict):
    """``load_plan_json``'s outcome: the plan's canonical bytes and the
    report, or the error's diagnostics."""
    an = _m(pkg, "analysis")
    try:
        plan, report = an.load_plan_json(copy.deepcopy(d), strict=strict)
    except an.DiagnosticError as e:
        return "error", _diags(e.diagnostics)
    return plan.canonical_dumps(), _diags(report.diagnostics)


@pytest.mark.parametrize("strict", [False, True])
@pytest.mark.parametrize("name,base,mutate", PLAN_CASES,
                         ids=[c[0] for c in PLAN_CASES])
def test_load_plan_json_equals_the_reference(name, base, mutate, strict):
    d = _plan_dict(base, mutate)
    assert _load("repro_torch", d, strict) == _load("repro", d, strict)


def test_strict_rejects_a_v0_plan_with_pln001_as_the_reference():
    d = _plan_dict(None, _drop(*V0_KEYS))
    from repro_torch.analysis import DiagnosticError, load_plan_json
    with pytest.raises(DiagnosticError) as ei:
        load_plan_json(d, strict=True)
    assert ei.value.rules() == ["PLN001"]
    assert _load("repro_torch", d, True) == _load("repro", d, True)


@pytest.mark.parametrize("path", EXAMPLE_PLANS, ids=lambda p: p.name)
def test_example_plan_files_certify_as_in_the_reference(path):
    outs = []
    for pkg in PKGS:
        plan, report = _m(pkg, "analysis").load_plan_file(str(path))
        outs.append((plan.canonical_dumps(), _diags(report.diagnostics)))
    assert outs[1] == outs[0]
    assert not [d for d in outs[1][1] if d["severity"] == "error"]


@pytest.mark.parametrize("text", ["{not json", "[1, 2]", "{}"])
def test_broken_plan_files_raise_the_reference_diagnostics(text, tmp_path):
    path = tmp_path / "broken.plan.json"
    path.write_text(text)
    outs = []
    for pkg in PKGS:
        an = _m(pkg, "analysis")
        with pytest.raises(an.DiagnosticError) as ei:
            an.load_plan_file(str(path))
        outs.append((ei.value.rules(), _diags(ei.value.diagnostics),
                     str(ei.value)))
    assert outs[1] == outs[0]


def test_plan_lint_over_a_grid_of_degree_tuples_equals_the_reference():
    """The reference's fuzz tests' space (device counts, pipeline degrees,
    micro-batches, strategies, schedules) walked exhaustively on both."""
    from repro_torch.core import Strategy, enumerate_strategies
    n_cases = 0
    for log_dev in range(4):
        n_devices = 2 ** log_dev
        for pp in (p for p in (1, 2, 4, 8) if p <= n_devices):
            group = n_devices // pp
            strategies = enumerate_strategies(group) + [
                Strategy((("dp", 2 * group),))]
            for m in (1, 2, 3, 4):
                for schedule, V in (("gpipe", 1), ("1f1b", 1), ("zb-h1", 1),
                                    ("1f1b-interleaved", 2)):
                    for s in strategies[::3]:
                        d = _base_plan(n_devices=n_devices, pp=pp,
                                       layers=4 * pp, schedule=schedule,
                                       m=m, V=V, batch=8 * m, strategy=s)
                        ref, port = (_diags(_m(pkg, "analysis")
                                            .verify_plan_json(d))
                                     for pkg in PKGS)
                        assert port == ref, (n_devices, pp, m, schedule, s)
                        n_cases += 1
    assert n_cases > 300


def _grid():
    from repro_torch.analysis import schedule_grid
    grid = list(schedule_grid())
    from repro.analysis import schedule_grid as jax_grid
    assert grid == list(jax_grid())
    return grid


TABLES = ("mb_index", "chunk_index", "valid", "loss_valid", "phase")


def _same_program(ref, port):
    assert (port.name, port.n_stages, port.n_micro, port.n_chunks,
            port.n_ticks, port.remat) == (ref.name, ref.n_stages, ref.n_micro,
                                          ref.n_chunks, ref.n_ticks,
                                          ref.remat)
    for f in TABLES:
        a, b = getattr(ref, f), getattr(port, f)
        assert b.dtype == a.dtype, f
        np.testing.assert_array_equal(b, a, err_msg=f)


@pytest.mark.parametrize("name,P,m,V", _grid(), ids=lambda v: str(v))
def test_schedule_tables_and_verdicts_equal_the_reference(name, P, m, V):
    progs = [_m(pkg, "runtime.schedules").compile_schedule(
        name, P, m, V if V > 1 else None) for pkg in PKGS]
    _same_program(*progs)
    _same_program(progs[0].forward_program(), progs[1].forward_program())
    ref, port = (_diags(_m(pkg, "analysis").verify_program(pr))
                 for pkg, pr in zip(PKGS, progs))
    assert port == ref
    assert not [d for d in port if d["severity"] == "error"]


def test_schedule_legal_equals_the_reference():
    from repro.analysis import schedule_legal as jax_legal
    from repro_torch.analysis import schedule_legal
    for name in ("gpipe", "1f1b", "1f1b-interleaved", "zb-h1", "pipedream"):
        for P in (1, 2, 3, 4, 8):
            for m in range(1, 17):
                for V in (1, 2, 3):
                    assert schedule_legal(name, P, m, V) == \
                        jax_legal(name, P, m, V), (name, P, m, V)


def _mutable(pr):
    return dataclasses.replace(
        pr, mb_index=pr.mb_index.copy(), chunk_index=pr.chunk_index.copy(),
        valid=pr.valid.copy(), loss_valid=pr.loss_valid.copy(),
        phase=None if pr.phase is None else pr.phase.copy())


def _swap_ticks(pr):
    ts = [t for t in range(pr.n_ticks) if pr.valid[t, 0]][3:5]
    for a in (pr.mb_index, pr.chunk_index, pr.phase):
        a[ts[0], 0], a[ts[1], 0] = int(a[ts[1], 0]), int(a[ts[0], 0])


def _drop_f(pr):
    for t in range(pr.n_ticks):
        if pr.valid[t, 1] and pr.phase[t, 1] == 0 and pr.mb_index[t, 1] == 3:
            pr.valid[t, 1] = False


def _inflate(pr):
    tb = next(t for t in range(pr.n_ticks)
              if pr.valid[t, 0] and pr.phase[t, 0] == 1)
    tf = next(t for t in range(tb + 1, pr.n_ticks)
              if pr.valid[t, 0] and pr.phase[t, 0] == 0)
    for a in (pr.mb_index, pr.chunk_index, pr.phase):
        a[tb, 0], a[tf, 0] = int(a[tf, 0]), int(a[tb, 0])


def _orphan_w(pr):
    tw = next(t for t in range(pr.n_ticks)
              if pr.valid[t, 2] and pr.phase[t, 2] == 2)
    pr.mb_index[tw, 2] = (int(pr.mb_index[tw, 2]) + 1) % pr.n_micro


def _w_without_b(pr):
    tb = next(t for t in range(pr.n_ticks)
              if pr.valid[t, 1] and pr.phase[t, 1] == 1
              and pr.mb_index[t, 1] == 2)
    pr.valid[tb, 1] = False


def _retarget(pr):
    t = next(t for t in range(pr.n_ticks) if pr.valid[t, 2])
    pr.mb_index[t, 2] = (int(pr.mb_index[t, 2]) + 1) % pr.n_micro


def _flush_order(pr):
    f = [t for t in range(pr.n_ticks)
         if pr.valid[t, 0] and pr.phase[t, 0] == 0][:2]
    a = pr.mb_index
    a[f[0], 0], a[f[1], 0] = int(a[f[1], 0]), int(a[f[0], 0])


def _loss_on_stage_0(pr):
    t = next(t for t in range(pr.n_ticks) if pr.valid[t, 0])
    pr.loss_valid[t, 0] = True


def _bad_index(pr):
    t = next(t for t in range(pr.n_ticks) if pr.valid[t, 1])
    pr.mb_index[t, 1] = pr.n_micro + 3


# (name, schedule args, in-place mutation), after tests/test_schedule_lint.py
MUTATIONS = [
    ("swap-two-ticks", ("zb-h1", 4, 8), _swap_ticks),
    ("drop-dependency-edge", ("zb-h1", 4, 8), _drop_f),
    ("inflate-inflight-cap", ("zb-h1", 4, 8), _inflate),
    ("orphan-w-tick", ("zb-h1", 4, 8), _orphan_w),
    ("w-without-b", ("zb-h1", 2, 4), _w_without_b),
    ("interleaved-handoff", ("1f1b-interleaved", 4, 8, 2), _retarget),
    ("three-phase-flush-order", ("zb-h1", 2, 4), _flush_order),
    ("loss-on-wrong-stage", ("gpipe", 4, 6), _loss_on_stage_0),
    ("malformed-indices", ("gpipe", 4, 6), _bad_index),
]


@pytest.mark.parametrize("name,args,mutate", MUTATIONS,
                         ids=[c[0] for c in MUTATIONS])
def test_verify_program_flags_mutations_as_the_reference(name, args, mutate):
    out = []
    for pkg in PKGS:
        pr = _mutable(_m(pkg, "runtime.schedules").compile_schedule(*args))
        mutate(pr)
        out.append(_diags(_m(pkg, "analysis").verify_program(pr)))
    assert out[1] == out[0]
    assert [d for d in out[1] if d["severity"] == "error"], name


@pytest.mark.parametrize("args", [("1f1b-interleaved", 4, 6, 2),
                                  ("zb-h1", 4, 2)])
def test_compile_validate_raises_as_the_reference(args):
    out = []
    for pkg in PKGS:
        an = _m(pkg, "analysis")
        with pytest.raises(an.DiagnosticError) as ei:
            _m(pkg, "runtime.schedules").compile_schedule(*args,
                                                          validate=True)
        out.append((ei.value.rules(), str(ei.value)))
    assert out[1] == out[0]
