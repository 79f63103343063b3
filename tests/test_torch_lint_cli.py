"""The port's static-verifier CLI (``python -m repro_torch.analysis``,
``launch/lint.py``) against the reference's (``python -m repro.analysis``):
the same stdout, exit code and ``--report`` JSON for each example plan
(``examples/plans/*.plan.json``, plain, ``--strict`` and ``--verbose``),
for the default schedule grid and a custom one, for a plan that does not
parse, and for a bad grid spec (exit 2 on both).  ``--src`` is the
reference's JAX-pitfall pass, not ported: the port exits 2 naming it.

The calls run ``main(argv)`` in this process with stdout captured, and
both entry points once as ``python -m`` subprocesses.  A report's path
appears in stdout (``wrote <path>``); each side writes its own file, and
the line is compared with the path replaced.
"""
import contextlib
import io
import json
import os
import pathlib
import subprocess
import sys

import pytest

from repro.launch import lint as ref_lint
from repro_torch.launch import lint

REPO = pathlib.Path(__file__).resolve().parent.parent
PLANS = sorted((REPO / "examples" / "plans").glob("*.plan.json"))
GRIDS = [[], ["P=2,4;m=1..8;V=1,2"]]


def _run(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        try:
            rc = main(argv)
        except SystemExit as e:
            rc = e.code
    return rc, out.getvalue()


def _both(argv, tmp_path):
    """(rc, stdout, report) of the reference and of the port."""
    res = []
    for side, main in (("ref", ref_lint.main), ("port", lint.main)):
        report = tmp_path / f"{side}.json"
        rc, out = _run(main, [*argv, "--report", str(report)])
        out = out.replace(str(report), "REPORT")
        res.append((rc, out, json.loads(report.read_text())
                    if report.exists() else None))
    return res


def test_five_example_plans():
    assert len(PLANS) == 5


@pytest.mark.parametrize("flags", [[], ["--strict"], ["--verbose"]],
                         ids=["plain", "strict", "verbose"])
@pytest.mark.parametrize("plan", PLANS, ids=[p.name for p in PLANS])
def test_plan_matches_reference(plan, flags, tmp_path):
    want, got = _both(["--plan", str(plan), *flags], tmp_path)
    assert got == want
    assert got[0] in (0, 1) and got[1].startswith(f"plan {plan}:")


@pytest.mark.parametrize("grid", GRIDS, ids=["default", "custom"])
def test_schedule_grid_matches_reference(grid, tmp_path):
    want, got = _both(["--all-schedules", *grid], tmp_path)
    assert got == want
    assert got[0] == 0 and "schedule grid: certified" in got[1]


def test_all_plans_and_grid_together(tmp_path):
    argv = ["--all-schedules", "P=1,2;m=1..4;V=1"]
    for p in PLANS:
        argv += ["--plan", str(p)]
    want, got = _both(argv, tmp_path)
    assert got == want


def test_unreadable_plan_matches_reference(tmp_path):
    bad = tmp_path / "bad.plan.json"
    bad.write_text("{not json")
    want, got = _both(["--plan", str(bad)], tmp_path)
    assert got == want
    assert got[0] == 1 and "PLN009" in json.dumps(got[2])


@pytest.mark.parametrize("argv", [["--all-schedules", "Q=1"], []],
                         ids=["bad-grid", "nothing-to-do"])
def test_usage_errors_exit_2(argv):
    assert _run(ref_lint.main, argv)[0] == 2
    assert _run(lint.main, argv)[0] == 2


def test_src_is_not_ported():
    err = io.StringIO()
    with contextlib.redirect_stderr(err), pytest.raises(SystemExit) as e:
        lint.main(["--src", "src"])
    assert e.value.code == 2
    assert "jax_lint" in err.getvalue() and "not ported" in err.getvalue()


def test_entry_points_as_modules(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    outs = []
    for mod in ("repro.analysis", "repro_torch.analysis"):
        res = subprocess.run([sys.executable, "-m", mod, "--plan",
                              str(PLANS[0])], capture_output=True, text=True,
                             env=env, timeout=300)
        outs.append((res.returncode, res.stdout))
    assert outs[1] == outs[0]
    res = subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                          "--src", "src"], capture_output=True, text=True,
                         env=env, timeout=300)
    assert res.returncode == 2 and "not ported" in res.stderr
