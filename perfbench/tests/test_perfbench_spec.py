"""BENCHMARK.json against the contract's shape, and every file it names."""
import importlib
import json
import re

import pytest
from perfbench_tiny import ROOT

from perfbench import spec

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")
WIDTH = re.compile(r"(hidden_size|intermediate|latent|state|_dim$|_rank$|"
                   r"headdim|expand|d_model|d_inner|d_ff|experts_per_tok)")


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "perfbench/run.py"]
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lengths():
    names = ([c["name"] for c in BENCH["configs"]]
             + [w["name"] for w in BENCH["workloads"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    assert len(names) == len(set(names))
    for n in names + [w["traffic"] for w in BENCH["workloads"]]:
        assert NAME.fullmatch(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    for e in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for c in BENCH["configs"]:
        assert len(c["reduced"]) <= 16
        for k in c["reduced"]:
            assert NAME.fullmatch(k) and not WIDTH.search(k), k


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_has_its_files_and_metrics(w):
    cell = spec.load_cell(w["name"], ROOT)
    assert w["chips"] in (1, 4)
    conf = next(c for c in BENCH["configs"] if c["name"] == w["config"])
    assert conf["file"].startswith("perfbench/")
    for k in conf["reduced"]:
        assert k in cell.config["reduced"], k
    for mod in ("families", "reference", "counts"):
        importlib.import_module(f"perfbench.{mod}.{cell.config['family']}")
    e2e = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer
    for m in cell.end_to_end + cell.per_layer:
        assert (ROOT / "perfbench" / "metrics" / f"{m['name']}.py").exists()
    for m in cell.per_layer:
        assert m["moves"] in e2e
    assert cell.spec["limits"] and set(cell.spec["limits"]) <= {
        "loss_gap", "grad_gap", "grad_gap_median", "change_gap"}


def test_metric_entries():
    cells = {w["name"] for w in BENCH["workloads"]}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert set(m.get("workloads", cells)) <= cells
        mod = importlib.import_module(f"perfbench.metrics.{m['name']}")
        assert hasattr(mod, "WRAPS") and hasattr(mod, "BACKWARD_NODES")
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "roofline" in m["name"]:
            assert m["unit"] == "%"


def test_harness_names_no_cell_config_or_metric():
    """New cells, configurations and metrics are new files only."""
    words = ([w["name"] for w in BENCH["workloads"]]
             + [c["name"] for c in BENCH["configs"]]
             + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]])
    for f in ("run.py", "train.py", "spec.py", "trace.py", "judge.py",
              "traffic.py", "weights.py", "peaks.py", "calibrate.py"):
        text = (ROOT / "perfbench" / f).read_text()
        for w in words:
            assert not re.search(rf"\b{re.escape(w)}\b", text), (f, w)
