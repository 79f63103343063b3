"""On the card: each cell runs once through ``perfbench/run.py`` and prints
a correct result line; on a machine without one they skip.

    PYTHONPATH=src python3 -m pytest -q perfbench/tests/test_perfbench_card.py
"""
import json
import subprocess
import sys

import pytest
from perfbench_tiny import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
@pytest.mark.parametrize("traced", [0, 1])
def test_cell_runs_correct_on_the_card(card, cell, traced):
    res = subprocess.run(
        [sys.executable, "perfbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 5), "--seconds", "3", "--trace", str(traced)],
        capture_output=True, text=True, timeout=1200, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr[-4000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu"
    assert line["metrics"]
