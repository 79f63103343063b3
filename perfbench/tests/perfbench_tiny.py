"""Tiny cells of both families for the CPU tests: the program's plain
paths at small widths in fp32, the step settings and limits of each
family's cell.  A cell is read from its files (``perfbench/workloads/``,
``configs/``, ``traffic/``), so a family whose cell ``BENCHMARK.json``
does not list is tested all the same."""
from __future__ import annotations

import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for _p in (str(ROOT / "src"), str(ROOT)):
    if _p not in sys.path:
        sys.path.insert(0, _p)

from perfbench import spec  # noqa: E402

# family: (cell, configuration, traffic)
CELLS = {"dense": ("qwen3-8b-l6.train.s4k", "qwen3-8b-l6", "train.s4k"),
         "ssm": ("mamba2-370m.train.s2k", "mamba2-370m", "train.s2k")}


def tiny(family: str, dtype: str = "float32"):
    """(cell, base config) of ``family`` at tiny widths, with the settings
    and limits of the family's benchmark cell."""
    from repro_torch.configs import get_config

    name, config, traffic = CELLS[family]
    files = ROOT / "perfbench"
    real_spec = spec.load_json(files / "workloads" / f"{name}.json")
    real_config = spec.load_json(files / "configs" / f"{config}.json")
    real_traffic = spec.load_json(files / "traffic" / f"{traffic}.json")
    if family == "dense":
        conf = dict(real_config, hidden_size=128, intermediate_size=256,
                    num_attention_heads=4, num_key_value_heads=2,
                    head_dim=32, num_hidden_layers=2, vocab_size=512,
                    torch_dtype=dtype)
        base = get_config("qwen3-8b").with_(
            d_model=128, d_ff=256, n_heads=4, n_kv_heads=2, head_dim=32,
            vocab_size=512)
    else:
        conf = dict(real_config, d_model=128, n_layer=2, vocab_size=512,
                    d_state=16, headdim=32, chunk_size=16, torch_dtype=dtype)
        base = get_config("mamba2-370m").with_(
            d_model=128, vocab_size=512, ssm_state=16, ssm_head_dim=32,
            ssm_chunk=16)
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = spec.Cell(
        name=name, entry={"name": name, "config": config,
                          "traffic": traffic, "chips": 1},
        spec=real_spec, config=conf,
        traffic=dict(real_traffic, batch=2, seq=64, distinct_batches=4),
        end_to_end=[m for m in bench["end_to_end"]
                    if "mfu" not in m["name"]],
        per_layer=[])
    return cell, base
