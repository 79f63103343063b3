"""Nothing the benchmark runs imports JAX or the JAX package (compared by
whole top-level module names: ``repro_torch`` is not ``repro``), and the
plain references import nothing of the program."""
import json
import subprocess
import sys

from perfbench_tiny import ROOT

BANNED = {"jax", "jaxlib", "flax", "repro"}


def _loaded_after(code: str) -> set:
    prog = (f"import sys; sys.path[:0] = [{str(ROOT / 'src')!r}, "
            f"{str(ROOT)!r}]\n{code}\nimport json\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in "
            "sys.modules})))")
    res = subprocess.run([sys.executable, "-c", prog], capture_output=True,
                         text=True, timeout=300, cwd=str(ROOT))
    assert res.returncode == 0, res.stderr
    return set(json.loads(res.stdout.strip().splitlines()[-1]))


def test_harness_loads_neither_jax_nor_the_jax_package():
    mods = ["perfbench.run", "perfbench.train", "perfbench.calibrate",
            "perfbench.families.dense", "perfbench.families.ssm",
            "perfbench.reference.dense", "perfbench.reference.ssm"]
    mods += [f"perfbench.metrics.{p.stem}"
             for p in (ROOT / "perfbench" / "metrics").glob("*.py")
             if p.stem != "__init__"]
    code = "\n".join(f"import {m}" for m in mods) + (
        "\nfrom perfbench.families import dense, ssm"
        "\nfrom repro_torch.runtime import executor"
        "\nfrom repro_torch.configs import get_config"
        "\ndense.port_config(__import__('json').load(open("
        "'perfbench/configs/qwen3-8b-l6.json')))")
    loaded = _loaded_after(code)
    assert "repro_torch" in loaded
    assert not loaded & BANNED, loaded & BANNED


def test_reference_imports_nothing_of_the_program():
    loaded = _loaded_after("import perfbench.reference.dense, "
                           "perfbench.reference.ssm, "
                           "perfbench.reference.common")
    assert not loaded & (BANNED | {"repro_torch"})
    for p in (ROOT / "perfbench" / "reference").glob("*.py"):
        for line in p.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]):
                assert not words[1].startswith(("repro", "jax")), line
