"""The port stands alone: ``repro_torch`` imports neither ``jax`` nor
anything of ``repro``, nor ``triton`` (every kernel is CUDA C++), not even
through its copies of the NumPy search engine and plan layer (``core``,
``analysis``, ``launch.search``, ``serving.slo_search``) nor through the
checkpoint store, the profiler and the pipeline runtime, nor through the
sharded executor, the plan bridge and the memory model, nor through the
dry-run tools (the dry run, hillclimb, the lint CLI and its ``python -m
repro_torch.analysis`` entry), and keeps the JAX package's source linter
green."""
import ast
import os
import pathlib
import subprocess
import sys

import torch

from repro.analysis.jax_lint import lint_paths

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "src" / "repro_torch"


def test_import_loads_no_jax_triton_or_repro():
    code = ("import sys, repro_torch, repro_torch.launch.serve, "
            "repro_torch.launch.train, repro_torch.serving, "
            "repro_torch.bridge, repro_torch.models.ssm, "
            "repro_torch.models.moe, repro_torch.configs.arctic_480b, "
            "repro_torch.configs.kimi_k2_1t_a32b, "
            "repro_torch.kernels.ssd_scan, repro_torch.kernels.ops, "
            "repro_torch.optim, repro_torch.data, "
            "repro_torch.runtime.executor, repro_torch.runtime.sequence, "
            "repro_torch.launch.mesh, repro_torch.kernels.ring_attention, "
            "repro_torch.core, repro_torch.analysis, "
            "repro_torch.launch.search, repro_torch.serving.slo_search, "
            "repro_torch.runtime.schedules, repro_torch.configs.specs, "
            "repro_torch.configs.paper_models, repro_torch.checkpointing, "
            "repro_torch.checkpointing.store, repro_torch.core.profiler, "
            "repro_torch.runtime.pipeline, repro_torch.runtime.sharding, "
            "repro_torch.runtime.plan_bridge, repro_torch.roofline, "
            "repro_torch.roofline.analysis, repro_torch.runtime, "
            "repro_torch.launch.dryrun, repro_torch.launch.hillclimb, "
            "repro_torch.launch.lint, repro_torch.launch.inputs, "
            "repro_torch.analysis.__main__, repro_torch.runtime.dry, "
            "repro_torch.kernels.meta; "
            "print(sorted({m.split('.')[0] for m in sys.modules} "
            "& {'jax', 'jaxlib', 'triton', 'repro'}))")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=str(REPO / "src")))
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "[]"


def _imports(tree: ast.Module):
    """The root module name of every absolute import, wherever it stands."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module.split(".")[0]


def test_no_port_file_imports_jax_or_repro():
    files = sorted(PORT.rglob("*.py"))
    assert len(files) > 15
    for f in files:
        for name in _imports(ast.parse(f.read_text())):
            assert name not in ("jax", "jaxlib", "repro", "triton"), \
                f"{f}: {name}"


def test_port_lints_clean_under_the_jax_linter():
    assert lint_paths([str(PORT)]) == []
