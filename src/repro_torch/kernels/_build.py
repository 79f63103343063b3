"""Build the CUDA C++ kernels of ``repro_torch/csrc/`` at first use.

Each source is compiled by ``nvcc`` into a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds) and loaded with
``ctypes``.  Libraries go to ``build/kernels/`` at the root of the checkout,
named by a hash of the source so that an edited kernel is rebuilt.  The
compiler's output, including ``-Xptxas -v`` (registers, shared memory,
spills), is kept beside each library as ``<name>-<hash>.log``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (on PATH or under $CUDA_HOME/bin); "
                       "the CUDA kernels cannot be built")


def build(name: str, defines: tuple = ()) -> pathlib.Path:
    """Compile ``csrc/<name>.cu`` (with ``-D`` of each of ``defines``)
    unless its library is already built; return the library's path, or
    raise with the compiler's output if ``nvcc`` fails."""
    flags = NVCC_FLAGS + [f"-D{d}" for d in defines]
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(flags).encode()).hexdigest()[:12]
    out = BUILD_DIR / f"{name}-{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([_nvcc(), *flags, "-o", str(tmp),
                          str(CSRC / f"{name}.cu")],
                         capture_output=True, text=True)
    out.with_suffix(".log").write_text(res.stdout + res.stderr)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed on csrc/{name}.cu "
                           f"(rc {res.returncode}):\n{res.stderr}")
    os.replace(tmp, out)
    return out


def load(name: str, defines: tuple = ()) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<name>.cu`` as a ctypes library."""
    return ctypes.CDLL(str(build(name, defines)))
