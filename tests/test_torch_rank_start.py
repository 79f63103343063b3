"""What a rank pays before its work.

``runtime/sharding.py::abstract_params`` builds every model on the ``meta``
device for each rank's ``ShardContext``; an arithmetic op there runs
PyTorch's Python references, whose first call imports ``torch._dynamo``
(seconds of every rank's start).  ``models/layers.py::randn`` keeps the
draws off them and gives the numbers of the plain draw elsewhere.
``chip_smoke.py``'s ``RankPool`` runs ranks in kept processes: each task as
in a fresh process, a failed or late rank failing the phase."""
import pathlib
import subprocess
import sys
import tempfile

import pytest
import torch

from repro_torch.configs import list_archs
from repro_torch.models.layers import init_dense, randn

torch.set_num_threads(1)

REPO = pathlib.Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("arch", list_archs())
def test_abstract_params_imports_no_dynamo(arch):
    code = ("import sys\n"
            "from repro_torch.configs import get_config\n"
            "from repro_torch.runtime.sharding import abstract_params\n"
            f"p = abstract_params(get_config({arch!r}))\n"
            "assert all(t.device.type == 'meta' for t in p.parameters())\n"
            "print('torch._dynamo' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=REPO, timeout=300,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "False"


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_randn_is_the_plain_draw(dtype):
    g1 = torch.Generator().manual_seed(3)
    g2 = torch.Generator().manual_seed(3)
    got = init_dense(48, 40, dtype, generator=g1, device="cpu")
    want = (torch.randn(48, 40, generator=g2, dtype=torch.float32)
            * 48 ** -0.5).to(dtype)
    assert got.dtype == dtype and torch.equal(got, want)
    meta = randn(5, 7, scale=0.02, dtype=dtype, generator=g1, device="meta")
    assert meta.device.type == "meta" and meta.shape == (5, 7)
    assert meta.dtype == dtype


def _rank(rank, world, run_dir, fail_rank):
    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed

    flags = (torch.backends.cuda.matmul.allow_tf32, torch.get_num_threads())
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{run_dir}/rendezvous")
    t = torch.full((3,), float(rank))
    dist.all_reduce(t)
    torch.backends.cuda.matmul.allow_tf32 = not flags[0]
    torch.set_num_threads(1)
    if rank == fail_rank:
        raise ValueError("rank fails on purpose")
    pathlib.Path(f"{run_dir}/rank{rank}").write_text(
        f"{t.tolist()} {flags}")


def _sleep(rank, seconds):
    import time
    time.sleep(seconds)


@pytest.fixture()
def pool():
    sys.path.insert(0, str(REPO))
    import chip_smoke
    chip_smoke.POOL.open()
    yield chip_smoke
    chip_smoke.POOL.close()
    sys.path.remove(str(REPO))


def test_rank_pool_reuses_processes_as_fresh_ones(pool):
    seen = []
    for _ in range(2):
        d = tempfile.mkdtemp()
        pool.spawn_ranks(_rank, (4, d, -1), 4, "ranks", 120)
        seen.append([pathlib.Path(f"{d}/rank{r}").read_text()
                     for r in range(4)])
    procs = [p.pid for p in pool.POOL.procs]
    assert len(set(procs)) == 4 and all(p.is_alive()
                                        for p in pool.POOL.procs)
    # every rank summed 0 + 1 + 2 + 3, and each task began with the
    # defaults that the task before it changed
    assert seen[0] == seen[1]
    assert all(s.startswith("[6.0, 6.0, 6.0]") for s in seen[0])
    assert len({s for s in seen[0]}) == 1


def test_rank_pool_fails_the_phase_and_closes(pool):
    with pytest.raises(pool.Failed, match="rank 2 failed"):
        pool.spawn_ranks(_rank, (4, tempfile.mkdtemp(), 2), 4, "ranks", 120)
    assert pool.POOL.procs == []
    pool.POOL.open()
    with pytest.raises(pool.Failed, match="still running after 2 s"):
        pool.spawn_ranks(_sleep, (60,), 1, "late", 2)
    assert pool.POOL.procs == []
