"""Process groups and device meshes for the port's multi-rank runs.

The JAX package builds its meshes from the devices one process sees
(``repro/launch/mesh.py``).  Here each rank is a process: the caller starts
the processes, gives each its rank, and :func:`init_distributed` joins them
into the default group; a mesh is then a ``DeviceMesh`` over that group:
``("data", "seq")`` for ring attention, ``("pipe", "data")`` for the
pipeline runtime.
Nothing here reads a cluster's environment: the address, world size and rank
are passed in.
"""
from __future__ import annotations

import datetime
import time
from typing import Callable, Optional

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def run_ranks(fn: Callable[..., None], args: tuple, nprocs: int, *,
              timeout_s: Optional[float] = None) -> None:
    """Run ``fn(rank, *args)`` in ``nprocs`` processes started with spawn
    (``fn`` and ``args`` are pickled) and wait for all of them.  Raises
    RuntimeError when a rank fails, or when they outlive ``timeout_s``;
    no process is left running either way."""
    import torch.multiprocessing as mp
    from torch.multiprocessing.spawn import ProcessException

    t0 = time.monotonic()
    ctx = mp.start_processes(fn, args=args, nprocs=nprocs, join=False,
                             start_method="spawn")
    try:
        while not ctx.join(timeout=1):
            if timeout_s is not None and time.monotonic() - t0 > timeout_s:
                raise RuntimeError(f"ranks still running after {timeout_s} s")
    except ProcessException as e:
        raise RuntimeError(f"a rank failed: {e}") from e
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.terminate()
                p.join(10)


def init_distributed(rank: int, world: int, *, backend: str,
                     init_method: str, timeout_s: float = 120.0) -> None:
    """Join this process to the default group as ``rank`` of ``world``.

    ``init_method`` is a rendezvous URL: ``tcp://localhost:<port>``, or
    ``file://<path>`` to a file that no other group uses (the tests' choice,
    so that concurrent test workers never race for a port).  A rendezvous or
    collective that waits longer than ``timeout_s`` raises instead of
    hanging."""
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))


def make_ring_mesh(n_seq: int = 0, n_data: int = 1, *,
                   device_type: str = "cuda") -> DeviceMesh:
    """DP x SP mesh for ring-attention sequence parallelism, with dims
    ``("data", "seq")`` over the already-initialised default group.

    The ``seq`` axis carries the searched ``plan.sp_degree``: K/V panels
    rotate around it (``runtime/sequence.py``) and the token dim of a batch
    splits over it (:func:`~repro_torch.runtime.sequence.shard_sequence`).
    ``n_seq=0`` takes every rank left after the ``data`` axis.  Rank ``r``
    sits at ``(r // n_seq, r % n_seq)``; each dim's process groups are
    created by ``init_device_mesh`` with the default group's backend, so a
    gloo default group gives gloo ``seq`` groups on any ``device_type``."""
    world = dist.get_world_size()
    n_seq = n_seq or world // n_data
    if n_seq * n_data != world:
        raise ValueError(f"a ({n_data}, {n_seq}) mesh needs {n_data * n_seq} "
                         f"ranks; the default group has {world}")
    return init_device_mesh(device_type, (n_data, n_seq),
                            mesh_dim_names=("data", "seq"))


def make_pipeline_mesh(n_stages: int = 2, n_data: int = 4, *,
                       device_type: str = "cuda") -> DeviceMesh:
    """PP x DP mesh for the pipeline runtime (``runtime/pipeline.py``), with
    dims ``("pipe", "data")`` over the already-initialised default group.

    Rank ``r`` sits at ``(r // n_data, r % n_data)``, the JAX package's
    device order for ``make_pipeline_mesh``; the stage hand-offs travel
    over the ``pipe`` groups and the gradient average over the ``data``
    groups, both with the default group's backend."""
    world = dist.get_world_size()
    if n_stages * n_data != world:
        raise ValueError(f"a ({n_stages}, {n_data}) mesh needs "
                         f"{n_stages * n_data} ranks; the default group has "
                         f"{world}")
    return init_device_mesh(device_type, (n_stages, n_data),
                            mesh_dim_names=("pipe", "data"))
