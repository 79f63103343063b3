"""Process groups and device meshes for the port's multi-rank runs.

The JAX package builds its meshes from the devices one process sees
(``repro/launch/mesh.py``).  Here each rank is a process: the caller starts
the processes, gives each its rank, and :func:`init_distributed` joins them
into the default group; a mesh is then a ``DeviceMesh`` over that group:
``("data", "seq")`` for ring attention, ``("pipe", "data")`` for the
pipeline runtime, ``("data", "model")`` and ``("data", "expert")`` for the
sharded executor.
Nothing here reads a cluster's environment: the address, world size and rank
are passed in.  :func:`make_production_mesh` is a mapping, not a mesh: the
dry run's cluster, which no process joins.
"""
from __future__ import annotations

import datetime
import time
from typing import Callable, Dict, Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device

# a rendezvous or collective of the drivers' ranks that waits longer raises
# instead of hanging
RANK_TIMEOUT_S = 900.0


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


def join_rank(rank: int, world: int, run_dir: str,
              device: str) -> torch.device:
    """Start a rank of a driver's run (``train --ranks``, ``serve
    --ranks``): its device (ranks share cards round-robin; one thread on
    the CPU) and the gloo default group over ``run_dir``'s rendezvous
    file."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    else:
        torch.set_num_threads(1)
    init_distributed(rank, world, backend="gloo",
                     init_method=f"file://{run_dir}/rendezvous",
                     timeout_s=RANK_TIMEOUT_S)
    return resolve_device(dev.type)


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    """The production cluster as a mapping of axis name to size, for the dry
    run (``launch/dryrun.py``, ``runtime/dry.py::DryMesh``): 256 H100s as
    ``{"data": 32, "model": 8}`` (``core/hardware.py::h100_cluster(256)``,
    nodes of 8 cards on NVLink), or two such pods, 512 cards, as ``{"pod":
    2, "data": 32, "model": 8}``.

    A deliberate difference: the reference's 16 x 16 TPU torus
    (``repro/launch/mesh.py``) puts 16 ranks on ``model``.  The port's
    head-aligned TP refuses that for every arch with 8 KV heads
    (``runtime/sharding.py::_check_tp``), and TP 16 would leave the NVLink
    island of 8.  The card counts, 256 and 512, are the reference's."""
    if multi_pod:
        return {"pod": 2, "data": 32, "model": 8}
    return {"data": 32, "model": 8}


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


def make_expert_mesh(n_ep: int = 0, n_data: int = 1, *,
                     device_type: str = "cuda") -> DeviceMesh:
    """DP x EP mesh for expert parallelism, with dims ``("data",
    "expert")`` over the already-initialised default group.

    The ``expert`` axis carries the searched ``plan.ep_degree``: expert
    weights shard over it (``runtime/sharding.py``), the batch dim
    co-shards over data x expert, and MoE dispatch runs the all-to-all path
    (``models/moe.py::_moe_ep``).  ``n_ep=0`` takes every rank left after
    the ``data`` axis.  Rank ``r`` sits at ``(r // n_ep, r % n_ep)``."""
    world = dist.get_world_size()
    n_ep = n_ep or world // n_data
    if n_ep * n_data != world:
        raise ValueError(f"a ({n_data}, {n_ep}) mesh needs {n_data * n_ep} "
                         f"ranks; the default group has {world}")
    return init_device_mesh(device_type, (n_data, n_ep),
                            mesh_dim_names=("data", "expert"))


def make_local_mesh(model: int = 1, *,
                    device_type: str = "cuda") -> DeviceMesh:
    """DP x TP mesh over every rank of the already-initialised default
    group, with dims ``("data", "model")`` (the JAX package's
    ``make_local_mesh``, whatever this host offers).  ``model`` is capped
    at the world size; rank ``r`` sits at ``(r // model, r % model)``, so a
    ``model`` group holds consecutive ranks.  The sharded executor
    (``runtime/sharding.py``) runs on it."""
    world = dist.get_world_size()
    model = min(model, world)
    if world % model:
        raise ValueError(f"a model axis of {model} does not divide the "
                         f"{world} ranks of the default group")
    return init_device_mesh(device_type, (world // model, model),
                            mesh_dim_names=("data", "model"))
