"""Profiled per-layer execution times (paper §V: "computation time ...
measured by profiling the real layer execution time on a single device"):
the port's copy of ``repro/core/profiler.py``, with the reference's names
and arithmetic, timed with PyTorch.

The analytic cost model divides FLOPs by peak x MFU; profiling replaces
that guess with a measured per-sample time for each distinct layer kind.
``profile_layerspecs`` times a matmul-equivalent workload of each LayerSpec
on the device and returns {layer_name: sec/sample}, which
``CostModel(..., profiled_times=...)`` consumes directly.

Timing: one warm-up call, then CUDA events around the timed calls on a
CUDA device (the host clock on the CPU).  The chain is fp32 as in the
reference, with PyTorch's default of no TF32 for fp32 matmuls.  Collectives
are measured over the ``torch.distributed`` default group; the fingerprint
that keys the cache names that group's backend, so that a gloo group over
one card never poses as NVLink.  The cache lives apart from the reference's
(``$REPRO_TORCH_COLLECTIVES_CACHE``, else
``~/.cache/repro_torch/collectives.json``).
"""
from __future__ import annotations

import json
import os
import pathlib
import time
from typing import Callable, Dict, List, Optional, Sequence, Union

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

from .hardware import COLLECTIVE_KINDS, ClusterSpec, CollectiveProfile
from .layerspec import LayerSpec


def _time_fn(fn, *args, iters: int = 3,
             device: Union[str, torch.device] = "cuda") -> float:
    """Seconds per call of ``fn(*args)`` after one warm-up call."""
    dev = torch.device(device)
    fn(*args)
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn(*args)
        return (time.perf_counter() - t0) / iters
    torch.cuda.synchronize(dev)
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(iters):
        fn(*args)
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def measure_matmul_throughput(d: int = 1024, iters: int = 5, *,
                              device: Union[str, torch.device] = "cuda"
                              ) -> float:
    """Achieved dense FLOP/s of this device (the profiling yardstick)."""
    dev = resolve_device(device)
    a = torch.ones((d, d), dtype=torch.float32, device=dev)
    b = torch.ones((d, d), dtype=torch.float32, device=dev)
    t = _time_fn(torch.matmul, a, b, iters=iters, device=dev)
    return 2.0 * d ** 3 / max(t, 1e-9)


def profile_layerspecs(specs: Sequence[LayerSpec], *,
                       device_peak_flops: Optional[float] = None,
                       iters: int = 3,
                       device: Union[str, torch.device] = "cuda"
                       ) -> Dict[str, float]:
    """Per-sample forward time for each distinct layer.

    We time a matmul workload with the same FLOP count as the layer (the
    Transformer layers are >95% dense algebra — §II-A), then, if the
    *target* device differs from the profiling host, rescale by the ratio
    of achieved throughputs.  Duplicate layer names share measurements.
    """
    dev = resolve_device(device)
    achieved = measure_matmul_throughput(device=dev)
    scale = 1.0
    if device_peak_flops is not None:
        # translate host-measured seconds to the target device
        scale = achieved / (0.45 * device_peak_flops)
    out: Dict[str, float] = {}
    by_flops: Dict[float, float] = {}
    for s in specs:
        if s.name in out:
            continue
        key = round(s.flops_per_sample, 3)
        if key not in by_flops:
            # time a matmul chain with ~the same FLOPs (capped for speed)
            f = min(s.flops_per_sample, 2e10)
            d = max(64, int((f / 2) ** (1.0 / 3.0)))
            d = min(d, 1024)
            reps = max(1, int(f / (2.0 * d ** 3)))
            a = torch.ones((d, d), dtype=torch.float32, device=dev)

            def chain(x, reps=reps):
                for _ in range(min(reps, 16)):
                    x = x @ x * 0.5
                return x

            t = _time_fn(chain, a, iters=iters, device=dev)
            t *= max(1, reps) / max(1, min(reps, 16))
            t *= s.flops_per_sample / max(f, 1.0)
            by_flops[key] = t * scale
        out[s.name] = by_flops[key]
    return out


# --------------------------------------------------------------------------
# collective microbenchmarks → latency/bandwidth pairs for the cost model
# --------------------------------------------------------------------------

def _group_backend() -> Optional[str]:
    """The default group's backend, or None without one."""
    if dist.is_available() and dist.is_initialized():
        return str(dist.get_backend())
    return None


def device_fingerprint(device: Union[str, torch.device, None] = None
                       ) -> str:
    """Stable id of the local accelerator configuration — the JSON-cache key.

    ``platform:device_kind:count``: the platform is ``cuda`` or ``cpu``,
    joined by ``+`` to the default group's backend when a group exists
    (``cuda+gloo``, ``cuda+nccl``); the count is the group's world size,
    else the devices of that platform this process sees.  For example
    ``cuda+nccl:NVIDIA-H100-80GB-HBM3:4`` or ``cpu:cpu:1``.  Profiles
    measured on one fingerprint never leak onto another machine shape, and
    a gloo group over one card is never taken for NVLink.  ``device``
    defaults to the CUDA device when one is visible, else the CPU: the
    fingerprint describes the host, it computes nothing."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.is_available():
        kind = torch.cuda.get_device_name(dev).replace(" ", "-")
        count = torch.cuda.device_count()
    else:
        kind, count = dev.type, 1
    platform = dev.type
    backend = _group_backend()
    if backend is not None:
        platform = f"{platform}+{backend}"
        count = dist.get_world_size()
    return f"{platform}:{kind}:{count}"


def _lstsq_latency_bandwidth(byte_sizes: Sequence[float],
                             times: Sequence[float]) -> CollectiveProfile:
    """Least-squares fit of ``t = latency + bytes / bandwidth``.

    Latency is clamped to >= 0 (a negative intercept just means the small
    messages already saturated the link) and bandwidth to > 0."""
    import numpy as np
    x = np.asarray(byte_sizes, float)
    y = np.asarray(times, float)
    a = np.stack([np.ones_like(x), x], axis=1)
    (lat, inv_bw), *_ = np.linalg.lstsq(a, y, rcond=None)
    if inv_bw <= 0.0:
        # degenerate fit (timer noise dominates): charge everything to
        # bandwidth at the mean observed rate
        inv_bw = float(np.mean(y / np.maximum(x, 1.0)))
        lat = 0.0
    return CollectiveProfile(latency_s=max(0.0, float(lat)),
                             bus_bandwidth=1.0 / float(inv_bw),
                             n_samples=len(x))


def _collective_ops(n: int, rank: int) -> Dict[str, Callable]:
    """The four kinds over the default group, each ``op(x)`` on a flat
    tensor of a multiple of ``n`` elements."""
    all_gather = getattr(dist, "all_gather_single", None) \
        or dist.all_gather_into_tensor
    reduce_scatter = getattr(dist, "reduce_scatter_single", None) \
        or dist.reduce_scatter_tensor
    nxt, prv = (rank + 1) % n, (rank - 1) % n

    def ppermute(x):
        out = torch.empty_like(x)
        for req in dist.batch_isend_irecv([dist.P2POp(dist.isend, x, nxt),
                                           dist.P2POp(dist.irecv, out, prv)]):
            req.wait()
        return out

    return {
        "all_reduce": lambda x: dist.all_reduce(x.clone()),
        "all_gather": lambda x: all_gather(
            torch.empty(x.numel() * n, dtype=x.dtype, device=x.device), x),
        "reduce_scatter": lambda x: reduce_scatter(
            torch.empty(x.numel() // n, dtype=x.dtype, device=x.device), x),
        "ppermute": ppermute,
    }


def profile_collectives(sizes_mb: Sequence[float] = (1.0, 4.0, 16.0), *,
                        iters: int = 3) -> Dict[str, CollectiveProfile]:
    """Measure all-reduce / all-gather / reduce-scatter / ppermute over the
    ``torch.distributed`` default group and fit a latency-bandwidth pair per
    kind.  Call on every rank of the group.

    Returns ``{}`` without a default group or with one rank (a single
    process has no collective to measure — callers fall back to the
    analytic constants), so importing and calling this is always safe.
    Tensors lie on this rank's CUDA device under ``nccl`` and in host
    memory under any other backend (gloo carries host memory)."""
    backend = _group_backend()
    if backend is None or dist.get_world_size() < 2:
        return {}
    n, rank = dist.get_world_size(), dist.get_rank()
    dev = (torch.device("cuda", torch.cuda.current_device())
           if backend == "nccl" else torch.device("cpu"))
    out: Dict[str, CollectiveProfile] = {}
    for kind, op in _collective_ops(n, rank).items():
        byte_sizes: List[float] = []
        times: List[float] = []
        for mb in sizes_mb:
            elems = max(n, int(mb * 2 ** 20 / 4))
            elems -= elems % n                 # reduce-scatter needs n | len
            x = torch.ones(elems, dtype=torch.float32, device=dev)
            dist.barrier()
            times.append(_time_fn(op, x, iters=iters, device=dev))
            byte_sizes.append(elems * 4.0)     # message bytes per device
        out[kind] = _lstsq_latency_bandwidth(byte_sizes, times)
    return out


def load_collective_profiles(path: Union[str, pathlib.Path]
                             ) -> Dict[str, Dict[str, CollectiveProfile]]:
    """Parse a profile cache file: {fingerprint: {kind: profile}}."""
    raw = json.loads(pathlib.Path(path).read_text())
    return {fp: {k: CollectiveProfile.from_json(v)
                 for k, v in kinds.items() if k in COLLECTIVE_KINDS}
            for fp, kinds in raw.items()}


def save_collective_profiles(path: Union[str, pathlib.Path],
                             by_fingerprint: Dict[str, Dict[str, CollectiveProfile]]
                             ) -> None:
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    p.write_text(json.dumps(
        {fp: {k: prof.to_json() for k, prof in sorted(kinds.items())}
         for fp, kinds in sorted(by_fingerprint.items())},
        indent=2, sort_keys=True) + "\n")


def default_profile_cache_path() -> pathlib.Path:
    env = os.environ.get("REPRO_TORCH_COLLECTIVES_CACHE")
    if env:
        return pathlib.Path(env)
    return pathlib.Path.home() / ".cache" / "repro_torch" / "collectives.json"


def cached_collective_profiles(
        path: Union[str, pathlib.Path, None] = None, *,
        fingerprint: Optional[str] = None,
        refresh: bool = False,
        profile_fn: Optional[Callable[[], Dict[str, CollectiveProfile]]] = None,
) -> Dict[str, CollectiveProfile]:
    """Profiled collective constants for this host, via a JSON cache.

    Looks up :func:`device_fingerprint` in the cache at ``path`` (default:
    ``$REPRO_TORCH_COLLECTIVES_CACHE`` or
    ``~/.cache/repro_torch/collectives.json``); on a miss (or
    ``refresh=True``) runs :func:`profile_collectives` and writes the result
    through, merging with other fingerprints already in the file.  Returns
    ``{}`` when nothing could be measured — and caches that too, so
    single-process hosts don't re-probe every run.
    """
    path = pathlib.Path(path) if path is not None else default_profile_cache_path()
    fp = fingerprint or device_fingerprint()
    cache: Dict[str, Dict[str, CollectiveProfile]] = {}
    if path.exists():
        try:
            cache = load_collective_profiles(path)
        except (json.JSONDecodeError, KeyError, TypeError, ValueError):
            cache = {}                         # corrupt cache: re-measure
    if not refresh and fp in cache:
        return dict(cache[fp])
    measured = (profile_fn or profile_collectives)()
    cache[fp] = dict(measured)
    save_collective_profiles(path, cache)
    return dict(measured)


def profiled_cluster(cluster: ClusterSpec,
                     path: Union[str, pathlib.Path, None] = None, *,
                     refresh: bool = False) -> ClusterSpec:
    """``cluster`` with this host's measured collective constants attached
    (unchanged when nothing could be measured)."""
    profiles = cached_collective_profiles(path, refresh=refresh)
    return cluster.with_profiles(profiles) if profiles else cluster
