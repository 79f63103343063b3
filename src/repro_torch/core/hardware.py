"""Hardware descriptions used by the Galvatron-BMW cost estimator: the
port's copy of ``repro/core/hardware.py``.

The paper profiles GPUs (RTX TITAN / A100 clusters); the port's *target* is
NVIDIA H100 SXM.  The paper's devices and clusters are kept unchanged, so
the same search engine reproduces the paper's GPU tables and plans, and
H100 presets sit beside them (``H100_SXM``, :func:`h100_node`,
:func:`h100_cluster`).

Bandwidths are *algorithmic* bandwidths (bytes/s available to a collective
on one device), compute is peak dense throughput per chip.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Tuple

GB = 1024**3
MB = 1024**2
TFLOPS = 1e12

#: collective kinds the profiler measures and the cost model consumes
COLLECTIVE_KINDS = ("all_reduce", "all_gather", "reduce_scatter", "ppermute")


@dataclasses.dataclass(frozen=True)
class CollectiveProfile:
    """Measured latency/bandwidth pair of one collective kind.

    Produced by ``core/profiler.py::profile_collectives`` from on-device
    microbenchmarks (a linear fit ``t = latency_s + bytes / bus_bandwidth``
    over several message sizes) and consumed by the cost model through
    :meth:`ClusterSpec.collective_coeffs`.  ``bus_bandwidth`` is the
    *algorithmic* bytes/s seen by one device (same convention as the
    analytic ``intra_island_bandwidth``), so a profiled and an analytic
    constant drop into the same cost-model formulas.
    """

    latency_s: float                 # fixed per-invocation cost, seconds
    bus_bandwidth: float             # algorithmic bytes/s per device
    n_samples: int = 0               # message sizes the fit saw

    def to_json(self) -> Dict:
        return {"latency_s": self.latency_s,
                "bus_bandwidth": self.bus_bandwidth,
                "n_samples": self.n_samples}

    @staticmethod
    def from_json(d: Mapping) -> "CollectiveProfile":
        return CollectiveProfile(
            latency_s=float(d["latency_s"]),
            bus_bandwidth=float(d["bus_bandwidth"]),
            n_samples=int(d.get("n_samples", 0)))


@dataclasses.dataclass(frozen=True)
class DeviceSpec:
    """A single accelerator."""

    name: str
    peak_flops: float            # dense (bf16/fp16) FLOP/s
    hbm_bytes: float             # device memory capacity
    hbm_bandwidth: float         # bytes/s
    # Slowdown multiplier applied to BOTH compute and communication when the
    # two overlap (paper §V measures ~1.3x on GPUs from SM contention).
    overlap_slowdown: float = 1.3


@dataclasses.dataclass(frozen=True)
class ClusterSpec:
    """A (possibly hierarchical) collection of identical devices.

    ``intra_island_bandwidth`` is the fast interconnect (NVLink);
    ``inter_island_bandwidth`` is the slow one (IB / PCIe).  Takeaway #1
    puts PP across islands.  ``island_size`` devices share the fast domain.
    """

    name: str
    device: DeviceSpec
    n_devices: int
    island_size: int
    intra_island_bandwidth: float   # bytes/s per device, fast domain
    inter_island_bandwidth: float   # bytes/s per device, slow domain
    memory_budget: Optional[float] = None  # training budget; default = hbm
    # Measured collective constants, stored as a sorted tuple of
    # (kind, CollectiveProfile) pairs so the frozen dataclass stays
    # hashable.  Build with :meth:`with_profiles`; ``None`` means "analytic
    # constants only" and reproduces the pre-profiling cost model exactly.
    collective_profiles: Optional[Tuple[Tuple[str, "CollectiveProfile"], ...]] = None

    def budget(self) -> float:
        return self.memory_budget if self.memory_budget is not None else self.device.hbm_bytes

    def bandwidth_for_group(self, group_size: int) -> float:
        """Bandwidth seen by a collective over ``group_size`` devices.

        Groups that fit inside an island use the fast domain; larger groups
        are bottlenecked by the slow domain.
        """
        if group_size <= self.island_size:
            return self.intra_island_bandwidth
        return self.inter_island_bandwidth

    def profiles(self) -> Dict[str, "CollectiveProfile"]:
        """Profiled collective constants as a plain dict (possibly empty)."""
        return dict(self.collective_profiles or ())

    def _profile_for(self, kind: str) -> Optional["CollectiveProfile"]:
        for k, p in (self.collective_profiles or ()):
            if k == kind:
                return p
        return None

    def collective_coeffs(self, kind: str, group_size: int) -> Tuple[float, float]:
        """``(latency_s, bandwidth)`` the cost model should charge for one
        ``kind`` collective spanning ``group_size`` devices.

        Profiled constants were measured inside one fast domain, so they
        apply only to groups that fit in an island; degenerate groups
        (``group_size <= 1``) and cross-island groups fall back to zero
        latency and the analytic :meth:`bandwidth_for_group` — with no
        profiles attached every result is the analytic pair, keeping the
        cost model byte-identical to the pre-profiling one.
        """
        if group_size > 1 and group_size <= self.island_size:
            p = self._profile_for(kind)
            if p is not None:
                return (p.latency_s, p.bus_bandwidth)
        return (0.0, self.bandwidth_for_group(group_size))

    def p2p_coeffs(self) -> Tuple[float, float]:
        """``(latency_s, bandwidth)`` for the pipeline hand-off transfer.

        PP boundaries sit on the *slow* domain by construction (Takeaway
        #1), so a profiled ``ppermute`` — measured inside the fast domain —
        only applies when the whole cluster is one island.
        """
        if self.island_size >= self.n_devices:
            p = self._profile_for("ppermute")
            if p is not None:
                return (p.latency_s, p.bus_bandwidth)
        return (0.0, self.inter_island_bandwidth)

    def with_budget(self, budget_bytes: float) -> "ClusterSpec":
        return dataclasses.replace(self, memory_budget=budget_bytes)

    def with_devices(self, n: int) -> "ClusterSpec":
        return dataclasses.replace(self, n_devices=n)

    def with_profiles(self, profiles: Mapping[str, "CollectiveProfile"]) -> "ClusterSpec":
        """Attach measured collective constants (see ``core/profiler.py``).

        An empty mapping detaches all profiles (back to analytic)."""
        packed = tuple(sorted(profiles.items())) or None
        return dataclasses.replace(self, collective_profiles=packed)


# --------------------------------------------------------------------------
# Device presets
# --------------------------------------------------------------------------

RTX_TITAN = DeviceSpec(
    name="rtx-titan-24g",
    peak_flops=32.6 * TFLOPS,        # fp16 w/ fp32 accum tensor cores
    hbm_bytes=24 * GB,
    hbm_bandwidth=672e9,
    overlap_slowdown=1.3,
)

A100_40G = DeviceSpec(
    name="a100-40g",
    peak_flops=312 * TFLOPS,
    hbm_bytes=40 * GB,
    hbm_bandwidth=1555e9,
    overlap_slowdown=1.3,
)

A100_80G = DeviceSpec(
    name="a100-80g",
    peak_flops=312 * TFLOPS,
    hbm_bytes=80 * GB,
    hbm_bandwidth=2039e9,
    overlap_slowdown=1.3,
)

# The port's target: H100 SXM5, from NVIDIA's H100 Tensor Core GPU
# datasheet (SXM5 column): 989 TFLOP/s dense bf16 tensor-core throughput,
# 80 GB HBM3 at 3.35 TB/s.  The overlap factor is the repo's GPU convention.
H100_SXM = DeviceSpec(
    name="h100-sxm-80g",
    peak_flops=989 * TFLOPS,
    hbm_bytes=80 * GB,
    hbm_bandwidth=3.35e12,
    overlap_slowdown=1.3,
)


# --------------------------------------------------------------------------
# Cluster presets (paper evaluation environments + H100 targets)
# --------------------------------------------------------------------------

def paper_8gpu() -> ClusterSpec:
    """Single node, 8x RTX TITAN on PCIe 3.0 (paper §VII-A)."""
    return ClusterSpec(
        name="8x-rtx-titan-pcie",
        device=RTX_TITAN,
        n_devices=8,
        island_size=8,
        intra_island_bandwidth=12e9,     # PCIe 3.0 x16 effective
        inter_island_bandwidth=12e9,
    )


def paper_16gpu_low() -> ClusterSpec:
    """2 nodes x 8 RTX TITAN, 100Gb IB across (low-perf cluster)."""
    return ClusterSpec(
        name="16x-rtx-titan-ib100",
        device=RTX_TITAN,
        n_devices=16,
        island_size=8,
        intra_island_bandwidth=12e9,
        inter_island_bandwidth=10e9,     # 100 Gb/s ≈ 10 GB/s after overhead
    )


def paper_16gpu_high() -> ClusterSpec:
    """2 nodes x 8 A100-NVLink, 100Gb IB across (high-perf cluster)."""
    return ClusterSpec(
        name="16x-a100-nvlink-ib100",
        device=A100_40G,
        n_devices=16,
        island_size=8,
        intra_island_bandwidth=300e9,    # NVLink3 per-GPU algorithmic
        inter_island_bandwidth=10e9,
    )


def paper_64gpu() -> ClusterSpec:
    """8 nodes x 8 A100-40G NVLink, 100Gb IB (Table IV)."""
    return ClusterSpec(
        name="64x-a100-nvlink-ib100",
        device=A100_40G,
        n_devices=64,
        island_size=8,
        intra_island_bandwidth=300e9,
        inter_island_bandwidth=10e9,
    )


def paper_32gpu_80g() -> ClusterSpec:
    """4 nodes x 8 A100-80G, 400Gb IB (Table VI, GPT-3 runs)."""
    return ClusterSpec(
        name="32x-a100-80g-ib400",
        device=A100_80G,
        n_devices=32,
        island_size=8,
        intra_island_bandwidth=300e9,
        inter_island_bandwidth=40e9,
    )


def h100_node() -> ClusterSpec:
    """One node, 8x H100 SXM5 on NVLink 4 (datasheet: 900 GB/s per GPU,
    both directions together; the per-direction 450 GB/s is the algorithmic
    bandwidth, the convention of the A100 presets' 300 GB/s)."""
    return ClusterSpec(
        name="8x-h100-sxm-nvlink",
        device=H100_SXM,
        n_devices=8,
        island_size=8,
        intra_island_bandwidth=450e9,
        inter_island_bandwidth=450e9,
    )


def h100_cluster(n: int = 64) -> ClusterSpec:
    """``n // 8`` nodes x 8 H100 SXM5 on NVLink 4, 400 Gb/s NDR InfiniBand
    across (counted as 40 GB/s after overhead, as ``paper_32gpu_80g``)."""
    return ClusterSpec(
        name=f"{n}x-h100-sxm-ib400",
        device=H100_SXM,
        n_devices=n,
        island_size=8,
        intra_island_bandwidth=450e9,
        inter_island_bandwidth=40e9,
    )


CLUSTERS: Dict[str, "ClusterSpec"] = {}
for _f in (paper_8gpu, paper_16gpu_low, paper_16gpu_high, paper_64gpu,
           paper_32gpu_80g, h100_node, h100_cluster):
    _c = _f()
    CLUSTERS[_c.name] = _c
