"""Three-term roofline analysis of a dry run, modeled memory traffic and
residency, and the model-FLOP count (``repro/roofline/analysis.py``)::

    compute term    = FLOPs       / (chips x peak_FLOP/s)
    memory term     = bytes       / (chips x HBM_bw)
    collective term = coll_bytes  / (chips x link_bw)

The arithmetic is the reference's.  The device constants are one NVIDIA
H100 SXM's (data sheet: dense bf16 rate, HBM bandwidth) where the
reference's are a TPU v5e's, as ``core/hardware.py`` swaps the TPU presets
for H100 ones; ``LINK_BW`` is ``h100_cluster``'s inter-island 40e9 B/s, one
link's worth as the reference charges one ICI link.

The reference reads per-device FLOPs and bytes from XLA's
``cost_analysis()`` and parses the optimized HLO text for collective bytes
(``collective_bytes_from_hlo``).  PyTorch has no HLO: the port's dry run
(``launch/dryrun.py``) counts one rank's step on the ``meta`` device, and
its dry mesh counts the bytes each collective would send, by the
reference's opcode names (``runtime/sharding.py::Traffic.per_op``), which
:func:`roofline_report` takes in place of ``hlo_text``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional

PEAK_FLOPS = 989e12          # bf16 FLOP/s per card (dense)
HBM_BW = 3.35e12             # bytes/s per card
LINK_BW = 40e9               # bytes/s between NVLink islands (InfiniBand,
                             # core/hardware.py::h100_cluster; we charge one
                             # link's worth — conservative)


def model_flops(param_count: float, tokens: float, *, active_params:
                Optional[float] = None, train: bool = True) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); 2*N*D for inference."""
    n = active_params if active_params is not None else param_count
    return (6.0 if train else 2.0) * n * tokens


@dataclasses.dataclass
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    # global quantities
    hlo_flops: float
    hlo_bytes: float
    collective_bytes: float
    per_op_collectives: Dict[str, float]
    model_flops: float
    # terms (seconds)
    t_compute: float
    t_memory: float
    t_collective: float

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / self.hlo_flops if self.hlo_flops else 0.0

    def row(self) -> Dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "t_compute_s": self.t_compute, "t_memory_s": self.t_memory,
            "t_collective_s": self.t_collective,
            "bottleneck": self.bottleneck,
            "hlo_flops": self.hlo_flops, "hlo_bytes": self.hlo_bytes,
            "collective_bytes": self.collective_bytes,
            "model_flops": self.model_flops,
            "useful_flops_ratio": self.useful_flops_ratio,
            "per_op_collectives": self.per_op_collectives,
        }


def roofline_report(*, arch: str, shape: str, mesh_name: str, chips: int,
                    cost_analysis: Mapping[str, float],
                    collectives: Mapping[str, float],
                    model_flops_global: float) -> RooflineReport:
    """The reference's report from one rank's counts: ``cost_analysis``
    {"flops", "bytes accessed"} per device and ``collectives`` {opcode:
    bytes a device sends} (the dry run's ``Traffic.per_op``, in place of
    the reference's ``hlo_text``), scaled to global by ``chips``.  The
    ``hlo_*`` names are the reference's; here they hold the dry run's
    counts."""
    per_dev_flops = float(cost_analysis.get("flops", 0.0))
    per_dev_bytes = float(cost_analysis.get("bytes accessed", 0.0))
    colls = {k: float(v) for k, v in collectives.items()}
    per_dev_coll = sum(colls.values())

    g_flops = per_dev_flops * chips
    g_bytes = per_dev_bytes * chips
    g_coll = per_dev_coll * chips
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        hlo_flops=g_flops, hlo_bytes=g_bytes, collective_bytes=g_coll,
        per_op_collectives=colls, model_flops=model_flops_global,
        t_compute=g_flops / (chips * PEAK_FLOPS),
        t_memory=g_bytes / (chips * HBM_BW),
        t_collective=g_coll / (chips * LINK_BW),
    )


@dataclasses.dataclass
class MemoryModel:
    traffic_bytes_per_device: float     # HBM bytes moved per step per card
    resident_bytes_per_device: float    # persistent + peak stash per card
    fits: bool

    def t_memory(self) -> float:
        return self.traffic_bytes_per_device / HBM_BW


def modeled_memory(specs, *, mode: str, chips: int, tp: int,
                   data_shards: int, remat: bool,
                   batch: int, cache_bytes_total: float = 0.0,
                   hbm_capacity: float = 16e9,
                   seq_shard: int = 1) -> MemoryModel:
    """specs: LayerSpec list (full model).  batch: global batch (sequences);
    cache_bytes_total: global KV/SSM cache bytes (decode modes);
    seq_shard: sequence-parallel factor on the stashed activations
    (Megatron-style; 1 = paper-faithful baseline)."""
    n_params = sum(s.param_count for s in specs)
    n_active = sum(s.active_param_count() for s in specs)
    b_dev = batch / data_shards
    act_dev = sum((s.bnd_bytes_per_sample + s.int_bytes_per_sample)
                  for s in specs) * b_dev / seq_shard
    bnd_dev = sum(s.bnd_bytes_per_sample for s in specs) * b_dev / seq_shard

    w_pass = 2.0 * n_params / tp          # bf16 weights touched, TP-sharded
    opt_dev = 16.0 * n_params / chips     # mixed-precision Adam states
    cache_dev = cache_bytes_total / chips

    if mode == "train":
        # fwd read + bwd (dx, dw) reads + recompute read; opt read+write;
        # activation stash write+read (+ recompute rewrite under remat)
        traffic = 4.0 * w_pass + 2.0 * opt_dev
        traffic += (3.0 * bnd_dev + 2.0 * act_dev) if remat else 2.0 * act_dev
        resident = 2.0 * n_params / chips + opt_dev \
            + (bnd_dev if remat else act_dev)
    elif mode == "prefill":
        traffic = 2.0 * n_active / tp + 2.0 * act_dev
        resident = 2.0 * n_params / tp + act_dev / len(specs)  # one layer live
    else:  # decode
        traffic = 2.0 * n_active / tp + 2.0 * cache_dev
        resident = 2.0 * n_params / tp + cache_dev
    return MemoryModel(
        traffic_bytes_per_device=traffic,
        resident_bytes_per_device=resident,
        fits=resident <= hbm_capacity,
    )
