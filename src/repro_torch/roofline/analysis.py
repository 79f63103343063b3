"""Modeled memory traffic and residency, and the model-FLOP count
(``repro/roofline/analysis.py``, the part that is not JAX-specific).

The arithmetic is the reference's.  The device constants are one NVIDIA
H100 SXM's (data sheet: dense bf16 rate, HBM bandwidth) where the
reference's are a TPU v5e's, as ``core/hardware.py`` swaps the TPU presets
for H100 ones; only :meth:`MemoryModel.t_memory` reads them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

PEAK_FLOPS = 989e12          # bf16 FLOP/s per card (dense)
HBM_BW = 3.35e12             # bytes/s per card


def model_flops(param_count: float, tokens: float, *, active_params:
                Optional[float] = None, train: bool = True) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); 2*N*D for inference."""
    n = active_params if active_params is not None else param_count
    return (6.0 if train else 2.0) * n * tokens


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
