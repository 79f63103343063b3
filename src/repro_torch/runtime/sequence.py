"""Sequence-parallel (ring attention) execution over a ``DeviceMesh``.

A mesh with a ``seq`` axis splits the token dimension of ``(B, S, ...)``
activations, and :func:`ring_attention_on_mesh` runs the ring
(``kernels/ring_attention.py``) over the axis's process group: K/V panels
rotate around it while queries stay resident.  Per-rank activation memory
drops by the axis size, the axis the long-context search trades against
TP/PP/DP.

One documented difference from the JAX package: its wrapper takes and
returns GLOBAL arrays, which ``shard_map`` splits over ``seq``.  Here every
rank is its own process, so the function takes and returns the rank's
LOCAL shards; :func:`shard_sequence` cuts a rank's shard out of a global
tensor.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.kernels import ops

AttnFn = Callable[[torch.Tensor, torch.Tensor, torch.Tensor], torch.Tensor]


def _axis(mesh: DeviceMesh, name: str) -> Optional[int]:
    names = mesh.mesh_dim_names or ()
    return names.index(name) if name in names else None


def seq_axis_size(mesh: DeviceMesh) -> int:
    """Size of the mesh's ``seq`` axis (1 when absent)."""
    dim = _axis(mesh, "seq")
    return 1 if dim is None else mesh.size(dim)


def ring_attention_on_mesh(mesh: DeviceMesh, *, causal: bool = True,
                           window: Optional[int] = None) -> AttnFn:
    """Build ``fn(q, k, v) -> out`` running ring attention over ``mesh``.

    ``q`` (B, S/P, H, dh) and ``k``/``v`` (B, T/P, KV, dh) are this rank's
    shards along ``seq`` (P its size); the output is the rank's
    (B, S/P, H, dh) shard.  With no ``seq`` axis, or one of size 1, this is
    the single-device flash attention."""
    if seq_axis_size(mesh) <= 1:
        def dense(q, k, v):
            return ops.flash_attention(q, k, v, causal=causal, window=window)
        return dense
    group = mesh.get_group("seq")

    def local(q, k, v):
        return ops.ring_flash_attention(q, k, v, group=group, causal=causal,
                                        window=window)
    return local


def shard_sequence(x: torch.Tensor, mesh: DeviceMesh) -> torch.Tensor:
    """This rank's shard of a global ``(B, S, ...)`` tensor: dim 1 split by
    its ``seq`` coordinate, dim 0 by its ``data`` coordinate (the seq/data
    part of the JAX package's ``runtime/sharding.py::batch_shardings``).

    As there, a batch dim that the ``data`` axis does not divide stays
    whole (replicated).  S must divide by the ``seq`` axis, as the ring
    needs; otherwise this raises."""
    for name, dim in (("data", 0), ("seq", 1)):
        ax = _axis(mesh, name)
        if ax is None or mesh.size(ax) == 1:
            continue
        n, i = mesh.size(ax), mesh.get_local_rank(name)
        if x.shape[dim] % n:
            if name == "seq":
                raise ValueError(f"sequence length {x.shape[dim]} does not "
                                 f"split over a seq axis of {n}")
            continue
        step = x.shape[dim] // n
        x = x.narrow(dim, i * step, step)
    return x
