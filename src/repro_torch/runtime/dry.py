"""One rank's view of a mesh with no process group: the dry run's groups.

The dry run (``launch/dryrun.py``) runs one rank's real step on the ``meta``
device over a production mesh given as a mapping of axis name to size.
:class:`DryMesh` answers what ``runtime/sharding.py::ShardContext`` asks of
a ``DeviceMesh`` (``mesh_dim_names``, ``size``, ``get_group``,
``get_local_rank``) at rank 0's coordinates, the rank that counts every
shard in ``ShardContext.grad_norm``.  Its groups are :class:`DryGroup`\\ s:
the sharded executor's collectives take one without ``torch.distributed``,
give the result's shape and add the bytes a real rank would send to the
run's ``Traffic`` (``runtime/sharding.py``).

``ShardContext`` runs on ``("data", "model")`` or ``("data", "expert")``
names.  A multi-pod mapping ``{"pod": 2, "data": 32, "model": 8}`` is
presented to it as one batch group of ``pod x data`` ranks, while the rule
table (``leaf_spec``) is drawn on the three-axis mapping
(:attr:`DryMesh.spec_axes`), whose ``("pod", "data")`` entries split a leaf
over the same 64 ranks.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional


class DryGroup:
    """A process group that exists only as its size and this rank's index
    in it (0)."""

    def __init__(self, name: str, size: int):
        self.name, self.size, self.rank = name, int(size), 0

    def __repr__(self) -> str:
        return f"DryGroup({self.name!r}, {self.size})"


class DryMesh:
    """A mesh of ``axes`` (``{"data": 32, "model": 8}``, ``{"pod": 2,
    "data": 32, "model": 8}`` or with ``"expert"`` in place of ``"model"``)
    seen from rank 0.  ``mesh_dim_names`` is ``("data", second)``, its
    ``data`` the product of the batch axes; :attr:`spec_axes` is the
    mapping as given, for the rule table; :attr:`world` the group of every
    rank."""

    def __init__(self, axes: Mapping[str, int]):
        axes = {a: int(n) for a, n in axes.items()}
        second = "expert" if "expert" in axes else "model"
        unknown = set(axes) - {"pod", "data", second}
        if "data" not in axes or unknown:
            raise ValueError(f"a dry mesh takes 'data', optionally 'pod', "
                             f"and 'model' or 'expert'; got {axes}")
        n_batch = math.prod(axes[a] for a in ("pod", "data") if a in axes)
        self.spec_axes: Dict[str, int] = axes
        self.mesh_dim_names = ("data", second)
        self._sizes = {"data": n_batch, second: axes.get(second, 1)}
        self._groups = {n: DryGroup(n, s) for n, s in self._sizes.items()}
        self.world = DryGroup("world", n_batch * self._sizes[second])

    def size(self, mesh_dim: Optional[int] = None) -> int:
        if mesh_dim is None:
            return self.world.size
        return self._sizes[self.mesh_dim_names[mesh_dim]]

    def get_group(self, mesh_dim: str) -> DryGroup:
        return self._groups[mesh_dim]

    def get_local_rank(self, mesh_dim: str) -> int:
        return 0

    def __repr__(self) -> str:
        return f"DryMesh({self.spec_axes})"


def is_dry(group) -> bool:
    return isinstance(group, DryGroup)
