"""Weights drawn from the seed on the device, in a few large calls.

A family lists its leaves as ``{"name", "shape", "dtype", "init"}``, named
as the program names its parameters.  ``init`` is one of:

* ``["normal", std]``: N(0, std^2);
* ``["const", value]``;
* ``["uniform", lo, hi]``;
* ``["log_uniform", lo, hi]``: log of U(lo, hi) (Mamba2's ``A_log``);
* ``["inv_softplus_log_uniform", lo, hi]``: softplus^-1 of a step drawn
  log-uniformly in [lo, hi] (Mamba2's ``dt_bias``).

Every normal leaf comes from one standard-normal draw in the dtype the
leaves are served in (chunks of 2^30 elements), every other random leaf
from one U(0, 1) draw in fp32, both from one ``torch.Generator`` on the
device seeded with the run's seed.  The same seed on the same device gives
the same tensors, so the reference gets the program's weights by drawing
them again.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, List, Tuple

import torch

CHUNK = 1 << 30


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[name]


def generator(seed: int, device: torch.device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (1 << 63))


def _flat(n: int, dtype: torch.dtype, fill, device) -> torch.Tensor:
    out = torch.empty(n, dtype=dtype, device=device)
    for a in range(0, n, CHUNK):
        fill(out[a:a + CHUNK])
    return out


def draw(leaves: List[Dict[str, Any]], seed: int,
         device: torch.device) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield ``(name, tensor)`` for every leaf, in the order of ``leaves``."""
    device = torch.device(device)
    g = generator(seed, device)
    normal = [lf for lf in leaves if lf["init"][0] == "normal"]
    dts = sorted({lf["dtype"] for lf in normal})
    flats, offs = {}, {}
    for dt in dts:
        n = 0
        for lf in normal:
            if lf["dtype"] == dt:
                offs[lf["name"]] = n
                n += math.prod(lf["shape"])
        flats[dt] = _flat(n, dtype_of(dt),
                          lambda t: t.normal_(generator=g), device)
    rand = [lf for lf in leaves
            if lf["init"][0] in ("uniform", "log_uniform",
                                 "inv_softplus_log_uniform")]
    n = 0
    for lf in rand:
        offs[lf["name"]] = n
        n += math.prod(lf["shape"])
    u01 = _flat(n, torch.float32, lambda t: t.uniform_(generator=g), device)
    for lf in leaves:
        name, shape, dt = lf["name"], lf["shape"], dtype_of(lf["dtype"])
        kind, *args = lf["init"]
        size = math.prod(shape)
        if kind == "normal":
            a = offs[name]
            w = flats[lf["dtype"]][a:a + size].view(shape) * args[0]
        elif kind == "const":
            w = torch.full(shape, float(args[0]), dtype=dt, device=device)
        else:
            a = offs[name]
            u = u01[a:a + size].view(shape)
            lo, hi = float(args[0]), float(args[1])
            if kind == "uniform":
                w = lo + (hi - lo) * u
            elif kind == "log_uniform":
                w = torch.log(lo + (hi - lo) * u)
            else:
                step = torch.exp(math.log(lo) + (math.log(hi) - math.log(lo))
                                 * u)
                w = step + torch.log(-torch.expm1(-step))
            w = w.to(dt)
        yield name, w
    del flats, u01


def assert_matches(named: Dict[str, torch.Tensor],
                   leaves: List[Dict[str, Any]]) -> None:
    """Raise unless the program's parameters are exactly the listed leaves
    (names, shapes, dtypes)."""
    have = {n: (tuple(p.shape), p.dtype) for n, p in named.items()}
    want = {lf["name"]: (tuple(lf["shape"]), dtype_of(lf["dtype"]))
            for lf in leaves}
    if have != want:
        diff = sorted(set(have.items()) ^ set(want.items()))
        raise ValueError(f"the program's parameters differ from the "
                         f"family's leaves: {diff[:8]}")
