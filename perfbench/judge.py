"""The comparison that decides ``correct``.

Both sides give readings of the same first steps from the same weights and
batches (``reference/common.py::train_readings``): each step's loss, each
leaf's norm of the first gradient as AdamW takes it (after clipping), and
each leaf's norm of its change over the steps.  The numbers:

* ``loss_gap``: the relative gap of the first step's loss (``loss_gaps``:
  every step's).  The later steps' losses part from the fp32 reference by
  2-16% on every seed: the program keeps bf16 live weights beside fp32
  masters, and AdamW's first steps are under half a bf16 ulp of most
  weights, so the live weights lag (a reference with bf16 live weights
  follows the program; PERF.md);
* ``grad_gap``: over the leaves, the largest gap between the two norms of
  the first gradient, over the reference's norm of that leaf or of the
  median leaf, whichever is larger;
* ``grad_gap_median``: the median leaf's gap of the first gradient;
* ``change_gap``: the largest gap of the change over the steps (the
  program's fp32 masters), leaving out the leaves whose reference gradient
  is under a thousandth of the median leaf's (they move under AdamW by
  round-off alone).  A step left unchanged reads 1.

A cell holds the numbers its file's ``limits`` name, each to its limit;
PERF.md gives the readings each limit was set from, and why a number is
not held where no control or fault separates it from sound runs.
"""
from __future__ import annotations

import math
import statistics
from typing import Any, Dict, List, Tuple

GRAD_FLOOR = 1e-3


def _finite(x: float) -> float:
    """x, or inf where it is not a number: a NaN never passes."""
    return x if math.isfinite(x) else math.inf


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float],
              names: List[str]) -> Dict[str, float]:
    """Each leaf's gap over the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    med = statistics.median(ref[n] for n in names)
    return {n: _finite(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30))
            for n in names}


def _worst(prog: Dict[str, float], ref: Dict[str, float],
           names: List[str]) -> Tuple[float, str]:
    gaps_ = leaf_gaps(prog, ref, names)
    worst = max(names, key=lambda n: gaps_[n])
    return gaps_[worst], worst


def gaps(prog: Dict[str, Any], ref: Dict[str, Any]) -> Dict[str, Any]:
    """The three numbers, with the worst leaf of each."""
    if set(prog["grad"]) != set(ref["grad"]):
        raise ValueError("the two sides' leaves differ")
    losses = [_finite(abs(p - r) / abs(r))
              for p, r in zip(prog["loss"], ref["loss"])]
    if len(prog["loss"]) != len(ref["loss"]):
        losses = [math.inf]
    names = sorted(ref["grad"])
    grad, grad_leaf = _worst(prog["grad"], ref["grad"], names)
    grad_median = statistics.median(
        leaf_gaps(prog["grad"], ref["grad"], names).values())
    floor = GRAD_FLOOR * statistics.median(ref["grad"].values())
    moved = [n for n in names if ref["grad"][n] >= floor]
    change, change_leaf = _worst(prog["change"], ref["change"], moved)
    return {"loss_gap": losses[0], "loss_gaps": losses,
            "grad_gap": grad, "grad_leaf": grad_leaf,
            "grad_gap_median": grad_median,
            "change_gap": change, "change_leaf": change_leaf,
            "left_out": sorted(set(names) - set(moved))}


def verdict(g: Dict[str, Any], limits: Dict[str, float]
            ) -> Tuple[bool, Dict[str, Dict[str, float]]]:
    """(every number the cell holds within its limit, {name: {"value",
    "limit"}}), for each number named in ``limits``."""
    checks = {k: {"value": g[k], "limit": float(v)}
              for k, v in limits.items()}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
