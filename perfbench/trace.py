"""The device trace of a traced run, reduced to what the per-layer readers
read.

``torch.profiler`` (CPU and CUDA activities) writes a Chrome trace; from it
come the device operations (kernels, copies, sets), each tied to the call
that launched it by the trace's correlation id, and the ranges the
benchmark placed on the host: ``perfbench.<name>`` around the calls it
wraps, and the autograd engine's own ``autograd::engine::evaluate_function:
<Node>`` around each backward node (host ranges only: the profiler's
copies of the ranges on the device timeline are left out).  An operation
belongs to every range on the launching thread whose span holds its
launch.  The traced window runs from the start of the first
``perfbench.iter`` range to the end of the last; each iteration ends by
reading the loss, so its device work ends inside it.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

DEVICE_CATS = {"kernel", "gpu_memcpy", "gpu_memset", "memcpy", "memset"}
LAUNCH_CATS = {"cuda_runtime", "cuda_driver", "runtime", "driver"}
RANGE_PREFIXES = ("perfbench.", "autograd::engine::evaluate_function: ")
ITER = "perfbench.iter"


@dataclasses.dataclass
class DeviceOp:
    name: str
    start: float                  # us, the trace's clock
    end: float
    ranges: Tuple[str, ...]       # the ranges that held its launch


@dataclasses.dataclass
class Trace:
    ops: List[DeviceOp]
    window: Tuple[float, float]   # us
    steps: int
    calls: Dict[str, List[Dict[str, Any]]]   # recorded calls by wrapped op
    unlinked: int                 # device ops whose launch was not found
    host: List[Tuple[float, float, str]] = dataclasses.field(
        default_factory=list)     # host ops and ranges (start, end, name)
    cell: Any = None              # the cell (perfbench.spec.Cell)
    device_kind: str = ""

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6

    def busy_intervals(self) -> List[Tuple[float, float]]:
        """The union of the device ops' spans, clipped to the window."""
        lo, hi = self.window
        spans = sorted((max(o.start, lo), min(o.end, hi)) for o in self.ops
                       if o.end > lo and o.start < hi)
        out: List[List[float]] = []
        for a, b in spans:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    @property
    def device_span_s(self) -> float:
        """Seconds from the first device op's start to the last one's end,
        clipped to the window."""
        spans = self.busy_intervals()
        return (spans[-1][1] - spans[0][0]) / 1e6 if spans else 0.0

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def seconds_in(self, *ranges: str) -> float:
        """Device seconds of the ops launched inside any of ``ranges``."""
        return sum(o.end - o.start for o in self.ops
                   if any(r in o.ranges for r in ranges)) / 1e6

    def seconds_outside(self, *ranges: str) -> float:
        """Device seconds of the ops launched inside none of ``ranges``."""
        return sum(o.end - o.start for o in self.ops
                   if not any(r in o.ranges for r in ranges)) / 1e6


def _x_events(raw: Dict[str, Any]):
    for e in raw.get("traceEvents", []):
        if e.get("ph") == "X" and "ts" in e and "dur" in e:
            yield e


def _held(ranges, launches):
    """For each (tid, t, index) launch, the names of the ranges on ``tid``
    whose span holds ``t``: a sweep over both sorted by time."""
    out = {}
    by_tid: Dict[Any, List[Tuple[float, int]]] = {}
    for tid, t, i in launches:
        by_tid.setdefault(tid, []).append((t, i))
    for tid, ls in by_tid.items():
        spans = sorted(ranges.get(tid, []))
        active: List[Tuple[float, str]] = []
        k = 0
        for t, i in sorted(ls):
            while k < len(spans) and spans[k][0] <= t:
                active.append((spans[k][1], spans[k][2]))
                k += 1
            active = [a for a in active if a[0] >= t]
            out[i] = tuple(n for _, n in active)
    return out


def digest(path: str, calls: Dict[str, List[Dict[str, Any]]],
           names: Tuple[str, ...]) -> Trace:
    """The trace at ``path``, with the ranges ``perfbench.*`` and the
    backward nodes' ranges of ``names`` (full names) kept."""
    with open(path) as f:
        raw = json.load(f)
    launches: Dict[Any, Tuple[Any, float]] = {}
    ranges: Dict[Any, List[Tuple[float, float, str]]] = {}
    device, host, iters = [], [], []
    for e in _x_events(raw):
        cat = str(e.get("cat", "")).lower()
        ts, dur = float(e["ts"]), float(e["dur"])
        args = e.get("args", {}) or {}
        name = e.get("name", "")
        if cat in DEVICE_CATS:
            device.append((name, ts, ts + dur, args.get("correlation")))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), ts)
        elif cat in ("cpu_op", "user_annotation"):
            host.append((ts, ts + dur, name))
            if name.startswith("perfbench.") or name in names:
                ranges.setdefault(e.get("tid"), []).append((ts, ts + dur,
                                                            name))
                if name == ITER:
                    iters.append((ts, ts + dur))
    del raw
    if not iters:
        raise ValueError("the trace holds no perfbench.iter range")
    found = [(launches[c][0], launches[c][1], i)
             for i, (_, _, _, c) in enumerate(device) if c in launches]
    held = _held(ranges, found)
    ops = [DeviceOp(n, a, b, held.get(i, ()))
           for i, (n, a, b, _) in enumerate(device)]
    window = (min(a for a, _ in iters), max(b for _, b in iters))
    ops = [o for o in ops if o.end > window[0] and o.start < window[1]]
    return Trace(ops=ops, window=window, steps=len(iters), calls=calls,
                 unlinked=len(device) - len(found), host=host)


def breakdown(trace: Trace, n: int = 10) -> Dict[str, Any]:
    """The device ops that took most time (seconds summed by name over the
    traced window), and the idle gaps on the device summed by what the
    host was doing when each began (the innermost ``perfbench`` range and
    the innermost host op then running, on any thread), longest first."""
    by_name: Dict[str, float] = {}
    for o in trace.ops:
        by_name[o.name] = by_name.get(o.name, 0.0) + (o.end - o.start) / 1e6
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
    lo, hi = trace.window
    gaps, t = [], lo
    for a, b in trace.busy_intervals():
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if hi > t:
        gaps.append((t, hi))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:200]
    host = trace.host
    hs = np.array([h[0] for h in host] or [0.0])
    he = np.array([h[1] for h in host] or [-1.0])

    def innermost(idx):
        return host[min(idx, key=lambda i: he[i] - hs[i])][2]

    labels: Dict[str, float] = {}
    for a, b in gaps:
        hold = np.nonzero((hs <= a) & (he >= a))[0]
        ours = [i for i in hold if host[i][2].startswith("perfbench.")
                and host[i][2] != ITER]
        theirs = [i for i in hold
                  if not host[i][2].startswith(RANGE_PREFIXES
                                               + ("ProfilerStep",))]
        label = " / ".join([innermost(ours) if ours else ITER,
                            innermost(theirs) if theirs else "no host op"])
        labels[label] = labels.get(label, 0.0) + (b - a) / 1e6
    gap_top = sorted(labels.items(), key=lambda kv: -kv[1])[:n]
    return {"device_ops": [[k, v] for k, v in top],
            "idle_gaps": [[k, v] for k, v in gap_top]}


def call_record(args, kwargs, needs_grad: bool) -> Dict[str, Any]:
    """A wrapped call's shapes, as the counts read them."""
    import torch
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    return {"shapes": [tuple(t.shape) for t in tensors],
            "itemsize": tensors[0].element_size() if tensors else 0,
            "kwargs": {k: v for k, v in kwargs.items()
                       if isinstance(v, (bool, int, float, type(None)))},
            "grad": needs_grad}


def roofline_pct(trace: Trace, op: str, backward_node: str,
                 cost) -> Optional[float]:
    """100 x the summed least time of every recorded call of ``op`` (its
    backward's too where it took a gradient) over the device seconds of
    the ops launched inside its ranges and its backward nodes'; None where
    there was no call."""
    from perfbench.peaks import least_seconds

    calls = trace.calls.get(op, [])
    spent = trace.seconds_in(f"perfbench.{op}",
                             "autograd::engine::evaluate_function: "
                             + backward_node)
    if not calls or spent <= 0:
        return None
    least = 0.0
    for c in calls:
        f_ops, f_bytes, b_ops, b_bytes = cost(c)
        least += least_seconds(f_ops, f_bytes, trace.device_kind)
        if c["grad"]:
            least += least_seconds(b_ops, b_bytes, trace.device_kind)
    return 100.0 * least / spent
