"""One run of a training cell.

Set-up builds the program's training step (``runtime/executor.py::
make_train_step``), its model and its AdamW state once, draws every weight
from the seed (``weights.py``) into the model, and drives that step through
its first ``checked_steps`` steps on the first batches, reading each
step's loss, each leaf's first gradient as AdamW took it (its first moment
over 1 - beta1) and each leaf's change over the steps (the fp32 master
weights, which the next step keeps, against the drawn weights).  After
``warmup_steps`` more, the same step object runs the window: each step
copies its batch to the card, runs, and reads its loss; the window is
whole steps, run until ``seconds`` have passed.  A traced run profiles
``trace_steps`` steps instead, behind one untraced profiler step, with
ranges around each step (``perfbench.iter``), its batch's copy
(``perfbench.batch``) and its loss's read (``perfbench.sync``).

When the window has closed and its peak memory is read, the program's
state is freed and the plain reference (``reference/<family>.py``) takes
the same first steps from the same weights and batches in fp32;
``judge.py`` compares the two.
"""
from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib
import math
import os
import tempfile
import time
from typing import Any, Dict, List, Optional

import torch

from perfbench import judge, spec, traffic, weights
from perfbench.reference import common as refcommon
from perfbench.trace import breakdown, call_record, digest


@dataclasses.dataclass
class Window:
    """What the end-to-end readers read."""
    steps: int
    tokens: int
    window_s: float
    setup_seconds: float
    peak_bytes: int
    model_flops: float            # a step's
    device_kind: str


def _to(batch: Dict[str, torch.Tensor], device) -> Dict[str, torch.Tensor]:
    return {k: v.to(device, non_blocking=True) for k, v in batch.items()}


def _metric(name: str):
    return importlib.import_module(f"perfbench.metrics.{name}")


def _range(name: str, on: bool):
    return (torch.profiler.record_function(name) if on
            else contextlib.nullcontext())


def _wrap(wraps, calls: Dict[str, List[Dict[str, Any]]]):
    """Put a ``perfbench.<attr>`` range around each (module, attr) and
    record each call's shapes; returns the function that undoes it."""
    undo = []
    for modname, attr in wraps:
        mod = importlib.import_module(modname)
        orig = getattr(mod, attr)

        def wrapped(*args, _orig=orig, _attr=attr, **kwargs):
            grad = torch.is_grad_enabled() and any(
                isinstance(a, torch.Tensor) and a.requires_grad
                for a in args)
            calls.setdefault(_attr, []).append(
                call_record(args, kwargs, grad))
            with torch.profiler.record_function(f"perfbench.{_attr}"):
                return _orig(*args, **kwargs)

        setattr(mod, attr, wrapped)
        undo.append((mod, attr, orig))

    def restore():
        for mod, attr, orig in undo:
            setattr(mod, attr, orig)
    return restore


def program_readings(step, params, opt_state, batches, leaves, seed,
                     beta1: float, device) -> Dict[str, Any]:
    """Drive ``step`` through one step per batch and read the program's
    losses, first gradients and changes (``judge.py``'s readings)."""
    names = [n for n, _ in params.named_parameters()]
    losses, grad = [], {}
    for i, b in enumerate(batches):
        m = step(params, opt_state, _to(b, device))
        losses.append(m["loss"].item())
        if i == 0:
            norms = torch.stack([t.float().norm() for t in opt_state["m"]])
            grad = dict(zip(names, (norms / (1.0 - beta1)).tolist()))
    index = {n: j for j, n in enumerate(names)}
    diffs = []
    for name, w0 in weights.draw(leaves, seed, device):
        diffs.append((opt_state["master"][index[name]]
                      - w0.float()).norm())
        del w0
    change = dict(zip([lf["name"] for lf in leaves],
                      torch.stack(diffs).tolist()))
    return {"loss": losses, "grad": grad, "change": change}


@dataclasses.dataclass
class Program:
    """The program's training step, model and AdamW state, built once."""
    step: Any
    params: Any
    opt_state: Dict[str, Any]
    leaves: List[Dict[str, Any]]
    batches: List[Dict[str, torch.Tensor]]
    beta1: float


def build(cell: spec.Cell, seed: int, device: torch.device,
          base_config=None) -> Program:
    """The program's step, its model with every weight drawn from the
    seed, its AdamW state, and the seed's batches on the host."""
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.runtime import executor

    conf, sp = cell.config, cell.spec
    fam = importlib.import_module(f"perfbench.families.{conf['family']}")
    cfg = fam.port_config(conf, base_config)
    leaves = fam.leaves(conf)
    opt = AdamWConfig(**sp["adamw"])
    batches = traffic.make_batches(cell.traffic, fam.vocab(conf), seed)
    if device.type == "cuda":
        batches = [{k: v.pin_memory() for k, v in b.items()}
                   for b in batches]
    params, _ = executor.init_train_state(cfg, device="meta", opt_cfg=opt)
    params = params.to_empty(device=device)
    named = dict(params.named_parameters())
    weights.assert_matches(named, leaves)
    with torch.no_grad():
        for name, w in weights.draw(leaves, seed, device):
            named[name].copy_(w)
            del w
    del named
    opt_state = adamw_init(list(params.parameters()), opt)
    step = executor.make_train_step(
        cfg, opt, remat_segments=[True] if sp["remat"] else None)
    return Program(step, params, opt_state, leaves, batches, opt.beta1)


def reference_readings(cell: spec.Cell, leaves, seed: int, batches,
                       device: torch.device, precision: str = "fp32",
                       live_dtypes: bool = False) -> Dict[str, Any]:
    """The plain reference's readings of the same first steps from the
    same weights (drawn again from the seed) and batches."""
    conf, sp = cell.config, cell.spec
    ref = importlib.import_module(f"perfbench.reference.{conf['family']}")
    refcommon.no_tf32()
    w0 = dict(weights.draw(leaves, seed, device))
    return refcommon.train_readings(
        ref, conf, w0, [_to(b, device) for b in batches], refcommon.AdamW(
            **{k: sp["adamw"][k] for k in ("lr", "beta1", "beta2", "eps",
                                           "weight_decay", "grad_clip")}),
        precision, live_dtypes)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t0: float, *, base_config=None,
        log=print) -> Dict[str, Any]:
    """One run; returns the result line's fields and the checks.
    ``base_config`` replaces the registered arch (CPU tests at tiny
    widths)."""
    conf, sp = cell.config, cell.spec
    counts = importlib.import_module(f"perfbench.counts.{conf['family']}")
    pg = build(cell, seed, device, base_config)
    step, params, opt_state = pg.step, pg.params, pg.opt_state
    leaves, batches = pg.leaves, pg.batches
    n_check = int(sp["checked_steps"])
    prog = program_readings(step, params, opt_state, batches[:n_check],
                            leaves, seed, pg.beta1, device)
    losses = list(prog["loss"])
    it = n_check

    def one_step(ranges: bool = False):
        """One step; with ``ranges`` (traced runs) the batch's copy to the
        card and the loss's read each inside a range of their own."""
        nonlocal it
        with _range("perfbench.batch", ranges):
            batch = _to(batches[it % len(batches)], device)
        m = step(params, opt_state, batch)
        it += 1
        with _range("perfbench.sync", ranges):
            losses.append(m["loss"].item())

    for _ in range(int(sp["warmup_steps"])):
        one_step()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.reset_peak_memory_stats(device)
    kind = (torch.cuda.get_device_name(device) if device.type == "cuda"
            else "cpu")
    out: Dict[str, Any] = {}
    t_start = time.perf_counter()
    setup_seconds = t_start - t0
    if trace:
        out["trace"] = _traced(cell, lambda: one_step(ranges=True),
                               int(sp["trace_steps"]), kind)
    else:
        n = 0
        while True:
            one_step()
            n += 1
            if time.perf_counter() - t_start >= seconds:
                break
        window_s = time.perf_counter() - t_start
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    if not trace:
        win = Window(steps=n, tokens=n * traffic.tokens_per_batch(
            cell.traffic), window_s=window_s, setup_seconds=setup_seconds,
            peak_bytes=peak, model_flops=counts.model_flops(conf,
                                                            cell.traffic),
            device_kind=kind)
        out["metrics"] = {m["name"]: (_metric(m["name"]).read(win), m["unit"])
                          for m in cell.end_to_end}
    out["setup_seconds"] = setup_seconds
    out["peak_bytes"] = peak
    out["kind"] = kind
    out["attempted"] = len(losses)
    out["failed"] = sum(not math.isfinite(x) for x in losses)

    del pg, step, params, opt_state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    ref_readings = reference_readings(cell, leaves, seed, batches[:n_check],
                                      device)
    g = judge.gaps(prog, ref_readings)
    ok, checks = judge.verdict(g, sp["limits"])
    log(f"set-up {setup_seconds:.2f} s; reference "
        f"{time.perf_counter() - t_ref:.1f} s; program losses "
        f"{prog['loss']}, reference "
        f"{ref_readings['loss']}; loss gaps {g['loss_gaps']}; median "
        f"leaf's gradient gap {g['grad_gap_median']!r}; worst leaves: "
        f"grad {g['grad_leaf']}, change {g['change_leaf']}; left out of "
        f"the change: {g['left_out']}")
    out["correct"] = ok and out["failed"] == 0
    out["checks"] = checks
    out["gaps"] = g
    return out


def _traced(cell: spec.Cell, one_step, n: int, kind: str) -> Dict[str, Any]:
    """Profile ``n`` steps behind one untraced profiler step; the per-layer
    readers' values, the breakdown, busy and window seconds."""
    from torch.profiler import (ProfilerActivity, profile, record_function,
                                schedule)

    readers = {m["name"]: _metric(m["name"]) for m in cell.per_layer}
    wraps = sorted({w for r in readers.values() for w in r.WRAPS})
    nodes = tuple(sorted({"autograd::engine::evaluate_function: " + b
                          for r in readers.values()
                          for b in r.BACKWARD_NODES}))
    calls: Dict[str, List[Dict[str, Any]]] = {}
    restore = _wrap(wraps, calls)
    with tempfile.TemporaryDirectory(prefix="perfbench-trace-") as tmp:
        path = os.path.join(tmp, "trace.json")
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA],
                         schedule=schedule(wait=0, warmup=1, active=n),
                         on_trace_ready=lambda p: p.export_chrome_trace(
                             path)) as prof:
                for i in range(n + 1):
                    if i == 1:
                        calls.clear()
                    with record_function("perfbench.iter"):
                        one_step()
                    prof.step()
        finally:
            restore()
        tr = digest(path, calls, nodes)
    tr.cell, tr.device_kind = cell, kind
    metrics = {}
    for m in cell.per_layer:
        v = readers[m["name"]].read(tr)
        if v is not None:
            metrics[m["name"]] = (v, m["unit"])
    return {"metrics": metrics, "busy_s": tr.busy_s,
            "window_s": tr.window_s, "breakdown": breakdown(tr),
            "unlinked": tr.unlinked, "steps": tr.steps}


def limits_line(checks: Dict[str, Dict[str, float]]) -> List[str]:
    return [f"{k} {c['value']!r} limit {c['limit']!r}"
            for k, c in checks.items()]


def last_line(out: Dict[str, Any], chips: int,
              power: Optional[str]) -> Dict[str, Any]:
    """The contract's result line; ``checks`` comes last."""
    metrics_src = out["trace"]["metrics"] if "trace" in out else out["metrics"]
    device = {"platform": "gpu", "kind": out["kind"], "count": chips,
              "memory_peak_bytes": int(out["peak_bytes"]),
              "power_limit": power}
    line: Dict[str, Any] = {
        "correct": bool(out["correct"]), "attempted": out["attempted"],
        "failed": out["failed"],
        "metrics": {k: {"value": v, "unit": u}
                    for k, (v, u) in metrics_src.items()},
        "device": device}
    if "trace" in out:
        device["busy_s"] = out["trace"]["busy_s"]
        device["window_s"] = out["trace"]["window_s"]
        line["breakdown"] = out["trace"]["breakdown"]
    line["checks"] = out["checks"]
    return line
