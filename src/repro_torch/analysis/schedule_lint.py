# The port's copy of repro/analysis/schedule_lint.py: the same names and arithmetic.
"""Schedule verifier: happens-before certification of ``ScheduleProgram``
program tables (rule ids ``SCH001``–``SCH010``, catalog in
``docs/analysis.md``).

The pipeline runtime replays a compiled table blindly — one generic
``lax.scan`` over whatever the compiler emitted — so a wrong table is a
silent wrong answer (stale-activation read) or a real-hardware deadlock.
This pass certifies an arbitrary table *independently of the compiler and
the cost model that priced it*:

  1. **Happens-before graph.**  Every valid slot is an event
     ``(phase, virtual stage, micro-batch)``; its dependencies (upstream
     forward hand-off, downstream activation-gradient, same-slot F→B→W
     chain) must all be scheduled at strictly earlier ticks.  Because
     events carry tick assignments, any dependency *cycle* necessarily
     contains a non-forward edge, so cycle detection (deadlock) reduces to
     checking every edge (SCH001).  Missing producers are use-before-def
     (SCH002); duplicated events double-consume their input buffer
     (SCH003).
  2. **Liveness certification.**  Per stage, the peak number of live
     activation sets is derived by interval analysis — directly from the
     F/B/W tick intervals for three-phase tables, from an independent
     event simulation of the flush backward for ``1f1b``, from the
     stash-to-flush rule for ``gpipe``, and from the Megatron warm-up
     depth for interleaved programs.  The certified counts are pinned
     *exactly* against ``core/pipeline_balance.py``
     (``inflight_microbatches`` / ``zb_w_pending_max``): cost-model drift
     is an error (SCH007), as is exceeding the schedule's in-flight cap
     (SCH006).
  3. **Bubble re-derivation.**  The compiled bubble tick count is
     recomputed from the table and pinned against the priced
     ``bubble_fraction`` (SCH008) — a schedule the model oversells (e.g.
     a ragged interleaved group) is rejected before the search can emit
     it.

``verify_program`` returns structured diagnostics; ``certify_program``
wraps it in a report.  ``compile_schedule(..., validate=True)`` routes
here, making this module the single source of truth for the program-table
invariants that used to live only in tests.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.cost_model import bubble_fraction
from repro_torch.core.pipeline_balance import (ZB_W_ACT_FRAC, inflight_microbatches,
                                         zb_w_pending_max)
from repro_torch.runtime.schedules import (PHASE_B, PHASE_F, PHASE_W,
                                     ScheduleProgram)

from .diagnostics import Diagnostic, DiagnosticReport, error, info

_PHASE_NAME = {PHASE_F: "F", PHASE_B: "B", PHASE_W: "W"}

# numeric tolerance for fractional (per-chunk / ZB_W_ACT_FRAC) set counts;
# the cross-checks are exact in exact arithmetic, this only absorbs float
# representation of x/V
_TOL = 1e-9


@dataclasses.dataclass(frozen=True)
class StageCertificate:
    """Certified liveness numbers for one pipeline stage."""

    stage: int
    fwd_stash: float        # peak forward activation sets held (full-stage
                            # units; interleaved chunks count 1/V each)
    w_pending: int          # peak completed-B-but-pending-W sets (zb only)
    live_sets: float        # cost-model units: fwd + ZB_W_ACT_FRAC*pending

    @property
    def modeled_units(self) -> float:
        return self.live_sets


def _loc(pr: ScheduleProgram, detail: str = "") -> str:
    base = f"{pr.name}[P={pr.n_stages},m={pr.n_micro},V={pr.n_chunks}]"
    return f"{base} {detail}" if detail else base


# ---------------------------------------------------------------------------
# event extraction + structural checks
# ---------------------------------------------------------------------------

def _collect_events(pr: ScheduleProgram, out: List[Diagnostic]
                    ) -> Dict[Tuple[int, int, int], Tuple[int, int]]:
    """Map ``(phase, virtual stage, micro-batch) -> (tick, device)`` for
    every valid slot, flagging malformed indices (SCH010) and duplicates
    (SCH003) along the way."""
    P, m, V = pr.n_stages, pr.n_micro, pr.n_chunks
    events: Dict[Tuple[int, int, int], Tuple[int, int]] = {}
    for t in range(pr.n_ticks):
        for i in range(P):
            if not pr.valid[t, i]:
                continue
            mb = int(pr.mb_index[t, i])
            v = int(pr.chunk_index[t, i])
            ph = int(pr.phase[t, i])
            if not 0 <= mb < m or not 0 <= v < V or ph not in _PHASE_NAME:
                out.append(error(
                    "SCH010", _loc(pr, f"tick {t} stage {i}"),
                    f"malformed slot: mb={mb} (m={m}), chunk={v} (V={V}), "
                    f"phase={ph}",
                    "indices must satisfy 0<=mb<m, 0<=chunk<V, "
                    "phase in {F,B,W}"))
                continue
            key = (ph, v * P + i, mb)
            if key in events:
                pt, pi = events[key]
                out.append(error(
                    "SCH003", _loc(pr, f"tick {t} stage {i}"),
                    f"duplicate {_PHASE_NAME[ph]} for virtual stage "
                    f"{v * P + i}, micro-batch {mb} (already at tick {pt} "
                    f"stage {pi}) — the buffer would be double-consumed",
                    "each (phase, virtual stage, micro-batch) must be "
                    "scheduled exactly once"))
                continue
            events[key] = (t, i)
    return events


def _check_coverage(pr: ScheduleProgram, events, out: List[Diagnostic]) -> None:
    """Every (virtual stage, micro-batch) needs one F — and one B and one W
    when the table is three-phase (SCH004)."""
    P, m, V = pr.n_stages, pr.n_micro, pr.n_chunks
    phases = ((PHASE_F, PHASE_B, PHASE_W) if pr.is_three_phase
              else (PHASE_F,))
    for ph in phases:
        for s in range(P * V):
            for mb in range(m):
                if (ph, s, mb) not in events:
                    out.append(error(
                        "SCH004", _loc(pr, f"virtual stage {s}"),
                        f"missing {_PHASE_NAME[ph]} tick for micro-batch "
                        f"{mb}: the program drops work",
                        "every (virtual stage, micro-batch) must appear "
                        "once per phase"))


def _check_happens_before(pr: ScheduleProgram, events,
                          out: List[Diagnostic]) -> None:
    """Every dependency edge must point strictly forward in tick time
    (SCH001); a missing producer is a use-before-def (SCH002).

    Edges, for event ``(ph, s, mb)`` at tick ``t``:
      * F(s) <- F(s-1): the upstream hand-off (s > 0);
      * B(i) <- F(i) and B(i) <- B(i+1): the activation-gradient chain
        (three-phase tables, where s == i);
      * W(i) <- B(i): the weight gradient needs its activation gradient.

    With ticks assigned, any dependency cycle must contain an edge whose
    consumer does not run strictly after its producer — so SCH001 is also
    the deadlock (cycle) check.
    """
    P = pr.n_stages

    def need(consumer_key, producer_key, why: str, deadlock: str):
        t, i = events[consumer_key]
        prod = events.get(producer_key)
        cname = _PHASE_NAME[consumer_key[0]]
        if prod is None:
            out.append(error(
                "SCH002", _loc(pr, f"tick {t} stage {i}"),
                f"{cname}(vs={consumer_key[1]}, mb={consumer_key[2]}) "
                f"consumes {why}, but that producer tick is missing "
                "(use-before-def: the buffer was never written)",
                "restore the producer slot or drop the consumer"))
            return
        pt, pi = prod
        if pt >= t:
            out.append(error(
                "SCH001", _loc(pr, f"tick {t} stage {i}"),
                f"happens-before violation: "
                f"{cname}(vs={consumer_key[1]}, mb={consumer_key[2]}) at "
                f"tick {t} needs {why} which runs at tick {pt} (stage {pi})"
                f" — {deadlock}",
                "the producer must be scheduled at a strictly earlier "
                "tick"))

    for (ph, s, mb), (t, i) in events.items():
        if ph == PHASE_F:
            if s > 0:
                need((PHASE_F, s, mb), (PHASE_F, s - 1, mb),
                     f"the forward hand-off from virtual stage {s - 1}",
                     "on real hardware both stages would wait on each "
                     "other's ppermute (deadlock)")
        elif ph == PHASE_B:
            need((PHASE_B, s, mb), (PHASE_F, s, mb),
                 "its own forward activations",
                 "the backward would read a stale or absent stash")
            if s < P * pr.n_chunks - 1:
                need((PHASE_B, s, mb), (PHASE_B, s + 1, mb),
                     f"the downstream activation gradient from virtual "
                     f"stage {s + 1}",
                     "the gradient hand-off would deadlock")
        elif ph == PHASE_W:
            need((PHASE_W, s, mb), (PHASE_B, s, mb),
                 "its own activation-gradient (B) tick",
                 "the weight gradient would use an unconsumed cotangent")


def _check_ring_handoff(pr: ScheduleProgram, out: List[Diagnostic]) -> None:
    """The executable invariant of the single-``ppermute`` runtime: every
    valid slot's producer sits exactly one tick earlier on the ring-
    adjacent device (SCH009).  For three-phase tables the runtime executes
    the *forward projection* instead, which exists iff every stage's F
    slots process micro-batches in flush order."""
    P = pr.n_stages
    if pr.is_three_phase:
        for i in range(P):
            mbs = pr.mb_index[pr.f_valid[:, i], i]
            want = np.arange(pr.n_micro)
            if mbs.shape != want.shape or (mbs != want).any():
                out.append(error(
                    "SCH009", _loc(pr, f"stage {i}"),
                    "three-phase F slots are not in flush order; no dense "
                    "forward projection exists for the tick-loop runtime",
                    "keep per-stage F order = micro-batch 0..m-1"))
        return
    for t in range(pr.n_ticks):
        for i in range(P):
            if not pr.valid[t, i]:
                continue
            s = int(pr.chunk_index[t, i]) * P + i
            mb = int(pr.mb_index[t, i])
            if s == 0:
                continue
            ip = (i - 1) % P
            ok = (t >= 1 and pr.valid[t - 1, ip]
                  and int(pr.mb_index[t - 1, ip]) == mb
                  and int(pr.chunk_index[t - 1, ip]) * P + ip == s - 1)
            if not ok:
                out.append(error(
                    "SCH009", _loc(pr, f"tick {t} stage {i}"),
                    f"virtual stage {s} mb={mb} has no producer at "
                    f"(tick {t - 1}, stage {ip}): the single-ppermute "
                    "hand-off would deliver bubble garbage into a counted "
                    "value",
                    "consecutive virtual stages must sit one tick and one "
                    "ring hop apart"))


def _check_loss_coverage(pr: ScheduleProgram, out: List[Diagnostic]) -> None:
    """Each micro-batch's loss fires exactly once, on the last virtual
    stage's F slot (SCH005)."""
    P, m, V = pr.n_stages, pr.n_micro, pr.n_chunks
    counts = np.zeros(m, np.int64)
    for t in range(pr.n_ticks):
        for i in range(P):
            if not pr.loss_valid[t, i]:
                continue
            loc = _loc(pr, f"tick {t} stage {i}")
            if not pr.valid[t, i] or int(pr.phase[t, i]) != PHASE_F:
                out.append(error(
                    "SCH005", loc,
                    "loss_valid set on a bubble or non-forward slot",
                    "loss accumulates only where forward work runs"))
                continue
            if i != P - 1 or int(pr.chunk_index[t, i]) != V - 1:
                out.append(error(
                    "SCH005", loc,
                    f"loss scheduled on virtual stage "
                    f"{int(pr.chunk_index[t, i]) * P + i}, not the last "
                    f"({P * V - 1})",
                    "only the last virtual stage holds the head"))
                continue
            mb = int(pr.mb_index[t, i])
            if 0 <= mb < m:
                counts[mb] += 1
    for mb in range(m):
        if counts[mb] != 1:
            out.append(error(
                "SCH005", _loc(pr, f"micro-batch {mb}"),
                f"loss fires {int(counts[mb])} times (want exactly 1)",
                "each micro-batch contributes its loss exactly once"))


# ---------------------------------------------------------------------------
# liveness certification
# ---------------------------------------------------------------------------

def _max_overlap(starts: np.ndarray, ends: np.ndarray) -> int:
    """Peak number of [start, end) intervals alive at once."""
    ev = sorted([(int(t), 1) for t in starts] + [(int(t), -1) for t in ends])
    c = mx = 0
    for _, d in ev:
        c += d
        mx = max(mx, c)
    return mx


def _simulate_flush_backward(P: int, m: int) -> Tuple[np.ndarray, np.ndarray]:
    """Independent event simulation of the 1F1B-flush schedule: each stage
    greedily runs the oldest ready backward, else the oldest ready forward
    under the defining warm-up constraint (a stage never holds more
    forwards than ``P - i`` un-backwarded micro-batches).  Returns (P, m)
    forward/backward tick matrices; the *measured* peak stash is then an
    interval fact, not a formula."""
    NONE = -1
    ft = np.full((P, m), NONE, np.int64)
    bt = np.full((P, m), NONE, np.int64)
    f_done = [0] * P
    b_done = [0] * P
    t = 0
    limit = 4 * m + 4 * P + 8
    while min(b_done) < m and t < limit:
        acts: List[Optional[Tuple[int, int]]] = []
        for i in range(P):
            j = b_done[i]
            b_ready = (j < m and 0 <= ft[i, j] < t
                       and (i == P - 1 or 0 <= bt[i + 1, j] < t))
            k = f_done[i]
            f_ready = (k < m and (i == 0 or 0 <= ft[i - 1, k] < t)
                       and f_done[i] - b_done[i] < P - i)
            acts.append((PHASE_B, j) if b_ready
                        else (PHASE_F, k) if f_ready else None)
        for i, act in enumerate(acts):
            if act is None:
                continue
            ph, mb = act
            if ph == PHASE_F:
                ft[i, mb] = t
                f_done[i] += 1
            else:
                bt[i, mb] = t
                b_done[i] += 1
        t += 1
    assert min(b_done) == m, "flush-backward simulation did not converge"
    return ft, bt


def _megatron_warmup_chunks(stage: int, n_stages: int, n_chunks: int) -> int:
    """Forward chunks device ``stage`` banks before its first backward in
    the depth-first interleaved 1F1B schedule (Megatron-LM
    ``forward_backward_pipelining_with_interleaving``): two per downstream
    device, one full round per extra model chunk, plus the steady-state
    chunk in flight.  Defined here *independently* of
    ``core/pipeline_balance.py`` so formula drift on either side trips
    SCH007."""
    return 2 * (n_stages - 1 - stage) + (n_chunks - 1) * n_stages + 1


def certify_live_buffers(pr: ScheduleProgram) -> List[StageCertificate]:
    """Per-stage certified peak live activation sets, by liveness analysis.

    * three-phase (``zb-h1``): measured straight off the table — forward
      stash is the peak overlap of per-micro-batch [F, B) tick intervals,
      the deferred weight-gradient pile the peak overlap of [B, W);
    * ``1f1b``: measured on an independent flush-backward event
      simulation (:func:`_simulate_flush_backward`);
    * ``gpipe`` (no remat): stash-to-flush — every forward set lives until
      the post-program backward, so the peak is the per-stage F count;
    * ``1f1b-interleaved``: the Megatron depth-first warm-up depth in
      chunks (:func:`_megatron_warmup_chunks`, capped at the ``m·V``
      chunks that exist), divided by ``V`` for full-stage units.

    The returned units are exactly the ones
    ``cost_model``/``pipeline_balance`` price, so the SCH007 cross-check
    is an equality, not a bound.
    """
    P, m, V = pr.n_stages, pr.n_micro, pr.n_chunks
    out: List[StageCertificate] = []
    if pr.is_three_phase:
        ft = np.full((P, m), -1, np.int64)
        bt = np.full((P, m), -1, np.int64)
        wt = np.full((P, m), -1, np.int64)
        by_phase = {PHASE_F: ft, PHASE_B: bt, PHASE_W: wt}
        for t in range(pr.n_ticks):
            for i in range(P):
                if pr.valid[t, i] and int(pr.phase[t, i]) in by_phase:
                    mb = int(pr.mb_index[t, i])
                    if 0 <= mb < m:
                        by_phase[int(pr.phase[t, i])][i, mb] = t
        big = pr.n_ticks + 1     # missing ticks -> interval to program end
        for i in range(P):
            f = np.where(ft[i] >= 0, ft[i], big)
            b = np.where(bt[i] >= 0, bt[i], big)
            w = np.where(wt[i] >= 0, wt[i], big)
            stash = _max_overlap(f[f <= big], np.maximum(b, f))
            pending = _max_overlap(b[b < big], np.maximum(w, b)[b < big])
            out.append(StageCertificate(
                i, float(stash), int(pending),
                stash + ZB_W_ACT_FRAC * pending))
        return out
    if pr.name == "1f1b":
        ft, bt = _simulate_flush_backward(P, m)
        for i in range(P):
            stash = _max_overlap(ft[i], bt[i])
            out.append(StageCertificate(i, float(stash), 0, float(stash)))
        return out
    if pr.name == "1f1b-interleaved":
        for i in range(P):
            chunks = min(_megatron_warmup_chunks(i, P, V), m * V)
            out.append(StageCertificate(i, chunks / V, 0, chunks / V))
        return out
    # gpipe / any no-remat flush table: stash-to-flush
    for i in range(P):
        stash = int(pr.valid[:, i].sum())
        out.append(StageCertificate(i, float(stash), 0, float(stash)))
    return out


def _check_liveness(pr: ScheduleProgram, out: List[Diagnostic]) -> None:
    """SCH006 (in-flight cap) + SCH007 (cost-model drift)."""
    P, m = pr.n_stages, pr.n_micro
    certs = certify_live_buffers(pr)
    for c in certs:
        i = c.stage
        if pr.name in ("1f1b", "zb-h1"):
            cap = min(P - i, m)
            if c.fwd_stash > cap + _TOL:
                out.append(error(
                    "SCH006", _loc(pr, f"stage {i}"),
                    f"forward stash peaks at {c.fwd_stash:g} activation "
                    f"sets, above the flush in-flight cap min(P-i, m) = "
                    f"{cap}",
                    "delay forwards until a backward retires a set"))
        if pr.name == "zb-h1":
            want_w = zb_w_pending_max(i, P, m)
            if c.w_pending != want_w:
                out.append(error(
                    "SCH007", _loc(pr, f"stage {i}"),
                    f"certified deferred-W pile is {c.w_pending}, but the "
                    f"cost model prices zb_w_pending_max = {want_w}",
                    "re-align core/pipeline_balance.zb_w_pending_max with "
                    "the compiled deferral depth"))
        modeled = inflight_microbatches(i, P, m, pr.name, pr.n_chunks)
        if abs(c.live_sets - modeled) > _TOL:
            out.append(error(
                "SCH007", _loc(pr, f"stage {i}"),
                f"certified peak live buffers = {c.live_sets:g} activation "
                f"sets, but inflight_microbatches prices {modeled:g} — "
                "the memory model and the program have drifted",
                "fix whichever side is wrong; the searcher's feasibility "
                "claims depend on them agreeing"))
    out.append(info(
        "SCH007", _loc(pr),
        "certified peak live buffers per stage: "
        + ", ".join(f"{c.live_sets:g}" for c in certs)
        + " (== cost model)" ))


def _check_bubble(pr: ScheduleProgram, out: List[Diagnostic]) -> None:
    """Re-derive the bubble from the table and pin it against the priced
    ``bubble_fraction`` (SCH008)."""
    busy = int(pr.valid.sum(axis=0).max()) if pr.n_ticks else 0
    compiled = pr.n_ticks - busy
    priced = bubble_fraction(pr.n_stages, pr.n_micro, pr.n_chunks,
                             pr.name) * pr.work_ticks_per_stage
    if abs(compiled - priced) > _TOL:
        direction = ("undersells" if compiled < priced else "oversells")
        out.append(error(
            "SCH008", _loc(pr),
            f"compiled bubble is {compiled} tick(s) but the cost model "
            f"prices {priced:g} — the model {direction} this program",
            "the search must only propose (schedule, P, m, V) combos "
            "whose compiled bubble matches the analytic term "
            "(ragged interleaved groups / zb-h1 with m < P are dropped)"))
    else:
        out.append(info(
            "SCH008", _loc(pr),
            f"compiled bubble = priced bubble = {compiled} tick(s)"))


# ---------------------------------------------------------------------------
# grid enumeration (CLI + CI + tests share one notion of "legal combo")
# ---------------------------------------------------------------------------

#: default certification grid (the acceptance grid): P x m x V
DEFAULT_GRID = ((1, 2, 4, 8), tuple(range(1, 17)), (1, 2))


def schedule_legal(name: str, n_stages: int, n_micro: int,
                   n_chunks: int = 1) -> bool:
    """Can ``compile_schedule(name, P, m, V)`` produce a program the cost
    model prices exactly?  Mirrors ``core/optimizer._schedule_candidates``:
    interleaving needs P > 1, V >= 2 and m % P == 0 (ragged groups change
    the bubble); zb-h1 needs P > 1 and a full pipeline (m >= P)."""
    if name in ("gpipe", "1f1b"):
        return n_chunks == 1 and n_stages >= 1 and n_micro >= 1
    if name == "1f1b-interleaved":
        return (n_chunks >= 2 and n_stages > 1 and n_micro >= 1
                and n_micro % n_stages == 0)
    if name == "zb-h1":
        return n_chunks == 1 and n_stages > 1 and n_micro >= n_stages
    return False


def schedule_grid(stages=DEFAULT_GRID[0], micros=DEFAULT_GRID[1],
                  chunks=DEFAULT_GRID[2]):
    """Yield every legal ``(name, P, m, V)`` combo over the given axes."""
    from repro_torch.runtime.schedules import SCHEDULE_NAMES
    for name in SCHEDULE_NAMES:
        for P in stages:
            for m in micros:
                for V in chunks:
                    if schedule_legal(name, P, m, V):
                        yield name, P, m, V


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def verify_program(pr: ScheduleProgram) -> List[Diagnostic]:
    """Run every schedule check on one compiled program table.

    Returns the full diagnostic list (including ``info`` certification
    telemetry); error severity means the table must not be executed or
    serialized into a plan.
    """
    out: List[Diagnostic] = []
    events = _collect_events(pr, out)
    _check_coverage(pr, events, out)
    _check_happens_before(pr, events, out)
    _check_ring_handoff(pr, out)
    _check_loss_coverage(pr, out)
    _check_liveness(pr, out)
    _check_bubble(pr, out)
    return out


def certify_program(pr: ScheduleProgram) -> DiagnosticReport:
    """:func:`verify_program` wrapped in a :class:`DiagnosticReport`."""
    return DiagnosticReport().extend(verify_program(pr))
