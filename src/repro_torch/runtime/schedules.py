"""Pipeline-schedule subsystem (DESIGN.md §5): the port's NumPy copy of
``repro/runtime/schedules.py``.  The tables serve the plan and schedule
verifiers and the port's pipeline runtime (``runtime/pipeline.py``), which
walks them over ``torch.distributed`` ranks with point-to-point hand-offs
and schedules the backward itself; the text below describes the JAX
runtime, a ``lax.scan`` over ``ppermute``.

A *schedule* is compiled ahead of time into a per-tick **program table**:
for every tick ``t`` and pipeline stage ``i`` the table says which
micro-batch to process, which local virtual chunk of layers to run, whether
the slot is real work or a bubble, and whether the tick finishes the last
virtual stage (head + loss).  The runtime (``runtime/pipeline.py``) then
executes *one* generic ``lax.scan`` tick loop for every schedule — the
schedules differ only in data, not in code.

Supported schedules:

  * ``gpipe``             — all ``m`` micro-batches stream through ``P``
    stages; every tick's activations are stashed (GPipe memory, Eq. 5).
  * ``1f1b``              — same tick order (a flush schedule's forward
    order is GPipe's), but the tick body is rematerialized so only the
    per-tick boundary carries are stashed — the 1F1B-flush *memory*
    profile (``P - i`` in-flight sets on stage ``i``, Eq. 9).
  * ``1f1b-interleaved``  — each device owns ``V`` *virtual chunks*;
    global virtual stage ``s = v·P + i`` lives on device ``i`` as chunk
    ``v``.  Micro-batches advance in groups of ``P``, shrinking the
    pipeline bubble from ``(P-1)/m`` to ``(P-1)/(m·V)`` at the price of
    ``V×`` hand-off traffic and deeper warm-up queues.
  * ``zb-h1``             — zero-bubble (handcrafted schedule 1, after
    Qi et al., "Zero Bubble Pipeline Parallelism"): the backward pass is
    split into a **B** tick (activation gradient, on the critical path to
    the upstream stage) and a **W** tick (weight gradient, no inter-stage
    dependency).  W ticks are *deferred* and spent filling what would be
    the 1F1B bubble, shrinking it from ``3(P-1)`` to exactly ``P-1``
    unit ticks (the unavoidable warm-up fill) at the price of the
    deferred weight-gradient activation stash — up to
    ``max(1, m - P + 1 + i)`` pending W sets on stage ``i``
    (``docs/schedules.md``).  Compiled as a genuine three-phase table by
    a greedy event simulation (:func:`_compile_zb_h1`); the runtime
    executes its *forward projection*
    (:meth:`ScheduleProgram.forward_program`) — the B ticks are realized
    by autodiff of the rematerialized scan, the W ticks by the
    weight-gradient work XLA schedules in the backward.

Tick mapping (one formula covers all three; ``V = 1`` recovers GPipe/1F1B):
virtual stage ``s = v·P + i`` processes micro-batch ``mb = g·P + r``
(group ``g = mb // P``, offset ``r = mb % P``) at tick

    t = i + r + P·(g·V + v)

Consecutive virtual stages always sit one ring hop and one tick apart —
``s → s+1`` is either device ``i → i+1`` (same chunk) or the wrap link
``P-1 → 0`` (chunk ``v → v+1``) — so a single ``ppermute`` over the full
ring moves every in-flight activation between ticks.  Inverting the
mapping per (tick, device): ``k = t - i``, ``r = k mod P``,
``v = (k div P) mod V``, ``g = k div (P·V)`` — unique, so a device never
has two chunks scheduled on the same tick.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

# single source of truth for the ZB-H1 deferred-W depth: the cost model
# prices it and the greedy compiler below realizes it (re-exported here
# because schedule consumers are runtime-side)
from repro_torch.core.pipeline_balance import zb_w_pending_max  # noqa: F401

SCHEDULE_NAMES: Tuple[str, ...] = ("gpipe", "1f1b", "1f1b-interleaved",
                                   "zb-h1")

# phase codes for three-phase (zero-bubble) program tables
PHASE_F, PHASE_B, PHASE_W = 0, 1, 2


@dataclasses.dataclass(frozen=True)
class ScheduleProgram:
    """A compiled schedule: per-tick program tables, all shaped (T, P)."""

    name: str
    n_stages: int            # P — pipeline stages (devices on the pipe axis)
    n_chunks: int            # V — virtual chunks per stage (1 unless interleaved)
    n_micro: int             # m — micro-batches per iteration
    n_ticks: int             # T — scan length
    remat: bool              # rematerialize the tick body (1F1B memory profile)
    mb_index: np.ndarray     # (T, P) int32, clipped to [0, m) — micro-batch
    chunk_index: np.ndarray  # (T, P) int32 in [0, V) — local virtual chunk
    valid: np.ndarray        # (T, P) bool — real work (False = bubble slot)
    loss_valid: np.ndarray   # (T, P) bool — tick finishes virtual stage P·V-1
    # (T, P) int8 ∈ {PHASE_F, PHASE_B, PHASE_W}, meaningful where ``valid``.
    # Single-phase schedules (gpipe / 1f1b / interleaved) are all-F; only
    # ``zb-h1`` compiles genuine B/W ticks.  ``None`` normalizes to all-F.
    phase: Optional[np.ndarray] = None

    @property
    def is_three_phase(self) -> bool:
        """True when the table carries split-backward (B/W) ticks."""
        return bool((self.phase > PHASE_F).any())

    @property
    def work_ticks_per_stage(self) -> int:
        """Busy ticks a fully-loaded stage runs: ``m·V`` chunk ticks for
        single-phase schedules, ``3·m·V`` (one F, one B, one W per
        micro-batch chunk) for three-phase tables."""
        return self.n_micro * self.n_chunks * (3 if self.is_three_phase else 1)

    @property
    def bubble_ticks(self) -> int:
        """Fill+drain ticks beyond the ideal :attr:`work_ticks_per_stage`.

        ``P - 1`` for single-chunk single-phase schedules and for
        interleaved programs with full micro-batch groups (``m % P == 0``).
        A ragged last group (``m % P != 0``) leaves extra idle slots, so
        the optimizer only proposes interleaving when ``m`` divides evenly
        (the analytic ``(P-1)/(m·V)`` bubble would otherwise understate
        this program).  For ``zb-h1`` the deferred W ticks refill most of
        the drain: the compiled bubble sits near ``P - 1`` three-phase
        unit ticks versus 1F1B's ``3(P-1)`` equivalent."""
        return self.n_ticks - self.work_ticks_per_stage

    @property
    def f_valid(self) -> np.ndarray:
        """(T, P) bool — slots that run the *forward* stage body."""
        return self.valid & (self.phase == PHASE_F)

    def forward_program(self) -> "ScheduleProgram":
        """The forward projection executed by ``runtime/pipeline.py``.

        Single-phase programs are their own forward projection.  For
        three-phase tables, every stage's F slots process micro-batches
        ``0..m-1`` in order (asserted), so the densest forward execution
        is the classic flush diagonal — the same table ``1f1b`` compiles,
        under which every hand-off producer sits exactly one tick and one
        ring hop upstream of its consumer (the single-carry ``ppermute``
        invariant).  The B ticks are realized by autodiff of the
        rematerialized scan and the W ticks by the weight-gradient
        computations XLA places in the backward; their *timing* (what the
        deferred W slots buy on real parallel hardware) is exactly what
        the three-phase table models for the cost model.

        Returns:
          A single-phase :class:`ScheduleProgram` with this program's
          name, ``remat`` and (P, V, m), safe for the generic tick loop.
        """
        if not self.is_three_phase:
            return self
        for i in range(self.n_stages):
            mbs = self.mb_index[self.f_valid[:, i], i]
            assert (mbs == np.arange(self.n_micro)).all(), (
                "three-phase program's F slots are not in flush order; "
                "no dense forward projection exists")
        diag = compile_schedule("1f1b", self.n_stages, self.n_micro)
        return dataclasses.replace(diag, name=self.name, remat=self.remat)

    def __post_init__(self):
        if self.phase is None:
            object.__setattr__(
                self, "phase",
                np.zeros((self.n_ticks, self.n_stages), np.int8))
        for f in ("mb_index", "chunk_index", "valid", "loss_valid", "phase"):
            assert getattr(self, f).shape == (self.n_ticks, self.n_stages), f


def _validate_program(prog: ScheduleProgram) -> ScheduleProgram:
    """Run the static schedule verifier (``repro_torch.analysis``) on a freshly
    compiled table; raise its structured ``DiagnosticError`` on any
    error-severity finding.  Local import: analysis imports this module,
    and validation is opt-in on the hot path."""
    from repro_torch.analysis.schedule_lint import certify_program
    certify_program(prog).raise_if_errors(
        context=f"compile_schedule({prog.name!r}, P={prog.n_stages}, "
                f"m={prog.n_micro}, V={prog.n_chunks})")
    return prog


def compile_schedule(name: str, n_stages: int, n_micro: int,
                     n_chunks: Optional[int] = None, *,
                     validate: bool = False) -> ScheduleProgram:
    """Compile ``name`` into a :class:`ScheduleProgram`.

    Args:
      name: one of :data:`SCHEDULE_NAMES` (``gpipe`` / ``1f1b`` /
        ``1f1b-interleaved`` / ``zb-h1``).
      n_stages: ``P`` — pipeline stages (size of the mesh ``pipe`` axis).
      n_micro: ``m`` — micro-batches per iteration.
      n_chunks: ``V`` — virtual chunks per stage.  Only meaningful for
        ``1f1b-interleaved`` (default 2 there, must be >= 2); every other
        schedule is single-chunk and rejects V > 1.
      validate: run the static schedule verifier on the compiled table
        (happens-before edges, loss coverage, certified liveness vs the
        cost model, bubble pin — the invariants documented in
        ``docs/analysis.md``) and raise
        :class:`repro_torch.analysis.DiagnosticError` on any error finding.
        Off by default: the searcher compiles thousands of tables whose
        shape-level legality the optimizer already guarantees.

    Returns:
      The compiled :class:`ScheduleProgram` — per-tick ``(T, P)`` tables
      the generic ``runtime/pipeline.py`` scan loop replays.

    Raises:
      ValueError: unknown ``name``, non-positive ``n_stages`` /
        ``n_micro``, or an ``n_chunks`` the schedule cannot use; with
        ``validate=True`` also any certification failure (the raised
        ``DiagnosticError`` is a ``ValueError`` carrying the structured
        diagnostics).
    """
    if name not in SCHEDULE_NAMES:
        raise ValueError(f"unknown schedule {name!r}; "
                         f"expected one of {SCHEDULE_NAMES}")
    if n_stages < 1:
        raise ValueError(f"n_stages must be >= 1, got {n_stages}")
    if n_micro < 1:
        raise ValueError(f"n_micro must be >= 1, got {n_micro}")
    if name == "zb-h1":
        if n_chunks is not None and int(n_chunks) != 1:
            raise ValueError(f"schedule 'zb-h1' is single-chunk; "
                             f"got n_chunks={n_chunks}")
        prog = _compile_zb_h1(int(n_stages), int(n_micro))
        return _validate_program(prog) if validate else prog
    if name == "1f1b-interleaved":
        V = 2 if n_chunks is None else int(n_chunks)
        if V < 2:
            raise ValueError(
                f"1f1b-interleaved needs n_chunks >= 2, got {V} "
                "(V=1 is plain 1f1b)")
    else:
        V = 1 if n_chunks is None else int(n_chunks)
        if V != 1:
            raise ValueError(f"schedule {name!r} is single-chunk; "
                             f"got n_chunks={V}")

    P, m = int(n_stages), int(n_micro)
    # last slot: micro-batch m-1 (g = (m-1)//P, r = (m-1)%P) finishing the
    # last virtual stage (i = P-1, v = V-1)
    T = (P - 1) + ((m - 1) % P) + P * (((m - 1) // P) * V + (V - 1)) + 1

    t = np.arange(T, dtype=np.int64)[:, None]          # (T, 1)
    i = np.arange(P, dtype=np.int64)[None, :]          # (1, P)
    k = t - i
    nonneg = k >= 0
    kc = np.maximum(k, 0)
    r = kc % P
    q = kc // P
    v = q % V
    g = q // V
    mb = g * P + r
    valid = nonneg & (mb < m)
    loss_valid = valid & (i == P - 1) & (v == V - 1)
    prog = ScheduleProgram(
        name=name, n_stages=P, n_chunks=V, n_micro=m, n_ticks=T,
        remat=(name != "gpipe"),
        mb_index=np.clip(mb, 0, m - 1).astype(np.int32),
        chunk_index=v.astype(np.int32),
        valid=valid,
        loss_valid=loss_valid,
    )
    return _validate_program(prog) if validate else prog


def _compile_zb_h1(P: int, m: int) -> ScheduleProgram:
    """Greedy event simulation of the ZB-H1 zero-bubble schedule.

    Unit-tick model (``T_F = T_B = T_W``, the handcrafted-schedule
    assumption): each stage picks one action per tick —

      1. the oldest *ready* B (activation gradient; its F is done and the
         downstream stage's B for the same micro-batch has arrived),
      2. else the oldest ready F, subject to the 1F1B in-flight cap
         ``min(P - i, m)`` (the forward-activation stash never exceeds
         the 1F1B-flush profile),
      3. else a deferred W (weight gradient — always runnable once its B
         is done, never on the inter-stage critical path),
      4. else bubble.

    All stages decide simultaneously from the previous ticks' state, so
    every dependency is satisfied strictly earlier than its consumer.
    Deferring W maximally lets the banked W ticks fill every drain stall,
    so the compiled program runs in ``3m + P - 1`` unit ticks for
    ``m >= P`` — bubble exactly ``P - 1``, a third of 1F1B's ``3(P-1)``
    equivalent — at the price of :func:`zb_w_pending_max` deferred
    weight-gradient sets per stage.
    """
    NONE = -1
    f_tick = np.full((P, m), NONE, np.int64)
    b_tick = np.full((P, m), NONE, np.int64)
    w_tick = np.full((P, m), NONE, np.int64)
    f_done = [0] * P
    b_done = [0] * P
    w_done = [0] * P
    rows = []                                   # per tick: [(phase, mb)|None]
    limit = 4 * m + 4 * P + 8                   # safety stop (never hit)
    t = 0
    while min(w_done) < m and t < limit:
        acts = []
        for i in range(P):
            act = None
            j = b_done[i]
            b_ready = (j < m and 0 <= f_tick[i, j] < t
                       and (i == P - 1 or 0 <= b_tick[i + 1, j] < t))
            k = f_done[i]
            f_ready = (k < m
                       and (i == 0 or 0 <= f_tick[i - 1, k] < t)
                       # 1F1B warm-up / in-flight cap
                       and f_done[i] - b_done[i] < min(P - i, m))
            if b_ready:
                act = (PHASE_B, j)
            elif f_ready:
                act = (PHASE_F, k)
            elif b_done[i] - w_done[i] > 0:
                act = (PHASE_W, w_done[i])
            acts.append(act)
        for i, act in enumerate(acts):          # commit simultaneously
            if act is None:
                continue
            phase, mb = act
            (f_tick, b_tick, w_tick)[phase][i, mb] = t
            if phase == PHASE_F:
                f_done[i] += 1
            elif phase == PHASE_B:
                b_done[i] += 1
            else:
                w_done[i] += 1
        rows.append(acts)
        t += 1
    assert min(w_done) == m, "zb-h1 simulation did not converge"

    T = len(rows)
    mb_index = np.zeros((T, P), np.int32)
    chunk_index = np.zeros((T, P), np.int32)
    valid = np.zeros((T, P), bool)
    phase = np.zeros((T, P), np.int8)
    for tt, acts in enumerate(rows):
        for i, act in enumerate(acts):
            if act is None:
                continue
            phase[tt, i] = act[0]
            mb_index[tt, i] = act[1]
            valid[tt, i] = True
    # the executed forward finishes a micro-batch (head + loss) at its
    # last-stage F tick; the B tick on that slot is the loss backward
    loss_valid = valid & (phase == PHASE_F)
    loss_valid[:, :P - 1] = False
    return ScheduleProgram(
        name="zb-h1", n_stages=P, n_chunks=1, n_micro=m, n_ticks=T,
        remat=True, mb_index=mb_index, chunk_index=chunk_index,
        valid=valid, loss_valid=loss_valid, phase=phase)
