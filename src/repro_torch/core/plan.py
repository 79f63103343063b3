# The port's copy of repro/core/plan.py: the same names and arithmetic.
"""Serializable parallelism plan — the output of the Galvatron-BMW search
and the input of the execution runtime.

JSON format versioning (full schema + compat table: docs/plan-format.md):

  * v0 — no ``vpp_degree`` key; ``schedule`` may be absent too.
  * v1 — ``schedule`` + ``vpp_degree`` always present.
  * v2 — ``format_version`` stamp; ``schedule`` may be ``"zb-h1"``.
  * v3 — optional ``serving`` section (:class:`ServingSection`):
    the SLO-aware serving search's prefill/decode disaggregation plan
    (TP/PP per phase, decode batch, paged-KV page size / pool size).
    ``serving`` may be ``null``/absent — a v3 plan without it is a pure
    training plan.
  * v4 — optional ``sp_degree`` (sequence-parallel / ring-attention
    degree, default 1 = no sequence sharding) and ``seq_len`` (the
    sequence length the plan was searched for, default 0 = unrecorded;
    lint rule PLN011 checks ``seq_len % sp_degree == 0`` when both are
    present).
  * v5 — optional ``ep_degree`` (expert-parallel degree: MoE
    experts sharded over an expert axis with all-to-all dispatch/combine,
    default 1 = experts replicated; lint rule PLN012 checks the device
    factorization and that per-layer ``ep`` degrees stay under the stamp).

``from_json`` reads every older version (missing keys default to the
value that version implied: ``schedule="1f1b"``, ``vpp_degree=1``,
``serving=None``, ``sp_degree=1``, ``seq_len=0``, ``ep_degree=1``);
``to_json`` always writes the current version.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

from .strategy import Strategy

#: version stamp written by :meth:`ParallelPlan.to_json` (see module doc)
PLAN_FORMAT_VERSION = 5


@dataclasses.dataclass
class ServingSection:
    """Optional inference block of a plan (format v3+).

    Emitted by the SLO-aware serving search (``repro_torch.serving.slo_search``)
    and consumed by ``launch/serve.py --plan``.  Prefill and decode are
    disaggregated phases with independent TP/PP degrees; the paged KV
    cache is described by ``page_size`` / ``kv_pool_pages``.  All ``est_*``
    fields are cost-model predictions, not measurements."""

    slo_ms: float                 # per-decoded-token latency SLO
    page_size: int                # tokens per KV page
    max_context: int              # per-request context ceiling (tokens)
    decode_batch: int             # continuous-batching decode lanes
    prefill_chunk: int            # chunked-prefill tokens per jit call
    decode_tp: int = 1
    decode_pp: int = 1
    prefill_tp: int = 1
    prefill_pp: int = 1
    kv_pool_pages: int = 0        # shared page-pool capacity (pages/layer)
    ttft_slo_ms: float = 0.0      # 0 = no TTFT target
    est_tok_ms: float = 0.0       # predicted per-token decode latency
    est_ttft_ms: float = 0.0      # predicted time-to-first-token
    est_tok_per_s: float = 0.0    # predicted aggregate decode throughput

    def to_json(self) -> Dict:
        return dataclasses.asdict(self)

    @staticmethod
    def from_json(d: Dict) -> "ServingSection":
        if not isinstance(d, dict):
            raise PlanFormatError(
                "serving",
                f"must be an object or null, got {type(d).__name__}")

        def req(key):
            try:
                return d[key]
            except KeyError:
                raise PlanFormatError(
                    f"serving.{key}",
                    "required serving field is missing") from None

        known = {f.name for f in dataclasses.fields(ServingSection)}
        extra = {k: v for k, v in d.items() if k in known
                 and k not in ("slo_ms", "page_size", "max_context",
                               "decode_batch", "prefill_chunk")}
        return ServingSection(
            slo_ms=req("slo_ms"),
            page_size=req("page_size"),
            max_context=req("max_context"),
            decode_batch=req("decode_batch"),
            prefill_chunk=req("prefill_chunk"),
            **extra,
        )


class PlanFormatError(ValueError):
    """Structured plan-JSON failure: names the offending field.

    Raised by :meth:`ParallelPlan.from_json` instead of leaking a bare
    ``KeyError``/``TypeError`` stack trace, so CLIs and the plan verifier
    (``repro_torch.analysis.plan_lint``) can point at the exact field.  The full
    multi-diagnostic verification lives in the verifier; this is the
    minimal always-on guard for any loading path."""

    def __init__(self, field: str, message: str):
        self.field = field
        super().__init__(f"plan.{field}: {message}")


@dataclasses.dataclass
class ParallelPlan:
    """A complete distributed-execution plan for one model + cluster."""

    n_devices: int
    pp_degree: int
    partition: List[int]                 # layers per pipeline stage
    strategies: List[Strategy]           # one per layer (concatenated stages)
    global_batch: int
    n_micro: int
    schedule: str = "1f1b"
    vpp_degree: int = 1                  # virtual chunks per stage (V);
                                         # > 1 only with "1f1b-interleaved"
    sp_degree: int = 1                   # sequence-parallel (ring attention)
                                         # degree; 1 = no sequence sharding
    seq_len: int = 0                     # searched sequence length (tokens);
                                         # 0 = unrecorded (pre-v4 plans)
    ep_degree: int = 1                   # expert-parallel degree (sharded
                                         # MoE experts); 1 = replicated

    # estimator outputs (filled by the search)
    est_iter_time: float = 0.0
    est_throughput: float = 0.0          # samples / s
    est_stage_mem: Optional[List[float]] = None
    alpha_t: float = 0.0
    alpha_m: float = 0.0
    searched_by: str = "galvatron-bmw"
    # inference plan (v3+); None for pure training plans
    serving: Optional[ServingSection] = None
    # search-engine telemetry (stage-search / cache-hit counts, wall time);
    # excluded from equality so cached and uncached searches that find the
    # same plan compare equal
    search_stats: Optional[Dict[str, float]] = dataclasses.field(
        default=None, compare=False)

    def __post_init__(self):
        if self.n_micro < 1:
            raise ValueError(f"n_micro must be >= 1, got {self.n_micro}")
        if self.global_batch % self.n_micro:
            raise ValueError(
                f"global_batch={self.global_batch} is not divisible by "
                f"n_micro={self.n_micro}: micro-batches would be uneven "
                "(pick n_micro dividing the global batch)")
        if self.vpp_degree < 1:
            raise ValueError(
                f"vpp_degree must be >= 1, got {self.vpp_degree}")
        if self.sp_degree < 1:
            raise ValueError(
                f"sp_degree must be >= 1, got {self.sp_degree}")
        if self.ep_degree < 1:
            raise ValueError(
                f"ep_degree must be >= 1, got {self.ep_degree}")

    @property
    def micro_batch_size(self) -> int:
        # exact by the __post_init__ divisibility check
        return self.global_batch // self.n_micro

    def stage_strategies(self, stage: int) -> List[Strategy]:
        start = sum(self.partition[:stage])
        return self.strategies[start:start + self.partition[stage]]

    def summary(self) -> str:
        segs: List[str] = []
        run, prev = 0, None
        for s in self.strategies + [None]:
            name = s.name() if s is not None else None
            if name == prev:
                run += 1
                continue
            if prev is not None:
                segs.append(f"{prev} x{run}")
            prev, run = name, 1
        sched = (f"{self.schedule}" if self.vpp_degree == 1
                 else f"{self.schedule}(V={self.vpp_degree})")
        return (f"pp{self.pp_degree} p={self.partition} B={self.global_batch} "
                f"m={self.n_micro} {sched} | " + ", ".join(segs))

    # ---- (de)serialization ----------------------------------------------
    def to_json(self) -> Dict:
        return {
            "format_version": PLAN_FORMAT_VERSION,
            "n_devices": self.n_devices,
            "pp_degree": self.pp_degree,
            "partition": self.partition,
            "strategies": [s.to_json() for s in self.strategies],
            "global_batch": self.global_batch,
            "n_micro": self.n_micro,
            "schedule": self.schedule,
            "vpp_degree": self.vpp_degree,
            "sp_degree": self.sp_degree,
            "seq_len": self.seq_len,
            "ep_degree": self.ep_degree,
            "est_iter_time": self.est_iter_time,
            "est_throughput": self.est_throughput,
            "est_stage_mem": self.est_stage_mem,
            "alpha_t": self.alpha_t,
            "alpha_m": self.alpha_m,
            "searched_by": self.searched_by,
            "serving": (self.serving.to_json()
                        if self.serving is not None else None),
            "search_stats": self.search_stats,
        }

    def dumps(self) -> str:
        return json.dumps(self.to_json(), indent=2)

    def canonical_json(self) -> Dict:
        """``to_json()`` minus the ``search_stats`` telemetry — everything
        that defines the plan's execution semantics and estimates, nothing
        that depends on how the search was run (caches, workers, wall
        time).  Two searches agree iff their canonical JSON agrees."""
        d = self.to_json()
        d.pop("search_stats", None)
        return d

    def canonical_dumps(self) -> str:
        """Deterministic byte representation of :meth:`canonical_json`
        (sorted keys, no whitespace variance) — the byte-identity oracle
        used by the frontier differential tests and benchmarks."""
        return json.dumps(self.canonical_json(), sort_keys=True)

    @staticmethod
    def from_json(d: Dict) -> "ParallelPlan":
        if not isinstance(d, dict):
            raise PlanFormatError(
                "", f"plan JSON must be an object, got {type(d).__name__}")
        ver = d.get("format_version", 0)
        if isinstance(ver, int) and ver > PLAN_FORMAT_VERSION:
            raise PlanFormatError(
                "format_version",
                f"declares v{ver}, but this build reads "
                f"<= v{PLAN_FORMAT_VERSION}; re-emit the plan with this "
                "build's search CLI")

        def req(key):
            try:
                return d[key]
            except KeyError:
                raise PlanFormatError(
                    key, "required field is missing (every plan version "
                         "carries it; the file is truncated or not a "
                         "plan)") from None

        strategies = []
        for j, s in enumerate(req("strategies")):
            try:
                strategies.append(Strategy.from_json(s))
            except (KeyError, TypeError, ValueError) as e:
                raise PlanFormatError(
                    f"strategies[{j}]",
                    f"strategy does not parse ({e!r}); see "
                    "docs/plan-format.md for the per-layer schema"
                ) from None
        return ParallelPlan(
            n_devices=req("n_devices"),
            pp_degree=req("pp_degree"),
            partition=list(req("partition")),
            strategies=strategies,
            global_batch=req("global_batch"),
            n_micro=req("n_micro"),
            schedule=d.get("schedule", "1f1b"),
            # v0 plan JSON predates interleaved schedules
            vpp_degree=d.get("vpp_degree", 1),
            # pre-v4 plan JSON predates sequence parallelism
            sp_degree=d.get("sp_degree", 1),
            seq_len=d.get("seq_len", 0),
            # pre-v5 plan JSON predates expert parallelism
            ep_degree=d.get("ep_degree", 1),
            est_iter_time=d.get("est_iter_time", 0.0),
            est_throughput=d.get("est_throughput", 0.0),
            est_stage_mem=d.get("est_stage_mem"),
            alpha_t=d.get("alpha_t", 0.0),
            alpha_m=d.get("alpha_m", 0.0),
            searched_by=d.get("searched_by", "galvatron-bmw"),
            # pre-v3 plan JSON has no serving section
            serving=(ServingSection.from_json(d["serving"])
                     if d.get("serving") is not None else None),
            search_stats=d.get("search_stats"),
        )

    @staticmethod
    def loads(s: str) -> "ParallelPlan":
        return ParallelPlan.from_json(json.loads(s))
