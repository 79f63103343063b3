"""Host-side serving telemetry: per-request latency accounting plus
engine-level queue/occupancy samples, aggregated into a JSON-able summary
(a pure-Python copy of the JAX package's ``serving/metrics.py``).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional


def _pct(sorted_vals: List[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1, int(q * (len(sorted_vals) - 1) + 0.5))
    return sorted_vals[i]


@dataclasses.dataclass
class RequestMetrics:
    """Latency record of one served request (wall-clock seconds)."""

    rid: str
    arrival_s: float
    prompt_tokens: int = 0
    new_tokens: int = 0
    first_token_s: Optional[float] = None    # absolute time of first token
    finish_s: Optional[float] = None
    deadline_ms: float = 0.0                 # 0 = no per-token SLO attached

    @property
    def ttft_ms(self) -> Optional[float]:
        if self.first_token_s is None:
            return None
        return (self.first_token_s - self.arrival_s) * 1e3

    @property
    def tok_ms(self) -> Optional[float]:
        """Mean per-token decode latency after the first token."""
        if (self.finish_s is None or self.first_token_s is None
                or self.new_tokens <= 1):
            return None
        return ((self.finish_s - self.first_token_s)
                / (self.new_tokens - 1)) * 1e3


@dataclasses.dataclass
class ServeMetrics:
    """Aggregated over one engine run."""

    requests: List[RequestMetrics] = dataclasses.field(default_factory=list)
    queue_depth: List[int] = dataclasses.field(default_factory=list)
    page_occupancy: List[float] = dataclasses.field(default_factory=list)
    decode_steps: int = 0
    prefill_chunks: int = 0
    wall_s: float = 0.0

    def summary(self) -> Dict:
        done = [r for r in self.requests if r.finish_s is not None]
        ttfts = sorted(r.ttft_ms for r in done if r.ttft_ms is not None)
        toks = sorted(r.tok_ms for r in done if r.tok_ms is not None)
        total_new = sum(r.new_tokens for r in done)
        return {
            "requests": len(self.requests),
            "completed": len(done),
            "new_tokens": total_new,
            "decode_steps": self.decode_steps,
            "prefill_chunks": self.prefill_chunks,
            "wall_s": self.wall_s,
            "tok_per_s": (total_new / self.wall_s if self.wall_s else 0.0),
            "ttft_ms_p50": _pct(ttfts, 0.5),
            "ttft_ms_p99": _pct(ttfts, 0.99),
            "tok_ms_p50": _pct(toks, 0.5),
            "tok_ms_p99": _pct(toks, 0.99),
            "queue_depth_max": max(self.queue_depth, default=0),
            "page_occupancy_mean": (sum(self.page_occupancy)
                                    / len(self.page_occupancy)
                                    if self.page_occupancy else 0.0),
            "page_occupancy_max": max(self.page_occupancy, default=0.0),
        }
