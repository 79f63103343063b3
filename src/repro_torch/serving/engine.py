"""Continuous-batching serving engine over the paged KV cache.

The port of the JAX package's ``serving/engine.py``, with the same policy:
host-side orchestration around two device steps (``runtime/executor.py``),

  * a **chunked prefill** step — one fixed-shape prompt chunk
    ``(prefill_batch, prefill_chunk)`` for newly admitted requests, writing
    their K/V into the shared page pools, and
  * a **decode** step — every active lane advances one token against the
    page pools.

Queued requests are admitted in arrival order, prefilled chunk by chunk
between decode rounds and dropped into free decode lanes; slots are recycled
as requests finish and their pages return to the pool.  Tokens are greedy.

Given a ``("data", "model")`` mesh, every rank runs the engine on the same
requests: the steps are sharded (``runtime/executor.py``; under TP each
pool holds the rank's KV heads) and return the same logits on every rank,
and every host decision is taken alike: admission reads rank 0's clock.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Deque, List, Optional

import numpy as np
import torch
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.device import resolve_device
from repro_torch.models.common import ModelConfig
from repro_torch.models.transformer import (LM, init_paged_state,
                                            supports_paged_decode)
from repro_torch.runtime.executor import (make_paged_decode_step,
                                          make_paged_prefill_step)
from repro_torch.runtime.sharding import ShardPolicy

from .metrics import RequestMetrics, ServeMetrics
from .page_table import PageManager, PageState


@dataclasses.dataclass
class ServeRequest:
    """One generation request with scheduling metadata."""

    rid: str
    prompt: List[int]
    max_new: int
    arrival_s: float = 0.0          # offset from engine start
    deadline_ms: float = 0.0        # per-token latency SLO (0 = none)
    tokens: List[int] = dataclasses.field(default_factory=list)  # generated
    done: bool = False


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Static geometry of one engine instance."""

    page_size: int = 16
    n_pages: int = 256              # shared pool rows per layer
    decode_slots: int = 8           # continuous-batching lanes
    max_context: int = 256          # per-lane ceiling (pages_per_slot * psz)
    prefill_batch: int = 4          # prompts prefetched per prefill round
    prefill_chunk: int = 32         # tokens per prefill call
    eos_id: Optional[int] = None

    def __post_init__(self):
        if self.max_context % self.page_size:
            raise ValueError(
                f"max_context={self.max_context} must be a multiple of "
                f"page_size={self.page_size}")

    @property
    def pages_per_slot(self) -> int:
        return self.max_context // self.page_size


class ServingEngine:
    """Greedy continuous-batching server for dense decoder LMs.

    ``params`` must lie on ``device``; pools and the page table are made
    there.  With a ``mesh`` every rank of it builds the engine and runs the
    same requests under ``policy`` (the reference's default
    ``ShardPolicy(tp=False, zero=False)``), its ``params`` its shards
    (``runtime/executor.py::init_serving_params``); raises ValueError as
    ``ShardContext`` does."""

    def __init__(self, cfg: ModelConfig, params: LM, ecfg: EngineConfig, *,
                 device: torch.device = "cuda",
                 mesh: Optional[DeviceMesh] = None,
                 policy: Optional[ShardPolicy] = None):
        if not supports_paged_decode(cfg):
            raise NotImplementedError(
                f"paged serving does not support arch_type={cfg.arch_type!r}")
        self.device = resolve_device(device)
        if params.embed.device != self.device:
            raise ValueError(f"params lie on {params.embed.device}, the "
                             f"engine runs on {self.device}")
        self.cfg = cfg
        self.params = params
        self.ecfg = ecfg
        self.pm = PageManager(n_pages=ecfg.n_pages,
                              n_slots=ecfg.decode_slots,
                              page_size=ecfg.page_size,
                              pages_per_slot=ecfg.pages_per_slot,
                              device=self.device)
        self._decode = make_paged_decode_step(cfg, mesh=mesh, policy=policy)
        self._prefill = make_paged_prefill_step(cfg, mesh=mesh,
                                                policy=policy)
        self.shard = self._decode.shard
        self.pools = init_paged_state(cfg, ecfg.n_pages, ecfg.page_size,
                                      device=self.device, shard=self.shard)
        self.state: PageState = self.pm.init()
        self.metrics = ServeMetrics()
        # host-side per-slot bookkeeping
        self._slot_req: List[Optional[ServeRequest]] = \
            [None] * ecfg.decode_slots
        self._slot_rm: List[Optional[RequestMetrics]] = \
            [None] * ecfg.decode_slots

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(a).to(self.device)

    # ---- admission + prefill --------------------------------------------
    def _free_slots(self) -> List[int]:
        active = self.state.active.cpu().numpy()
        return [i for i in range(self.ecfg.decode_slots) if not active[i]]

    def _admit_batch(self, queue: Deque[ServeRequest], now: float
                     ) -> List[int]:
        """Claim slots + prompt pages for up to ``prefill_batch`` queued
        requests (arrival order); returns the admitted slot ids."""
        admitted: List[int] = []
        free = self._free_slots()
        while (queue and free and len(admitted) < self.ecfg.prefill_batch):
            req = queue[0]
            if req.arrival_s > now:        # sorted by arrival: rest is later
                break
            if len(req.prompt) > self.ecfg.max_context:
                raise ValueError(
                    f"request {req.rid!r}: prompt length {len(req.prompt)} "
                    f"exceeds max_context={self.ecfg.max_context}")
            slot = free[0]
            st, ok = self.pm.admit(self.state, slot, len(req.prompt))
            if not bool(ok):
                break                      # pool full — retry next round
            self.state = st
            queue.popleft()
            free.pop(0)
            self._slot_req[slot] = req
            self._slot_rm[slot] = RequestMetrics(
                rid=req.rid, arrival_s=now,
                prompt_tokens=len(req.prompt),
                deadline_ms=req.deadline_ms)
            admitted.append(slot)
        return admitted

    def _prefill_admitted(self, slots: List[int], t0: float) -> None:
        """Chunked prefill for the admitted slots; records TTFT and seeds
        each lane's first generated token."""
        ecfg, pm = self.ecfg, self.pm
        PB, S = ecfg.prefill_batch, ecfg.prefill_chunk
        reqs = [self._slot_req[s] for s in slots]
        plens = [len(r.prompt) for r in reqs]
        # host-padded prompt block (PB, ceil(max_len / S) * S)
        n_chunks = -(-max(plens) // S)
        block = np.zeros((PB, n_chunks * S), np.int32)
        for i, r in enumerate(reqs):
            block[i, :len(r.prompt)] = r.prompt
        rows = np.full((PB, pm.pages_per_slot), -1, np.int32)
        rows[:len(slots)] = self.state.page_rows.cpu().numpy()[slots]
        prompt_len = np.zeros((PB,), np.int32)
        prompt_len[:len(slots)] = plens
        rows_t, plen_t = self._tensor(rows), self._tensor(prompt_len)
        for c in range(n_chunks):
            base = c * S
            logits = self._prefill(
                self.params, self.pools,
                self._tensor(np.ascontiguousarray(block[:, base:base + S])),
                rows_t, base, plen_t)
            self.metrics.prefill_chunks += 1
            first = logits.argmax(dim=-1).cpu().numpy()
            tnow = time.perf_counter() - t0
            for i, (slot, r) in enumerate(zip(slots, reqs)):
                if base <= plens[i] - 1 < base + S:    # prompt ends here
                    r.tokens.append(int(first[i]))
                    rm = self._slot_rm[slot]
                    rm.first_token_s = tnow
                    rm.new_tokens = 1
        # lanes now hold their full prompt
        lengths = self.state.lengths.clone()
        lengths[torch.tensor(slots, device=self.device)] = torch.tensor(
            plens, dtype=torch.int32, device=self.device)
        self.state = self.state._replace(lengths=lengths)
        for slot, r in zip(slots, reqs):
            if r.max_new <= 1 or (self.ecfg.eos_id is not None
                                  and r.tokens[-1] == self.ecfg.eos_id):
                self._finish(slot, time.perf_counter() - t0)

    # ---- decode ----------------------------------------------------------
    def _finish(self, slot: int, tnow: float) -> None:
        req, rm = self._slot_req[slot], self._slot_rm[slot]
        req.done = True
        rm.new_tokens = len(req.tokens)
        rm.finish_s = tnow
        self.metrics.requests.append(rm)
        self._slot_req[slot] = None
        self._slot_rm[slot] = None
        self.state = self.pm.free_slot(self.state, slot)

    def _decode_round(self, t0: float) -> None:
        """Advance every steppable lane one token."""
        st, ok = self.pm.ensure_append_capacity(self.state, self.state.active)
        self.state = st
        ok_np = ok.cpu().numpy()
        if not ok_np.any():
            if bool(self.state.active.any()):
                raise RuntimeError(
                    "page pool exhausted: no active lane can append (grow "
                    "n_pages or lower decode_slots)")
            return
        token = np.zeros((self.ecfg.decode_slots,), np.int32)
        for i, r in enumerate(self._slot_req):
            if r is not None and ok_np[i]:
                token[i] = r.tokens[-1]
        lengths = torch.where(ok, self.state.lengths, -1)
        logits = self._decode(self.params, self.pools, self._tensor(token),
                              self.state.page_rows, lengths)
        nxt = logits.argmax(dim=-1).cpu().numpy()
        self.state = self.pm.advance(self.state, ok)
        self.metrics.decode_steps += 1
        tnow = time.perf_counter() - t0
        for i in range(self.ecfg.decode_slots):
            if not ok_np[i]:
                continue
            req = self._slot_req[i]
            req.tokens.append(int(nxt[i]))
            finished = (len(req.tokens) >= req.max_new
                        or (self.ecfg.eos_id is not None
                            and int(nxt[i]) == self.ecfg.eos_id))
            if finished:
                self._finish(i, tnow)

    # ---- top level -------------------------------------------------------
    def run(self, requests: List[ServeRequest],
            verbose: bool = False) -> ServeMetrics:
        """Serve ``requests`` to completion; returns the metrics record.

        Requests are admitted in arrival order as lanes and pages free up;
        ``arrival_s`` is honored against the engine's wall clock (a request
        "arriving later" than the current elapsed time stays queued); on a
        mesh, against rank 0's, so that every rank admits alike."""
        t0 = time.perf_counter()
        queue: Deque[ServeRequest] = deque(
            sorted(requests, key=lambda r: r.arrival_s))
        while queue or bool(self.state.active.any()):
            now = time.perf_counter() - t0
            if self.shard is not None:
                now = self.shard.host_value(now)
            slots = self._admit_batch(queue, now)
            if slots:
                self._prefill_admitted(slots, t0)
            self.metrics.queue_depth.append(len(queue))
            self.metrics.page_occupancy.append(
                float(self.pm.occupancy(self.state)))
            if bool(self.state.active.any()):
                self._decode_round(t0)
            elif queue:
                if queue[0].arrival_s <= now and not slots:
                    raise RuntimeError(
                        f"request {queue[0].rid!r} cannot be admitted into "
                        f"an idle engine: prompt needs "
                        f"{-(-len(queue[0].prompt) // self.ecfg.page_size)} "
                        f"pages but the pool has {self.ecfg.n_pages} total "
                        "(grow n_pages)")
                # everything queued is in the future; idle until it lands
                time.sleep(max(0.0, min(0.001, queue[0].arrival_s - now)))
            if verbose:
                done = sum(1 for r in requests if r.done)
                print(f"[engine] done={done}/{len(requests)} "
                      f"queue={len(queue)} "
                      f"occ={float(self.pm.occupancy(self.state)):.2f}")
        self.metrics.wall_s = time.perf_counter() - t0
        return self.metrics
