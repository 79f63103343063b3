"""Paged KV-cache bookkeeping over dense int32 tensors on the engine's device.

The same design as the JAX package's ``serving/page_table.py``: one shared
pool of fixed-size pages per layer holds every lane's K/V, and a single page
table (shared by all layers) maps (slot, logical page) -> pool row.  State
lives in :class:`PageState`; methods of :class:`PageManager` return a new
state and leave their input untouched.  Allocation is rank-matching with
``cumsum`` over boolean masks (the r-th needy lane gets the r-th free row),
and a failed admission changes nothing.  Where the JAX package routes a
write out of bounds for ``mode="drop"`` to discard it, this port selects
the kept writes with a mask.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple, Union

import torch

from repro_torch.device import resolve_device

IntLike = Union[int, torch.Tensor]


class PageState(NamedTuple):
    """Dense-tensor page table.

    ``page_owner`` (n_pages,) int32 — slot owning each pool row, -1 = free.
    ``page_rows`` (n_slots, pages_per_slot) int32 — pool row backing each
    lane's logical page, -1 = unassigned.
    ``lengths`` (n_slots,) int32 — tokens currently cached per lane (= the
    write position of the next token).
    ``active`` (n_slots,) bool — lane holds a live request.
    """

    page_owner: torch.Tensor
    page_rows: torch.Tensor
    lengths: torch.Tensor
    active: torch.Tensor


@dataclasses.dataclass(frozen=True)
class PageManager:
    """Static geometry + page-table operations.

    ``n_pages`` pool rows of ``page_size`` tokens are shared by ``n_slots``
    decode lanes, each addressing at most ``pages_per_slot`` logical pages
    (so per-lane max context = pages_per_slot * page_size).
    """

    n_pages: int
    n_slots: int
    page_size: int
    pages_per_slot: int
    device: torch.device = torch.device("cuda")

    def __post_init__(self):
        if min(self.n_pages, self.n_slots, self.page_size,
               self.pages_per_slot) < 1:
            raise ValueError("all PageManager dimensions must be >= 1")
        object.__setattr__(self, "device", resolve_device(self.device))

    @property
    def max_context(self) -> int:
        return self.pages_per_slot * self.page_size

    def _i32(self, x: IntLike) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.int32, device=self.device)

    def init(self) -> PageState:
        kw = dict(dtype=torch.int32, device=self.device)
        return PageState(
            page_owner=torch.full((self.n_pages,), -1, **kw),
            page_rows=torch.full((self.n_slots, self.pages_per_slot), -1,
                                 **kw),
            lengths=torch.zeros((self.n_slots,), **kw),
            active=torch.zeros((self.n_slots,), dtype=torch.bool,
                               device=self.device),
        )

    # ---- queries ---------------------------------------------------------
    def pages_needed(self, n_tokens: IntLike) -> torch.Tensor:
        """Pages required to hold ``n_tokens`` (ceil division)."""
        return (self._i32(n_tokens) + self.page_size - 1) // self.page_size

    def free_pages(self, st: PageState) -> torch.Tensor:
        return (st.page_owner < 0).sum().to(torch.int32)

    def used_pages(self, st: PageState) -> torch.Tensor:
        return (st.page_owner >= 0).sum().to(torch.int32)

    def occupancy(self, st: PageState) -> torch.Tensor:
        return self.used_pages(st) / self.n_pages

    # ---- allocation ------------------------------------------------------
    def reserve(self, st: PageState, slot: IntLike, n_need: IntLike
                ) -> Tuple[PageState, torch.Tensor]:
        """Assign the first ``n_need`` free pool rows to ``slot``'s next
        unassigned logical pages.  Returns ``(new_state, ok)``; on failure
        (not enough free rows, or the slot would exceed pages_per_slot)
        the state is returned unchanged and ``ok`` is False."""
        slot, n_need = self._i32(slot), self._i32(n_need)
        free = st.page_owner < 0                             # (n_pages,)
        rank = torch.cumsum(free, 0).to(torch.int32) - 1     # rank among free
        chosen = free & (rank < n_need)
        cur = (st.page_rows[slot.long()] >= 0).sum().to(torch.int32)
        ok = ((free.sum() >= n_need)
              & (cur + n_need <= self.pages_per_slot))
        take = chosen & ok
        new_rows = st.page_rows.clone()
        rows_ids = torch.arange(self.n_pages, dtype=torch.int32,
                                device=self.device)
        new_rows[slot.long(), (cur + rank)[take].long()] = rows_ids[take]
        new_owner = torch.where(take, slot, st.page_owner)
        return PageState(new_owner, new_rows, st.lengths, st.active), ok

    def admit(self, st: PageState, slot: IntLike, prompt_len: IntLike
              ) -> Tuple[PageState, torch.Tensor]:
        """Claim ``slot`` for a new request and reserve pages covering its
        ``prompt_len`` prompt tokens.  The lane starts at length 0 (prefill
        fills it); decode-time pages come from :meth:`ensure_append_capacity`.
        """
        slot = self._i32(slot)
        si = slot.long()
        st2, ok = self.reserve(st, slot, self.pages_needed(prompt_len))
        new_active = st2.active.clone()
        new_active[si] = ok
        new_lengths = st2.lengths.clone()
        new_lengths[si] = 0
        st3 = PageState(st2.page_owner, st2.page_rows, new_lengths,
                        new_active)
        return PageState(*(torch.where(ok, a, b) for a, b in zip(st3, st))), ok

    def free_slot(self, st: PageState, slot: IntLike) -> PageState:
        """Release every page owned by ``slot`` and deactivate the lane."""
        slot = self._i32(slot)
        new_rows, new_lengths = st.page_rows.clone(), st.lengths.clone()
        new_active = st.active.clone()
        new_rows[slot.long()] = -1
        new_lengths[slot.long()] = 0
        new_active[slot.long()] = False
        return PageState(torch.where(st.page_owner == slot, -1,
                                     st.page_owner),
                         new_rows, new_lengths, new_active)

    def ensure_append_capacity(self, st: PageState, want: torch.Tensor
                               ) -> Tuple[PageState, torch.Tensor]:
        """Guarantee each lane in ``want`` (n_slots, bool) has a page
        assigned for its next write position ``lengths[i]``.

        Lanes missing a page are ranked by ``cumsum``, free pool rows are
        ranked the same way, and rank r matches rank r.  Returns
        ``(new_state, ok)`` with ``ok`` (n_slots,) False for lanes that
        could not get a page this round (pool exhausted or lane at
        pages_per_slot) — the engine skips those lanes for one step and
        retries after other requests release pages."""
        want = want & st.active
        li = st.lengths // self.page_size                    # logical page
        li_c = li.clamp(0, self.pages_per_slot - 1).long()
        have = st.page_rows.gather(1, li_c[:, None])[:, 0] >= 0
        fits = li < self.pages_per_slot
        need = want & fits & ~have
        lane_rank = torch.cumsum(need, 0) - 1                # (n_slots,)
        free = st.page_owner < 0
        free_rank = torch.cumsum(free, 0) - 1
        # page_of_rank[r] = r-th free pool row (n_pages if there is none)
        page_of_rank = torch.full((self.n_slots,), self.n_pages,
                                  dtype=torch.int32, device=self.device)
        keep = free & (free_rank < self.n_slots)
        page_of_rank[free_rank[keep]] = torch.arange(
            self.n_pages, dtype=torch.int32, device=self.device)[keep]
        got = page_of_rank[lane_rank.clamp(0, self.n_slots - 1)]
        granted = need & (got < self.n_pages)
        slot_ids = torch.arange(self.n_slots, dtype=torch.int32,
                                device=self.device)
        new_rows = st.page_rows.clone()
        new_rows[slot_ids[granted].long(), li_c[granted]] = got[granted]
        new_owner = st.page_owner.clone()
        new_owner[got[granted].long()] = slot_ids[granted]
        ok = want & fits & (have | granted)
        return PageState(new_owner, new_rows, st.lengths, st.active), ok

    def advance(self, st: PageState, stepped: torch.Tensor) -> PageState:
        """Bump ``lengths`` for lanes that wrote a token this step."""
        return st._replace(lengths=st.lengths + stepped.to(torch.int32))
