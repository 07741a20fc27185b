"""Block-paged KV pool for continuous batching — the allocator half.

Attention K/V live in a shared page pool per layer, ``(n_pages, page_size,
Hkv, D)`` torch tensors on the engine's device, plus per-slot block tables
(physical page ids) kept on the host. Pages are reserved at admission,
allocated lazily as a slot's length crosses page boundaries, and returned on
retirement. Physical page 0 is reserved as the null sink for pad/inactive
writes.

Page writes are in place (``index_copy_`` into the pool tensors); the
reference's writes are functional. The prefix cache (refcounted sharing,
the content-addressed index, LRU eviction, copy-on-write) comes in a later
slice of the port.
"""

from __future__ import annotations

from collections import deque
from typing import Callable, List, Optional

import numpy as np
import torch

Cache = List[dict]


class PagedSlotPool:
    """Block-paged decode cache: one page pool per attention leaf + per-slot
    block tables.

    Allocator lifecycle: ``reserve`` claims a slot's worst-case page budget
    at admission (so decode can never strand a running request without a
    page — oversubscription is resolved by admission control); ``ensure``
    allocates lazily from that budget as the length crosses page
    boundaries; ``release`` returns every allocated page to the free list
    and drops the remaining reservation.
    """

    def __init__(self, init_cache: Callable[..., Cache], n_slots: int,
                 capacity: int, *, page_size: int,
                 n_pages: Optional[int] = None, device="cuda"):
        if page_size <= 0:
            raise NotImplementedError(
                "unpaged (capacity-dense) slot pools come in a later slice "
                "of the port; use page_size > 0")
        self.n_slots = n_slots
        self.capacity = capacity
        self.page_size = page_size
        self.max_pages = -(-capacity // page_size)
        if n_pages is None:               # full provisioning (+ null page)
            n_pages = n_slots * self.max_pages + 1
        if n_pages <= 1:
            raise ValueError("need at least one page beyond the null page")
        self.n_pages = n_pages
        self.device = torch.device(device)
        self.cache = init_cache(kv_pages=n_pages, page_size=page_size,
                                device=self.device)
        self.lens = np.zeros((n_slots,), np.int32)
        self.table = np.zeros((n_slots, self.max_pages), np.int32)
        self._free: deque[int] = deque(range(1, n_pages))   # 0 = null
        self._n_alloc = np.zeros((n_slots,), np.int32)
        self._reserved = np.zeros((n_slots,), np.int32)     # unallocated
        self._reserved_total = 0

    # -- allocator ---------------------------------------------------------

    def free_pages(self) -> int:
        """Pages allocatable right now: free minus outstanding reservations."""
        return len(self._free) - self._reserved_total

    def pages_needed(self, total_len: int) -> int:
        return -(-total_len // self.page_size)

    def _set_reserved(self, slot: int, n: int) -> None:
        self._reserved_total += n - int(self._reserved[slot])
        self._reserved[slot] = n

    def reserve(self, slot: int, total_len: int) -> bool:
        """Admission control: claim the slot's worst-case page budget
        (prompt + max_new_tokens). False → the caller must requeue."""
        need = self.pages_needed(total_len) - int(self._n_alloc[slot])
        if need > self.free_pages():
            return False
        self._set_reserved(slot, max(need, 0))
        return True

    def _alloc_page(self, slot: int) -> None:
        if self._n_alloc[slot] >= self.max_pages:
            raise RuntimeError(f"slot {slot} exceeds capacity {self.capacity}")
        if not self._free:
            raise RuntimeError("page pool exhausted past its reservations")
        pid = self._free.popleft()
        self.table[slot, self._n_alloc[slot]] = pid
        self._n_alloc[slot] += 1
        self._set_reserved(slot, max(0, int(self._reserved[slot]) - 1))

    def ensure(self, slot: int, length: int) -> None:
        """Alloc-on-advance: guarantee pages cover positions [0, length)."""
        while int(self._n_alloc[slot]) * self.page_size < length:
            self._alloc_page(slot)

    # -- cache writes ------------------------------------------------------

    def insert_rows(self, prefill_cache: Cache, slots: np.ndarray,
                    lengths: np.ndarray) -> None:
        """Seat a batched prefill cache: allocate each real slot's prompt
        pages, then scatter the (right-padded) KV rows into them, in place.
        ``slots`` may carry pad rows past ``len(lengths)``; their table rows
        are zero, so pad writes land in the null page, as do positions past
        a slot's allocated pages."""
        if max(lengths, default=0) > self.capacity:
            raise ValueError("prompt longer than the slot capacity")
        k = len(lengths)
        for s, l in zip(slots[:k], lengths):
            self.ensure(int(s), int(l))
        seq = prefill_cache[0]["k"].shape[1]
        k_pad = len(slots)
        nbp = -(-seq // self.page_size)
        bt = np.zeros((k_pad, nbp), np.int32)
        real = np.asarray(slots[:k])
        width = min(nbp, self.max_pages)
        bt[:k, :width] = self.table[real, :width]
        cols = np.arange(nbp)[None, :]
        bt[:k] = np.where(cols < self._n_alloc[real, None], bt[:k], 0)
        pos = np.arange(seq)
        dest = (bt[:, pos // self.page_size] * self.page_size
                + (pos % self.page_size)[None, :])           # (k_pad, seq)
        dest_t = torch.as_tensor(dest.reshape(-1), dtype=torch.long,
                                 device=self.device)
        for pool, new in zip(self.cache, prefill_cache):
            for key in ("k", "v"):
                p = pool[key]
                p.view(-1, p.shape[2], p.shape[3]).index_copy_(
                    0, dest_t,
                    new[key].reshape(-1, p.shape[2], p.shape[3]).to(p.dtype))
        for s, l in zip(slots[:k], lengths):
            self.lens[s] = l

    # -- decode-step views -------------------------------------------------

    def table_width(self, extra: int = 1) -> int:
        """Block-table columns the next step needs: pages covering
        ``len + extra`` for the longest live slot, bucketed to a power of
        two (the reference's compile-count bound; kept so both packages hand
        the kernel the same tables)."""
        live = self.lens[self.lens > 0]
        need = self.pages_needed(int(live.max()) + extra) if live.size else 1
        w = 1
        while w < need:
            w *= 2
        return min(w, self.max_pages)

    def device_tables(self, width: Optional[int] = None) -> torch.Tensor:
        width = self.table_width() if width is None else width
        return torch.as_tensor(np.ascontiguousarray(self.table[:, :width]),
                               dtype=torch.int32, device=self.device)

    def live_page_rows(self) -> int:
        """Cache rows the length-aware kernel reads this step (sum of live
        pages × page_size over occupied slots)."""
        live = self.lens[self.lens > 0] + 1
        pages = -(-live // self.page_size)
        return int(pages.sum()) * self.page_size

    # -- lifecycle ---------------------------------------------------------

    def advance(self, slot: int) -> None:
        self.lens[slot] += 1

    def release(self, slot: int) -> None:
        """Retire: every allocated page returns to the free list."""
        n = int(self._n_alloc[slot])
        self._free.extend(int(p) for p in self.table[slot, :n])
        self.table[slot, :] = 0
        self._n_alloc[slot] = 0
        self._set_reserved(slot, 0)
        self.lens[slot] = 0

    def idle_pages(self) -> int:
        return len(self._free)

    def check_consistency(self) -> None:
        """Audit the allocator's bookkeeping against the tables: each
        non-null page is either free or held by exactly one slot, tables are
        zero past each slot's allocation, lengths fit their pages, and the
        reservation total agrees with the per-slot reservations."""
        held = np.zeros((self.n_pages,), np.int64)
        for slot in range(self.n_slots):
            n = int(self._n_alloc[slot])
            for pid in self.table[slot, :n]:
                if int(pid) == 0:
                    raise AssertionError(f"null page in live table of slot "
                                         f"{slot}")
                held[int(pid)] += 1
            if self.table[slot, n:].any():
                raise AssertionError(f"slot {slot} table non-zero past its "
                                     f"{n} allocated pages")
            if self.pages_needed(int(self.lens[slot])) > n:
                raise AssertionError(f"slot {slot} length "
                                     f"{int(self.lens[slot])} overruns its "
                                     f"{n} allocated pages")
        free = list(self._free)
        free_set = set(free)
        if len(free) != len(free_set):
            raise AssertionError("duplicate pages on the free list")
        if 0 in free_set:
            raise AssertionError("null page entered the free list")
        for pid in range(1, self.n_pages):
            states = int(pid in free_set) + int(held[pid])
            if states != 1:
                raise AssertionError(f"page {pid} is free {pid in free_set} "
                                     f"and held {int(held[pid])} times")
        if self._reserved_total != int(self._reserved.sum()):
            raise AssertionError("reservation total out of sync with "
                                 "per-slot reservations")
        if self._reserved_total > len(free):
            raise AssertionError("reservations exceed the free pages")
