"""Slot pools of the decode cache for continuous batching: the
capacity-dense :class:`SlotPool`, and the block-paged :class:`PagedSlotPool`
with a cross-request prefix cache.

One padded decode batch of ``n_slots`` rows serves requests of different
ages. In the capacity-dense pool slot ``b`` owns row ``b`` of every cache
leaf, ``(n_slots, capacity, Hkv, D)`` (plus ``(n_slots, capacity, Hkv)``
scales under int8 KV), and a length; admission writes a prefill cache into
the slot's rows, retirement only zeroes the length (stale K/V past a
slot's length is never attended to). The port's layout puts the batch axis
first in every leaf, so the pools take that as fixed.

Two kinds of leaf share that layout: position leaves (attention K/V and
their scales: axis 1 counts positions) and slot leaves (a recurrent
layer's state: mamba ``h``/``conv``, RWKV ``s``/``shift``/``cm_shift``,
whose axis 1 is a width, not positions). The pools tell them apart by
``causal_lm.position_keys``, the one rule the model, ``generate`` and the
engine read too (the reference probes ``init_cache`` for it): position
leaves are clipped to the capacity or paged; every other leaf is seated
whole, one row a slot. Clipping a slot leaf's axis 1 to the capacity would
keep only part of its state (RWKV's ``shift`` is ``(B, d_model)``).

In the paged pool, attention K/V live in a shared page pool per layer,
``(n_pages, page_size, Hkv, D)`` torch tensors on the engine's device, plus
per-slot block tables (physical page ids) kept on the host; slot leaves
stay slot-major, ``(n_slots, ...)``, and move only at admission. Under int8
KV each layer also holds fp32 ``k_scale``/``v_scale`` pools ``(n_pages,
page_size, Hkv)`` in the same page index space; every write and every copy
moves codes and scales together. Pages are reserved at admission,
allocated lazily as a slot's length crosses page boundaries, and returned
on retirement. Physical page 0 is reserved as the null sink for
pad/inactive writes.

The pool is also a prefix cache, as in the reference: pages are
refcounted, and full prompt pages can be published into a
content-addressed index (a sha1 hash chain keyed by ``(parent_chain_hash,
page_token_ids)``). Admission matches a prompt against the chain, adopts
the shared pages (refcount bump) and only the uncached suffix needs
prefill. Registered pages whose refcount drops to zero park on an LRU list
instead of the free list and are evicted lazily when an allocation cannot
be served from truly free pages. Registered pages are immutable: a slot
whose write frontier sits in one copies it into a private page first
(copy-on-write).

Page writes and copies are in place (``index_copy_`` into the pool
tensors); the reference's are functional.
"""

from __future__ import annotations

import hashlib
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.models.causal_lm import position_keys


Cache = List[dict]

_CHAIN_ROOT = b"\x00" * 20


def _chain_hash(parent: bytes, chunk) -> bytes:
    """Content address of a token prefix: digest over (parent digest, this
    page's token ids), as the reference computes it."""
    return hashlib.sha1(
        parent + np.asarray(chunk, "<i4").tobytes()).digest()


def _leaf_keys(cache: Cache) -> Tuple[List[frozenset], List[frozenset]]:
    """Per layer, the keys of the position leaves and of the slot leaves
    (everything else: recurrent state)."""
    pos = position_keys(cache)
    return pos, [frozenset(layer) - keys for layer, keys in zip(cache, pos)]


def _seat_rows(cache: Cache, new: Cache, slots: np.ndarray,
               seq_keys: List[frozenset],
               keys: Optional[List[frozenset]] = None) -> None:
    """Row ``i`` of ``new`` → pool row ``slots[i]``, in place, one scatter a
    leaf (of every leaf, or per layer of the ``keys`` leaves): position
    leaves (``seq_keys``) at positions ``[0, seq)`` clipped to the pool's
    (a prefill bucket may be longer: those positions are pads), every
    other leaf whole. Where a slot appears more than once (pad rows alias
    the first real row's slot) only its lowest row is written, which
    leaves what the reference's reverse-order writes leave."""
    uniq, first = np.unique(np.asarray(slots, np.int64), return_index=True)
    device = next(iter(cache[0].values())).device
    dst = torch.as_tensor(uniq, device=device)
    src = torch.as_tensor(first, device=device)
    for i, (pool_layer, new_layer, seq) in enumerate(zip(cache, new,
                                                         seq_keys)):
        for key in (pool_layer if keys is None else keys[i]):
            leaf = pool_layer[key]
            rows = new_layer[key].index_select(0, src)
            if key in seq:
                rows = rows[:, :leaf.shape[1]]
                leaf = leaf[:, :rows.shape[1]]
            leaf.index_copy_(0, dst, rows.to(leaf.dtype))


def seat_prefill(init_cache: Callable[..., Cache], prefill_cache: Cache,
                 batch: int, capacity: int, device="cuda") -> Cache:
    """Expand a whole-batch prefill cache (seq axis = prompt length) into a
    capacity-dense decode cache: the reference's uniform-batch ``generate``
    path. The port's engine does not call it; it is kept for parity with
    the reference's ``kv_slots`` API, which the tests hold it to."""
    pool = init_cache(batch, capacity, device=device)
    rows = next(iter(prefill_cache[0].values())).shape[0]
    _seat_rows(pool, prefill_cache, np.arange(rows), position_keys(pool))
    return pool


def copy_pages_into(cache: Cache, position_keys: List[frozenset],
                    src: np.ndarray, dst: np.ndarray) -> None:
    """Page ``src[i]`` → ``dst[i]`` in every page leaf of every attention
    layer of a paged ``cache`` (codes and, under int8 KV, their scales),
    one gather and one in-place scatter a leaf, on the current stream."""
    device = next(iter(cache[0].values())).device
    s = torch.as_tensor(src, dtype=torch.long, device=device)
    d = torch.as_tensor(dst, dtype=torch.long, device=device)
    for layer, keys in zip(cache, position_keys):
        for key in keys:
            layer[key].index_copy_(0, d, layer[key].index_select(0, s))


def seat_pages(cache: Cache, prefill_cache: Cache,
               position_keys: List[frozenset], slot_keys: List[frozenset],
               dest: np.ndarray, slots: np.ndarray) -> None:
    """Scatter a batched prefill cache's position rows (right-padded, row
    ``b`` position ``p`` at ``dest[b·S + p]``) into a paged ``cache``, in
    place, codes and scales together; recurrent state (``slot_keys``)
    goes whole into row ``slots[i]`` (pad rows alias ``slots[0]`` and are
    not written)."""
    device = next(iter(cache[0].values())).device
    dest_t = torch.as_tensor(dest, dtype=torch.long, device=device)
    for pool, new, keys in zip(cache, prefill_cache, position_keys):
        for key in keys:
            p = pool[key]
            row = p.shape[2:]
            p.view(-1, *row).index_copy_(
                0, dest_t, new[key].reshape(-1, *row).to(p.dtype))
    if any(slot_keys):
        _seat_rows(cache, prefill_cache, slots, [frozenset()] * len(cache),
                   slot_keys)


class SlotPool:
    """Capacity-dense decode cache + host-side per-slot lengths: the pool
    owns the cache (``init_cache(n_slots, capacity)``), ``lens`` is the
    ``(n_slots,)`` vector handed to ``decode_step`` each step."""

    def __init__(self, init_cache: Callable[..., Cache], n_slots: int,
                 capacity: int, *, device="cuda"):
        self.n_slots = n_slots
        self.capacity = capacity
        self.device = torch.device(device)
        self.cache = init_cache(n_slots, capacity, device=self.device)
        # per layer: the leaves with a capacity axis (attention K/V) and
        # the recurrent state
        self.position_keys, self.slot_keys = _leaf_keys(self.cache)
        self.lens = np.zeros((n_slots,), np.int32)

    def insert(self, prefill_cache: Cache, slot: int, length: int) -> None:
        """Seat a batch-1 prefill cache into one slot. The port's engine
        and drafter seat through :meth:`insert_rows`; this is kept for
        parity with the reference's ``SlotPool``, which the tests hold it
        to."""
        if length > self.capacity:
            raise ValueError(f"length {length} exceeds the slot capacity "
                             f"{self.capacity}")
        rows = next(iter(prefill_cache[0].values())).shape[0]
        _seat_rows(self.cache, prefill_cache, np.arange(slot, slot + rows),
                   self.position_keys)
        self.lens[slot] = length

    def insert_rows(self, prefill_cache: Cache, slots: np.ndarray,
                    lengths: np.ndarray) -> None:
        """Grouped admission: row ``i`` of ``prefill_cache`` → slot
        ``slots[i]`` (position leaves at positions ``[0, seq)``, recurrent
        state whole). ``lengths`` covers the real rows only; pad rows past
        it alias ``slots[0]``. The reference writes the rows in reverse
        order, so the real row 0 lands last over its pads; here, where a
        slot appears more than once, only its lowest row is written, which
        leaves the same cache in one scatter per leaf. Positions past the
        capacity (a prefill bucket may be longer) are pads and dropped."""
        if max(lengths, default=0) > self.capacity:
            raise ValueError("prompt longer than the slot capacity")
        _seat_rows(self.cache, prefill_cache, slots, self.position_keys)
        for s, l in zip(np.asarray(slots)[:len(lengths)], lengths):
            self.lens[s] = l

    def advance(self, slot: int) -> None:
        self.lens[slot] += 1

    def truncate(self, slot: int, length: int) -> None:
        """Rewind a slot to ``length`` valid positions (speculative
        rollback). Stale K/V past the new frontier is never attended to,
        so only the length moves."""
        if not 0 <= length <= self.capacity:
            raise ValueError(f"length {length} outside [0, {self.capacity}]")
        self.lens[slot] = length

    def release(self, slot: int) -> None:
        self.lens[slot] = 0


class PagedSlotPool:
    """Block-paged decode cache: one page pool per attention leaf + per-slot
    block tables, with recurrent-state leaves kept slot-major (a hybrid
    model's mamba layers beside its paged attention layer).

    Allocator lifecycle: ``reserve`` (or ``admit_prefix``) claims a slot's
    worst-case page budget at admission (so decode can never strand a
    running request without a page — oversubscription is resolved by
    admission control or preemption); ``ensure`` allocates lazily from that
    budget as the length crosses page boundaries; ``release`` drops one
    reference to every page the slot holds and the remaining reservation.
    """

    def __init__(self, init_cache: Callable[..., Cache], n_slots: int,
                 capacity: int, *, page_size: int,
                 n_pages: Optional[int] = None, device="cuda"):
        if page_size <= 0:
            raise ValueError("a paged pool needs page_size > 0 (SlotPool "
                             "is the capacity-dense one)")
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
        self.cache = init_cache(batch=n_slots, capacity=capacity,
                                kv_pages=n_pages, page_size=page_size,
                                device=self.device)

        # per layer: page leaves (attention K/V, paged) and slot leaves
        # (recurrent state, slot-major)
        self.position_keys, self.slot_keys = _leaf_keys(self.cache)
        if not any(self.position_keys):
            raise ValueError("no attention K/V leaf to page: use SlotPool "
                             "for this family")
        self.lens = np.zeros((n_slots,), np.int32)
        self.table = np.zeros((n_slots, self.max_pages), np.int32)
        self._free: deque[int] = deque(range(1, n_pages))   # 0 = null
        self._n_alloc = np.zeros((n_slots,), np.int32)
        self._reserved = np.zeros((n_slots,), np.int32)     # unallocated
        # scalar mirror of _reserved.sum(): free_pages() runs per admission
        self._reserved_total = 0
        # -- prefix cache state ---------------------------------------------
        self._refcount = np.zeros((n_pages,), np.int32)
        # chain hash -> first token -> {page_token_ids: page_id}: children
        # bucketed by first token, so the partial-tail scan touches only
        # the siblings that share the tail's first token
        self._children: Dict[bytes, Dict[int, Dict[Tuple[int, ...], int]]] \
            = {}
        self._page_key: Dict[int, Tuple[bytes, Tuple[int, ...]]] = {}
        # registered refcount-0 pages; insertion order is the LRU order
        self._lru: Dict[int, None] = {}
        self.stats: Dict[str, int] = {}
        self.reset_stats()

    def reset_stats(self) -> None:
        self.stats.update(pages_allocated=0, evictions=0, cow_copies=0)

    # -- allocator ---------------------------------------------------------

    def free_pages(self) -> int:
        """Pages allocatable right now: truly free plus lazily evictable
        (registered, refcount-0 LRU) pages, minus outstanding reservations.
        O(1) counters, no per-slot rescans."""
        return len(self._free) + len(self._lru) - self._reserved_total

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

    def _take_free_page(self) -> int:
        """Pop a writable page: the free list first, else lazily evict the
        least recently retired registered page (its index entry goes;
        descendants become unreachable and age out of the LRU the same
        way)."""
        if self._free:
            pid = self._free.popleft()
        elif self._lru:
            pid = next(iter(self._lru))
            del self._lru[pid]
            self._unregister(pid)
            self.stats["evictions"] += 1
        else:
            raise RuntimeError("page pool exhausted past its reservations")
        self._refcount[pid] = 1
        self.stats["pages_allocated"] += 1
        return pid

    def _alloc_page(self, slot: int) -> None:
        if self._n_alloc[slot] >= self.max_pages:
            raise RuntimeError(f"slot {slot} exceeds capacity {self.capacity}")
        pid = self._take_free_page()
        self.table[slot, self._n_alloc[slot]] = pid
        self._n_alloc[slot] += 1
        self._set_reserved(slot, max(0, int(self._reserved[slot]) - 1))

    def ensure(self, slot: int, length: int) -> None:
        """Alloc-on-advance: guarantee pages cover positions [0, length)."""
        while int(self._n_alloc[slot]) * self.page_size < length:
            self._alloc_page(slot)

    # -- prefix cache ------------------------------------------------------

    def _unregister(self, pid: int) -> None:
        h, chunk = self._page_key.pop(pid)
        bucket = self._children[h][chunk[0]]
        del bucket[chunk]
        if not bucket:
            del self._children[h][chunk[0]]
            if not self._children[h]:
                del self._children[h]

    def _drop_page_ref(self, pid: int) -> None:
        """Decrement a page's refcount; at zero, registered pages park on
        the LRU list (content kept: a hot prefix survives retirement),
        private pages return to the free list."""
        self._refcount[pid] -= 1
        if self._refcount[pid] < 0:
            raise AssertionError(f"refcount underflow on page {pid}")
        if self._refcount[pid] == 0:
            if pid in self._page_key:
                self._lru[pid] = None
            else:
                self._free.append(pid)

    def match_prefix(self, tokens: np.ndarray) -> Tuple[int, List[int]]:
        """Longest cached prefix of ``tokens``: exact-match full pages down
        the hash chain, then (if every full page matched) one partial tail
        page — a cached FULL page whose token ids start with the remaining
        sub-page tail. Read-only; returns (hit_tokens, page_ids)."""
        toks = np.asarray(tokens, np.int32)
        ps = self.page_size
        h, hit, pages = _CHAIN_ROOT, 0, []
        for i in range(len(toks) // ps):
            chunk = tuple(int(t) for t in toks[i * ps:(i + 1) * ps])
            pid = self._children.get(h, {}).get(chunk[0], {}).get(chunk)
            if pid is None:
                return hit, pages
            pages.append(pid)
            hit += ps
            h = _chain_hash(h, chunk)
        tail = tuple(int(t) for t in toks[hit:])
        if tail:
            for ctoks, pid in self._children.get(h, {}).get(
                    tail[0], {}).items():
                if ctoks[:len(tail)] == tail:
                    pages.append(pid)
                    hit += len(tail)
                    break
        return hit, pages

    def admit_prefix(self, slot: int, tokens: np.ndarray,
                     total_len: int) -> Optional[int]:
        """Prefix-sharing admission: match ``tokens`` (the prompt; its final
        token is always left for the suffix, so the prefill produces the
        first sample's logits), adopt the shared pages into this slot's
        table and reserve the fresh-page budget. Returns the hit length (0:
        cold) or None when the pool cannot cover the request, in which case
        nothing was adopted or reserved."""
        if self._n_alloc[slot] or self._reserved[slot]:
            raise AssertionError(f"slot {slot} admitted while still holding "
                                 f"pages")
        toks = np.asarray(tokens, np.int32)
        hit, pages = self.match_prefix(toks[:-1])
        n_keep = hit // self.page_size          # full pages kept as they are
        # every page past the kept full ones is a fresh allocation: the
        # boundary-crossing allocations plus the CoW copy of a partial tail
        need = self.pages_needed(total_len) - n_keep
        # adopted LRU pages leave the evictable set, so they cannot also
        # back the reservation
        n_from_lru = sum(1 for p in pages if p in self._lru)
        if need + n_from_lru > self.free_pages():
            return None
        for j, pid in enumerate(pages):
            self._refcount[pid] += 1
            self._lru.pop(pid, None)
            self.table[slot, j] = pid
        self._n_alloc[slot] = len(pages)
        self._set_reserved(slot, need)
        return hit

    def ensure_writable(self, slot: int, pos: int
                        ) -> Optional[Tuple[int, int]]:
        """Copy-on-write: the page covering ``pos`` must be privately owned
        before this slot's K/V write at ``pos`` lands. A shared or
        registered page gets a private copy (drawn from the slot's
        reservation) swapped into the table. Returns (src, dst) page ids
        for :meth:`copy_pages`, or None when the page is already private."""
        col = pos // self.page_size
        if col >= self._n_alloc[slot]:
            raise AssertionError(f"slot {slot} position {pos} has no page "
                                 f"(call ensure first)")
        pid = int(self.table[slot, col])
        if self._refcount[pid] == 1 and pid not in self._page_key:
            return None
        dst = self._take_free_page()
        self.table[slot, col] = dst
        self._drop_page_ref(pid)
        self._set_reserved(slot, max(0, int(self._reserved[slot]) - 1))
        self.stats["cow_copies"] += 1
        return pid, dst

    def register_prefix(self, slot: int, tokens: np.ndarray) -> None:
        """Publish this slot's FULL prompt pages into the prefix index.
        First writer wins: chunks already present (including pages this
        slot adopted) are skipped, as are pages registered under another
        key. The partial final page is never registered: it is the slot's
        private write frontier."""
        toks = np.asarray(tokens, np.int32)
        ps = self.page_size
        h = _CHAIN_ROOT
        for i in range(len(toks) // ps):
            chunk = tuple(int(t) for t in toks[i * ps:(i + 1) * ps])
            kids = self._children.setdefault(h, {}).setdefault(chunk[0], {})
            pid = int(self.table[slot, i])
            if chunk not in kids and pid not in self._page_key and pid != 0:
                kids[chunk] = pid
                self._page_key[pid] = (h, chunk)
            h = _chain_hash(h, chunk)

    def reset_prefix(self) -> None:
        """Drop the whole prefix index: refcount-0 registered pages return
        to the free list; pages still adopted by live slots lose their
        index entry and free on release."""
        for pid in list(self._page_key):
            self._unregister(pid)
        self._free.extend(self._lru)
        self._lru.clear()
        self.reset_stats()

    def copy_pages(self, src: np.ndarray, dst: np.ndarray) -> None:
        """Copy-on-write on the device: page ``src[i]`` → ``dst[i]`` in every
        page leaf of every attention layer (codes and, under int8 KV, their
        scales), one gather and one in-place scatter per leaf, on the current
        stream, so a later dispatch on it reads the copies."""
        self._device_copy(np.asarray(src), np.asarray(dst))

    def _device_copy(self, src: np.ndarray, dst: np.ndarray) -> None:
        """The device half of :meth:`copy_pages` (a tensor-parallel pool
        runs it on every rank's shard)."""
        copy_pages_into(self.cache, self.position_keys, src, dst)

    # -- cache writes ------------------------------------------------------

    def insert_rows(self, prefill_cache: Cache, slots: np.ndarray,
                    lengths: np.ndarray) -> None:
        """Seat a batched prefill cache: allocate each real slot's prompt
        pages, then scatter the (right-padded) KV rows into them, in place;
        recurrent state (slot leaves) goes whole into each slot's row.
        ``slots`` may carry pad rows past ``len(lengths)``; their table rows
        are zero, so pad writes land in the null page, as do positions past
        a slot's allocated pages; their slot leaves alias ``slots[0]`` and
        are not written."""
        if max(lengths, default=0) > self.capacity:
            raise ValueError("prompt longer than the slot capacity")
        k = len(lengths)
        for s, l in zip(slots[:k], lengths):
            self.ensure(int(s), int(l))
        for i, (pool, new) in enumerate(zip(self.cache, prefill_cache)):
            if set(new) != set(pool):
                raise ValueError(f"layer {i}: prefill cache leaves "
                                 f"{sorted(new)} do not match the pool's "
                                 f"{sorted(pool)}")
        seq = next(new[key].shape[1] for new, keys in
                   zip(prefill_cache, self.position_keys) for key in keys)
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
        self._device_seat(prefill_cache, dest.reshape(-1), np.asarray(slots))
        for s, l in zip(slots[:k], lengths):
            self.lens[s] = l

    def _device_seat(self, prefill_cache: Cache, dest: np.ndarray,
                     slots: np.ndarray) -> None:
        """The device half of :meth:`insert_rows` (a tensor-parallel pool
        runs it on every rank's shard, each with its own prefill cache)."""
        seat_pages(self.cache, prefill_cache, self.position_keys,
                   self.slot_keys, dest, slots)

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

    def truncate(self, slot: int, length: int) -> None:
        """Rewind a slot to ``length`` valid positions and return pages
        wholly past the new frontier to the slot's reservation. Those pages
        were allocated past the prompt, so they are private (never
        registered or adopted) and go straight back to the free list."""
        if not 0 <= length <= self.capacity:
            raise ValueError(f"length {length} outside [0, {self.capacity}]")
        keep = self.pages_needed(length)
        n = int(self._n_alloc[slot])
        if keep > n:
            raise ValueError(f"slot {slot} holds {n} pages, fewer than the "
                             f"{keep} that length {length} needs")
        for col in range(keep, n):
            pid = int(self.table[slot, col])
            if pid in self._page_key or self._refcount[pid] != 1:
                raise AssertionError(f"truncate hit a shared/registered page "
                                     f"{pid} past the write frontier of "
                                     f"slot {slot}")
            self._drop_page_ref(pid)
            self.table[slot, col] = 0
        self._n_alloc[slot] = keep
        self._set_reserved(slot, int(self._reserved[slot]) + (n - keep))
        self.lens[slot] = length

    def release(self, slot: int) -> None:
        """Retire: drop one reference to every page the slot holds (shared
        prefix pages stay live for their other owners, registered
        refcount-0 pages park on the LRU) and the remaining reservation."""
        n = int(self._n_alloc[slot])
        for p in self.table[slot, :n]:
            self._drop_page_ref(int(p))
        self.table[slot, :] = 0
        self._n_alloc[slot] = 0
        self._set_reserved(slot, 0)
        self.lens[slot] = 0

    def idle_pages(self) -> int:
        """Non-null pages held by no slot: free list + LRU-parked prefix
        pages; ``n_pages - 1`` on a drained pool."""
        return len(self._free) + len(self._lru)

    def _check_scale_pools(self) -> None:
        """int8 pools: each layer's ``k_scale``/``v_scale`` share the page
        index space of its codes, and every live row of every slot carries
        the positive scale its write stored (an fp pool has no scales)."""
        live = [(slot, int(self.lens[slot])) for slot in range(self.n_slots)
                if self.lens[slot] > 0]
        rows = [int(self.table[slot, pos // self.page_size]) * self.page_size
                + pos % self.page_size for slot, n in live for pos in range(n)]
        idx = torch.as_tensor(rows, dtype=torch.long, device=self.device)
        for li, (layer, keys) in enumerate(zip(self.cache,
                                               self.position_keys)):
            if not keys:                  # a recurrent layer: no pages
                continue
            quant = layer["k"].dtype == torch.int8
            if quant != ("k_scale" in layer) or quant != ("v_scale" in layer):
                raise AssertionError(f"layer {li}: int8 pools and scale "
                                     f"pools must come together")
            if not quant:
                continue
            for key in ("k", "v"):
                sc = layer[f"{key}_scale"]
                if tuple(sc.shape) != tuple(layer[key].shape[:3]) \
                        or sc.dtype != torch.float32:
                    raise AssertionError(f"layer {li}: {key}_scale is "
                                         f"{sc.dtype} {tuple(sc.shape)}")
                if rows and not bool((sc.view(-1, sc.shape[2])[idx] > 0)
                                     .all()):
                    raise AssertionError(f"layer {li}: a live {key} row has "
                                         f"no scale")

    def check_consistency(self) -> None:
        """Audit the allocator's bookkeeping against the tables: rebuild
        every page's refcount from the slot tables and check that each
        non-null page is in exactly one of {free list, LRU, live}, stored
        refcounts match, LRU pages are indexed and free ones are not, tables
        are zero past each slot's allocation, lengths fit their pages, the
        reservations agree and fit, and int8 scale pools match their codes
        (``_check_scale_pools``). Host-side ints (plus one scale read under
        int8), so callable mid-run."""
        ref = np.zeros((self.n_pages,), np.int64)
        for slot in range(self.n_slots):
            n = int(self._n_alloc[slot])
            for pid in self.table[slot, :n]:
                if int(pid) == 0:
                    raise AssertionError(f"null page in live table of slot "
                                         f"{slot}")
                ref[int(pid)] += 1
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
        if 0 in free_set or 0 in self._lru:
            raise AssertionError("null page entered the free/LRU lists")
        for pid in range(1, self.n_pages):
            states = (int(pid in free_set) + int(pid in self._lru)
                      + int(ref[pid] > 0))
            if states != 1:
                raise AssertionError(f"page {pid} in {states} of free/LRU/"
                                     f"live (refs={int(ref[pid])})")
            if int(self._refcount[pid]) != int(ref[pid]):
                raise AssertionError(f"page {pid} refcount "
                                     f"{int(self._refcount[pid])} != "
                                     f"{int(ref[pid])} table references")
            if pid in self._lru and pid not in self._page_key:
                raise AssertionError(f"LRU page {pid} missing from the "
                                     f"prefix index")
            if pid in free_set and pid in self._page_key:
                raise AssertionError(f"free page {pid} still registered in "
                                     f"the prefix index")
        if self._reserved_total != int(self._reserved.sum()):
            raise AssertionError("reservation total out of sync with "
                                 "per-slot reservations")
        if self._reserved_total > len(free) + len(self._lru):
            raise AssertionError("reservations exceed the free and "
                                 "evictable pages")
        self._check_scale_pools()
