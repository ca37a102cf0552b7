"""Free-list allocator for KV-cache pages, with per-page reference counts
(host state only).

Counterpart of ``deepspeed_tpu/inference/v2/ragged/blocked_allocator.py``.

Page index 0 is the **null page**: padding tokens of a ragged batch
scatter their garbage KV into it, which keeps every shape static without
conditional writes.  Valid pages are 1..num_pages inclusive.

Prefix caching shares full prompt pages between sequences, so a page is
on the free list, *live* (referenced by at least one block table:
``add_ref`` / ``decref`` count the sharers) or *parked* (allocated with
refcount 0: kept by the prefix cache for reuse or LRU eviction).
Freeing a page that is already free raises.
"""

from __future__ import annotations

from typing import Iterable, List, Union

import numpy as np

NULL_PAGE = 0

PageIds = Union[Iterable[int], np.ndarray]


class KVAllocationError(ValueError):
    """The KV-page pool cannot satisfy an allocation."""


class BlockedAllocator:
    """Free list of KV pages, indices in [1, num_pages]."""

    def __init__(self, num_pages: int) -> None:
        if num_pages < 1:
            raise ValueError(
                f"blocked KV cache needs >= 1 page, got {num_pages}")
        self._num_pages = num_pages
        # _next[i] = successor of page i in the free list (1-based pages)
        self._next = np.arange(2, num_pages + 2, dtype=np.int64)
        self._head = 1
        self._free = num_pages
        # page -> block tables referencing it (0 while free or parked);
        # _allocated[p] is False exactly while p is on the free list
        self._refs = np.zeros(num_pages + 1, dtype=np.int64)
        self._allocated = np.zeros(num_pages + 1, dtype=bool)
        # parked pages, kept incrementally: the counts below sit on the
        # per-step admission path; ``audit`` re-derives them
        self._parked = 0

    @property
    def free_pages(self) -> int:
        return self._free

    @property
    def total_pages(self) -> int:
        return self._num_pages

    @property
    def live_pages(self) -> int:
        """Pages referenced by at least one block table."""
        return self._num_pages - self._free - self._parked

    @property
    def parked_pages(self) -> int:
        """Allocated pages with refcount 0, kept by the prefix cache and
        reclaimable on demand."""
        return self._parked

    def parked_page_ids(self) -> np.ndarray:
        return np.nonzero(self._allocated & (self._refs == 0))[0]

    def audit(self) -> None:
        """Re-derive the counters from the arrays and raise on drift."""
        parked = int((self._allocated & (self._refs == 0)).sum())
        if parked != self._parked:
            raise RuntimeError(
                f"allocator audit: parked counter {self._parked} != "
                f"array state {parked}")
        allocated = int(self._allocated.sum())
        if self._free + allocated != self._num_pages:
            raise RuntimeError(
                f"allocator audit: free({self._free}) + "
                f"allocated({allocated}) != total({self._num_pages})")

    def _check_page(self, p: int) -> int:
        p = int(p)
        if not (1 <= p <= self._num_pages):
            raise ValueError(f"invalid page index {p}")
        return p

    def ref_count(self, page: int) -> int:
        return int(self._refs[self._check_page(page)])

    def is_allocated(self, page: int) -> bool:
        return bool(self._allocated[self._check_page(page)])

    def is_parked(self, page: int) -> bool:
        p = self._check_page(page)
        return bool(self._allocated[p]) and self._refs[p] == 0

    def allocate(self, num_pages: int) -> np.ndarray:
        if num_pages > self._free:
            raise KVAllocationError(
                f"cannot allocate {num_pages} pages ({self._free} free)")
        out = np.empty(num_pages, dtype=np.int32)
        for i in range(num_pages):
            out[i] = self._head
            self._allocated[self._head] = True
            self._refs[self._head] = 1
            self._head = int(self._next[self._head - 1])
        self._free -= num_pages
        return out

    def add_ref(self, pages: PageIds) -> None:
        """Attach ``pages`` to one more block table: a live page (shared)
        or a parked one (a prefix-cache hit reviving it), never a free
        one."""
        for p in np.atleast_1d(np.asarray(pages, dtype=np.int64)):
            p = self._check_page(p)
            if not self._allocated[p]:
                raise ValueError(
                    f"add_ref of free page {p} (not allocated)")
            if self._refs[p] == 0:
                self._parked -= 1
            self._refs[p] += 1

    def decref(self, pages: PageIds) -> List[int]:
        """Detach ``pages`` from one block table; returns the pages that
        reached refcount zero.  Those stay allocated (parked): the caller
        reclaims them or leaves them to the prefix cache.  Raises on a
        page already on the free list and on a parked page."""
        zeroed: List[int] = []
        for p in np.atleast_1d(np.asarray(pages, dtype=np.int64)):
            p = self._check_page(p)
            if not self._allocated[p]:
                raise ValueError(
                    f"double free of page {p}: already on the free list")
            if self._refs[p] <= 0:
                raise ValueError(
                    f"refcount underflow on page {p}: parked (cache-"
                    "retained) pages must be reclaimed, not freed")
            self._refs[p] -= 1
            if self._refs[p] == 0:
                self._parked += 1
                zeroed.append(p)
        return zeroed

    def reclaim(self, pages: PageIds) -> None:
        """Return parked (allocated, zero-ref) pages to the free list."""
        pages = np.atleast_1d(np.asarray(pages, dtype=np.int64))
        for p in pages:
            p = self._check_page(p)
            if not self._allocated[p]:
                raise ValueError(
                    f"double free of page {p}: already on the free list")
            if self._refs[p] != 0:
                raise ValueError(
                    f"reclaim of live page {p} (refcount {self._refs[p]})")
            self._allocated[p] = False
            self._parked -= 1
            self._next[p - 1] = self._head
            self._head = p
        self._free += len(pages)

    def free(self, pages: PageIds) -> None:
        """Detach ``pages`` and reclaim whatever reaches refcount zero
        (the release path without prefix caching)."""
        pages = np.atleast_1d(np.asarray(pages, dtype=np.int64))
        if len(pages):
            self.reclaim(self.decref(pages))
