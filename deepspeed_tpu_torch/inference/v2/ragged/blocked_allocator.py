"""Free-list allocator for KV-cache pages (host state only).

Counterpart of ``deepspeed_tpu/inference/v2/ragged/blocked_allocator.py``
without the prefix-cache refcounts (prefix caching is a later slice):
every allocated page belongs to exactly one sequence.

Page index 0 is the **null page**: padding tokens of a ragged batch
scatter their garbage KV into it, which keeps every shape static without
conditional writes.  Valid pages are 1..num_pages inclusive.
"""

from __future__ import annotations

from typing import Iterable, Union

import numpy as np

NULL_PAGE = 0


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
        self._allocated = np.zeros(num_pages + 1, dtype=bool)

    @property
    def free_pages(self) -> int:
        return self._free

    @property
    def total_pages(self) -> int:
        return self._num_pages

    def _check_page(self, p: int) -> int:
        p = int(p)
        if not (1 <= p <= self._num_pages):
            raise ValueError(f"invalid page index {p}")
        return p

    def is_allocated(self, page: int) -> bool:
        return bool(self._allocated[self._check_page(page)])

    def allocate(self, num_pages: int) -> np.ndarray:
        if num_pages > self._free:
            raise KVAllocationError(
                f"cannot allocate {num_pages} pages ({self._free} free)")
        out = np.empty(num_pages, dtype=np.int32)
        for i in range(num_pages):
            out[i] = self._head
            self._allocated[self._head] = True
            self._head = int(self._next[self._head - 1])
        self._free -= num_pages
        return out

    def free(self, pages: Union[Iterable[int], np.ndarray]) -> None:
        """Return pages to the free list; raises on a double free."""
        pages = [self._check_page(p)
                 for p in np.atleast_1d(np.asarray(pages, dtype=np.int64))]
        for p in pages:
            if not self._allocated[p]:
                raise ValueError(
                    f"double free of page {p}: already on the free list")
            self._allocated[p] = False
            self._next[p - 1] = self._head
            self._head = p
        self._free += len(pages)
