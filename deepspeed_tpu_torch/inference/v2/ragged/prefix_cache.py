"""Automatic prefix cache over the blocked KV pool (host state only).

Counterpart of ``deepspeed_tpu/inference/v2/ragged/prefix_cache.py``.
The device only ever sees page *indices* in a block table, so a full
page of committed prompt KV can sit in many sequences' tables at once
(the allocator's refcounts count the sharers).

The index is a chained hash at page granularity: page i of a prompt is
keyed by

    digest_i = blake2b(digest_{i-1} || int32 tokens[i*page : (i+1)*page])

so a digest names the cumulative token prefix, not one page's tokens.
Matching walks the chain from the root and stops at the first miss.

Only FULL prompt pages are indexed or attached; a prompt's partial last
page and every decode page belong to their sequence, so shared pages are
never written again and no KV is copied.  A finished sequence's indexed
pages are *parked* (allocated, refcount 0, still indexed) and ``evict``
reclaims them in LRU order under pool pressure.  Evicting a page in the
middle of a chain orphans its descendants from later matches (they stay
reclaimable one by one).
"""

from __future__ import annotations

import hashlib
from collections import OrderedDict
from itertools import islice
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np


class PrefixCache:
    """Chained-hash index: cumulative page digest -> page id."""

    def __init__(self, page_size: int) -> None:
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        self.page_size = page_size
        #: digest -> page id, in LRU order (oldest first)
        self._entries: "OrderedDict[bytes, int]" = OrderedDict()
        #: page id -> digest (a page is bound to at most one digest)
        self._by_page: Dict[int, bytes] = {}

    def __len__(self) -> int:
        return len(self._entries)

    @staticmethod
    def chain(parent_digest: bytes, tokens: np.ndarray) -> bytes:
        h = hashlib.blake2b(digest_size=16)
        h.update(parent_digest)
        h.update(np.ascontiguousarray(tokens, dtype=np.int32).tobytes())
        return h.digest()

    def match(self, tokens: np.ndarray,
              max_pages: int) -> Tuple[List[int], bytes]:
        """Longest cached prefix of ``tokens``, up to ``max_pages`` full
        pages: (page ids, digest of the last matched page).  The digest
        seeds the sequence's indexing cursor, so its own full pages chain
        onto the shared ones.  Hits are LRU-touched."""
        ps = self.page_size
        pages: List[int] = []
        digest = b""
        for i in range(min(max_pages, len(tokens) // ps)):
            d = self.chain(digest, tokens[i * ps:(i + 1) * ps])
            page = self._entries.get(d)
            if page is None:
                break
            self._entries.move_to_end(d)
            pages.append(page)
            digest = d
        return pages, digest

    def insert(self, digest: bytes, page: int) -> bool:
        """Index ``page`` under ``digest``.  The first writer wins: a
        digest already bound keeps its page (the caller's page stays
        private and is freed with its sequence)."""
        if digest in self._entries:
            self._entries.move_to_end(digest)
            return False
        if page in self._by_page:
            return False
        self._entries[digest] = int(page)
        self._by_page[int(page)] = digest
        return True

    def lookup(self, digest: bytes) -> Optional[int]:
        """The page bound to ``digest`` (LRU-touched), else None."""
        page = self._entries.get(digest)
        if page is not None:
            self._entries.move_to_end(digest)
        return page

    def contains_page(self, page: int) -> bool:
        return int(page) in self._by_page

    def pages(self) -> List[int]:
        return list(self._by_page)

    def touch_page(self, page: int) -> None:
        """Refresh a page's LRU recency (its last sharer just released
        it: it was in use until now)."""
        d = self._by_page.get(int(page))
        if d is not None:
            self._entries.move_to_end(d)

    def drop_pages(self, pages: Iterable[int]) -> None:
        """Unindex ``pages`` (the pages themselves are the caller's)."""
        for p in pages:
            d = self._by_page.pop(int(p), None)
            if d is not None:
                del self._entries[d]

    def evict(self, num_pages: int,
              reclaimable: Callable[[int], bool]) -> List[int]:
        """Unindex up to ``num_pages`` reclaimable pages in LRU order and
        return their ids (the caller reclaims them)."""
        return [p for _, p in self.evict_entries(num_pages, reclaimable)]

    def evict_entries(self, num_pages: int,
                      reclaimable: Callable[[int], bool]
                      ) -> List[Tuple[bytes, int]]:
        """``evict`` with each page's digest.  Entries whose page is still
        live take no extra pool space: they rotate to the recent end (live
        means in use now), so repeated pressure does not rescan them."""
        out: List[Tuple[bytes, int]] = []
        if num_pages <= 0:
            return out
        for _ in range(len(self._entries)):
            if len(out) >= num_pages or not self._entries:
                break
            d, page = next(iter(self._entries.items()))
            if reclaimable(page):
                del self._entries[d]
                del self._by_page[page]
                out.append((d, page))
            else:
                self._entries.move_to_end(d)
        return out

    def export_digests(self, top_k: int = 64) -> List[str]:
        """The bounded affinity hint a replica publishes to the pool
        router: the ``top_k`` most recently used cumulative digests as
        hex, most recent first; no page ids, no KV contents."""
        if top_k <= 0:
            return []
        return [d.hex() for d in islice(reversed(self._entries), top_k)]

    def export_entries(self) -> List[Tuple[bytes, int]]:
        """Every (digest, page) binding in LRU order, oldest first (a
        snapshot's index): inserting them again in this order restores
        the eviction order."""
        return list(self._entries.items())

    def clear(self) -> List[int]:
        """Drop every entry; returns the pages that were indexed (the
        caller reclaims whichever of them are parked)."""
        pages = list(self._by_page)
        self._entries.clear()
        self._by_page.clear()
        return pages
