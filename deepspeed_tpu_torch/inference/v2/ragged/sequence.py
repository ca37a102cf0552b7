"""Per-sequence host state (counterpart of ``ragged/sequence.py``)."""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np


@dataclasses.dataclass
class SequenceDescriptor:
    uid: int
    #: tokens whose KV is already committed to the cache
    seen_tokens: int = 0
    #: KV pages in this sequence's block table, in order; full prompt
    #: pages may be SHARED with other sequences (allocator refcounts)
    pages: List[int] = dataclasses.field(default_factory=list)
    #: tokens in flight in the current forward (pre_forward..post_forward)
    in_flight_tokens: int = 0
    #: the host KV blob while preempted (``offload_sequence``), else None
    host_blob: object = None
    #: the table slots the blob's pages came from (window-evicted slots
    #: stay null through an offload/restore cycle)
    live_slots: List[int] = dataclasses.field(default_factory=list)
    #: the full prompt, registered at admission under prefix caching: the
    #: indexer hashes full prompt pages from it (generated tokens are
    #: never indexed: under the async chain their values reach the host
    #: a step late)
    prompt_tokens: Optional[np.ndarray] = None
    #: leading full pages the prefix indexer has walked
    indexed_pages: int = 0
    #: the page-hash chain's cursor at ``indexed_pages``
    last_digest: bytes = b""
    #: the tokens the prefix match attached, by tier of origin
    #: (``{"device", "host", "disk", "remote"}``); None before a match
    tier_hits: Optional[dict] = None

    @property
    def allocated_capacity(self) -> int:
        return len(self.pages)

    def pre_forward(self, n_tokens: int) -> None:
        self.in_flight_tokens = n_tokens

    def post_forward(self) -> None:
        self.seen_tokens += self.in_flight_tokens
        self.in_flight_tokens = 0

    def commit_tokens(self, n: int) -> None:
        """Variable advance (a speculative verify): only ``n`` of the
        in-flight tokens join the sequence; the rest were rejected drafts
        whose KV slots the next step writes before anything reads them.
        ``0 <= n <= in_flight_tokens``."""
        self.seen_tokens += min(max(n, 0), self.in_flight_tokens)
        self.in_flight_tokens = 0

    def extend_pages(self, pages: np.ndarray) -> None:
        self.pages.extend(int(p) for p in pages)

    def evict_pages_below(self, first_live_page: int) -> List[int]:
        """Sliding-window eviction: pages wholly below the attention
        window are dead for every later query (positions only grow).
        Their table slots become the null page, which the windowed
        attention paths skip, and the page ids are returned for release.
        The table stays positional (slot = position // page_size)."""
        freed = []
        for i in range(min(first_live_page, len(self.pages))):
            if self.pages[i] != 0:
                freed.append(self.pages[i])
                self.pages[i] = 0
        return freed

    def page_table(self, max_pages: int) -> np.ndarray:
        """Block table row padded with the null page to ``max_pages``."""
        if len(self.pages) > max_pages:
            raise ValueError(
                f"sequence {self.uid} has {len(self.pages)} pages "
                f"> bucket max {max_pages}")
        row = np.zeros(max_pages, dtype=np.int32)
        row[:len(self.pages)] = self.pages
        return row


def placeholder() -> SequenceDescriptor:
    """A throwaway descriptor for schedulability queries on unknown uids
    (reference ``PlaceholderSequenceDescriptor``)."""
    return SequenceDescriptor(uid=-1)
