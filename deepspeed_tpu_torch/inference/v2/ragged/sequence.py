"""Per-sequence host state (counterpart of ``ragged/sequence.py``)."""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np


@dataclasses.dataclass
class SequenceDescriptor:
    uid: int
    #: tokens whose KV is already committed to the cache
    seen_tokens: int = 0
    #: KV pages in this sequence's block table, in order
    pages: List[int] = dataclasses.field(default_factory=list)
    #: tokens in flight in the current forward (pre_forward..post_forward)
    in_flight_tokens: int = 0

    @property
    def allocated_capacity(self) -> int:
        return len(self.pages)

    def pre_forward(self, n_tokens: int) -> None:
        self.in_flight_tokens = n_tokens

    def post_forward(self) -> None:
        self.seen_tokens += self.in_flight_tokens
        self.in_flight_tokens = 0

    def extend_pages(self, pages: np.ndarray) -> None:
        self.pages.extend(int(p) for p in pages)

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
