"""Persistent state manager: tracked sequences + blocked KV cache.

Counterpart of ``deepspeed_tpu/inference/v2/ragged/manager.py`` for the
slice without prefix caching, tiers, offload or export/import: pages are
allocated as sequences grow and returned when they are flushed.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from .kv_cache import BlockedKVCache, KVCacheConfig
from .sequence import SequenceDescriptor


class StateManager:
    def __init__(self, kv_config: KVCacheConfig, device: torch.device,
                 max_tracked_sequences: int = 2048):
        self.kv_config = kv_config
        self.max_tracked_sequences = max_tracked_sequences
        self.kv_cache = BlockedKVCache(kv_config, device)
        self._seqs: Dict[int, SequenceDescriptor] = {}

    @property
    def n_tracked_sequences(self) -> int:
        return len(self._seqs)

    @property
    def free_pages(self) -> int:
        return self.kv_cache.free_pages

    def get_sequence(self, uid: int) -> Optional[SequenceDescriptor]:
        return self._seqs.get(uid)

    def get_or_create_sequence(self, uid: int) -> SequenceDescriptor:
        sd = self._seqs.get(uid)
        if sd is None:
            if len(self._seqs) >= self.max_tracked_sequences:
                raise RuntimeError(
                    f"tracked-sequence limit {self.max_tracked_sequences} hit")
            sd = SequenceDescriptor(uid=uid)
            self._seqs[uid] = sd
        return sd

    def flush_sequence(self, uid: int) -> None:
        sd = self._seqs.pop(uid, None)
        if sd is not None:
            self.kv_cache.release(sd.pages)

    def pages_needed(self, sd: SequenceDescriptor, n_new_tokens: int) -> int:
        """Extra pages required to hold ``n_new_tokens`` more tokens."""
        page = self.kv_config.page_size
        need = -(-(sd.seen_tokens + n_new_tokens) // page)  # ceil
        return max(0, need - sd.allocated_capacity)

    def allocate_for(self, sd: SequenceDescriptor, n_new_tokens: int) -> None:
        extra = self.pages_needed(sd, n_new_tokens)
        if extra:
            sd.extend_pages(self.kv_cache.reserve(extra))

    def check_invariants(self) -> None:
        """Every block-table page is allocated exactly once and
        ``free + referenced == total``."""
        alloc = self.kv_cache.allocator
        refs = [p for sd in self._seqs.values() for p in sd.pages]
        if len(set(refs)) != len(refs):
            raise RuntimeError("KV invariant: a page is in two block tables")
        for p in refs:
            if not alloc.is_allocated(p):
                raise RuntimeError(
                    f"KV invariant: page {p} is in a block table but on "
                    "the free list")
        if alloc.free_pages + len(refs) != alloc.total_pages:
            raise RuntimeError(
                f"KV invariant: free({alloc.free_pages}) + "
                f"referenced({len(refs)}) != total({alloc.total_pages})")
