"""Blocked (paged) KV cache on the device.

Counterpart of ``deepspeed_tpu/inference/v2/ragged/kv_cache.py``, fp
pages only.  One stacked tensor per cache

    kv : [num_layers, num_pages + 1, page_size, 2, kv_heads, head_dim]

updated in place by the model's ``write_kv`` (the JAX package donated
the array to each compiled step instead).  Page 0 is the null page; it
starts zeroed like every page, so a padding read never meets
uninitialised memory.
"""

from __future__ import annotations

import dataclasses

import torch

from .blocked_allocator import BlockedAllocator


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    num_layers: int
    kv_heads: int
    head_dim: int
    page_size: int = 64
    num_pages: int = 1024
    dtype: torch.dtype = torch.bfloat16


class BlockedKVCache:
    """Device cache tensor + host page allocator."""

    def __init__(self, cfg: KVCacheConfig, device: torch.device):
        self.cfg = cfg
        self.allocator = BlockedAllocator(cfg.num_pages)
        shape = (cfg.num_layers, cfg.num_pages + 1, cfg.page_size, 2,
                 cfg.kv_heads, cfg.head_dim)
        self.data = torch.zeros(shape, dtype=cfg.dtype, device=device)

    @property
    def free_pages(self) -> int:
        return self.allocator.free_pages

    def reserve(self, num_pages: int):
        return self.allocator.allocate(num_pages)

    def release(self, pages) -> None:
        if len(pages):
            self.allocator.free(pages)
