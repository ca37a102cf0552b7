"""Blocked (paged) KV cache on the device.

Counterpart of ``deepspeed_tpu/inference/v2/ragged/kv_cache.py``.  One
stacked tensor per cache

    kv : [num_layers, num_pages + 1, page_size, 2, kv_heads, head_dim]

updated in place by the model's ``write_kv`` (the JAX package donated
the array to each compiled step instead).  Page 0 is the null page; it
starts zeroed like every page, so a padding read never meets
uninitialised memory.

With ``quantization="int8"`` the store is a
:class:`~deepspeed_tpu_torch.ops.paged_attention.KVPages` pair: int8
codes at the layout above plus a per-(token, kv-head) fp32 scale sidecar
``[L, num_pages + 1, page_size, 2, K]``; ``bytes_per_page`` counts both,
so a byte budget buys about twice the pages.  Host-side page blobs
(offload, snapshots, handoffs) are not ported yet.
"""

from __future__ import annotations

import dataclasses

import torch

from ....ops.paged_attention import KV_QUANT_FORMATS, KVPages
from .blocked_allocator import BlockedAllocator


@dataclasses.dataclass(frozen=True)
class KVCacheConfig:
    num_layers: int
    kv_heads: int
    head_dim: int
    page_size: int = 64
    num_pages: int = 1024
    dtype: torch.dtype = torch.bfloat16
    #: "none" (fp pages at ``dtype``) or "int8" (block-scaled codes + one
    #: fp32 scale per head_dim block)
    quantization: str = "none"

    def __post_init__(self):
        if self.quantization not in KV_QUANT_FORMATS:
            raise ValueError(
                f"unknown kv quantization {self.quantization!r} "
                f"(supported: {KV_QUANT_FORMATS})")

    @property
    def quantized(self) -> bool:
        return self.quantization != "none"

    @property
    def bytes_per_page(self) -> int:
        """Bytes one page takes across all layers."""
        elems = (self.num_layers * self.page_size * 2 * self.kv_heads
                 * self.head_dim)
        if self.quantized:
            # 1 byte per code + one fp32 scale per head_dim block
            scales = self.num_layers * self.page_size * 2 * self.kv_heads
            return elems + scales * 4
        return elems * self.dtype.itemsize

    def total_bytes(self) -> int:
        return self.bytes_per_page * (self.num_pages + 1)


class BlockedKVCache:
    """Device cache tensor (or ``KVPages`` pair) + host page allocator.
    Pages are shared by index, so an int8 page's codes and scales are
    shared together."""

    def __init__(self, cfg: KVCacheConfig, device: torch.device):
        self.cfg = cfg
        self.allocator = BlockedAllocator(cfg.num_pages)
        shape = (cfg.num_layers, cfg.num_pages + 1, cfg.page_size, 2,
                 cfg.kv_heads, cfg.head_dim)
        if cfg.quantized:
            self.data = KVPages(
                torch.zeros(shape, dtype=torch.int8, device=device),
                torch.zeros(shape[:-1], dtype=torch.float32, device=device))
        else:
            self.data = torch.zeros(shape, dtype=cfg.dtype, device=device)

    @property
    def free_pages(self) -> int:
        return self.allocator.free_pages

    def reserve(self, num_pages: int):
        return self.allocator.allocate(num_pages)
