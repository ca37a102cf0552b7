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
so a byte budget buys about twice the pages.

Preemption moves a sequence's pages to host memory and back
(``offload_pages`` / ``restore_pages``): an fp blob is one host tensor
``[L, n, page_size, 2, K, D]``, an int8 blob a :class:`PageBlob` (codes
and scales as one unit).  On the card the blob is pinned and the copies
are queued on the current stream, one layer at a time, so they never
need a second pool's worth of device memory and stream order keeps a
freed page from being rewritten before its copy has left.  A restore
writes the pages back into the same cache tensor in place: every CUDA
graph was captured over it.  (The JAX package pads the page list to a
power-of-two bucket so that XLA compiles one program per bucket; torch
indexing compiles nothing, so the port copies exactly ``n`` pages.)
A snapshot exports pages with ``read_pages`` and imports them with
``restore_pages``; the page layout is the JAX package's, so pages cross
between the packages unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Union

import numpy as np
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


def pages_for_memory(cfg: KVCacheConfig, budget_bytes: int) -> int:
    """How many pages fit in ``budget_bytes``."""
    return max(1, budget_bytes // cfg.bytes_per_page)


class PageBlob:
    """Host blob of int8 pages: codes ``[L, n, page, 2, K, D]`` and fp32
    scales ``[L, n, page, 2, K]`` travelling as one unit.  ``shape`` is
    the codes' and ``nbytes`` counts both, as for an fp blob tensor."""

    __slots__ = ("payload", "scale")

    def __init__(self, payload: torch.Tensor, scale: torch.Tensor):
        self.payload = payload
        self.scale = scale

    @property
    def shape(self):
        return self.payload.shape

    @property
    def nbytes(self) -> int:
        return self.payload.nbytes + self.scale.nbytes


Blob = Union[torch.Tensor, PageBlob]


def blob_columns(blob: Blob, cols) -> Blob:
    """``blob[:, cols]`` (a list of page columns) for a tensor blob and
    a :class:`PageBlob`: a copy, so one page of a demoted batch holds
    its own storage and no other page's."""
    if isinstance(blob, PageBlob):
        return PageBlob(blob.payload[:, cols], blob.scale[:, cols])
    return blob[:, cols]


def concat_blobs(blobs: Sequence[Blob]) -> Blob:
    """Blobs joined along the page axis (a promoted digest chain's
    single-page blobs become one restore)."""
    if isinstance(blobs[0], PageBlob):
        return PageBlob(torch.cat([b.payload for b in blobs], dim=1),
                        torch.cat([b.scale for b in blobs], dim=1))
    return torch.cat(list(blobs), dim=1)


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

    # -- host blobs (preemption) -------------------------------------------
    def _stores(self):
        """The device tensors a blob mirrors: the cache tensor, or the
        codes and the scales of a ``KVPages``."""
        if self.cfg.quantized:
            return [self.data.payload, self.data.scale]
        return [self.data]

    def read_pages(self, pages: Sequence[int]) -> Blob:
        """Copy ``pages`` to a host blob without freeing them.  On the
        card the copies are queued on the current stream into pinned
        memory: synchronize it before reading the blob on the host."""
        stores = self._stores()
        dev = stores[0].device
        idx = torch.as_tensor(list(pages), dtype=torch.long).to(dev)
        pin = dev.type == "cuda"
        parts = []
        for store in stores:
            host = torch.empty((store.shape[0], len(idx)) + store.shape[2:],
                               dtype=store.dtype, pin_memory=pin)
            for layer in range(store.shape[0]):
                # one layer's pages at a time: the gather's temporary is
                # a layer's share of the blob, not the whole blob
                host[layer].copy_(store[layer].index_select(0, idx),
                                  non_blocking=pin)
            parts.append(host)
        return PageBlob(*parts) if self.cfg.quantized else parts[0]

    def offload_pages(self, pages: Sequence[int]) -> Blob:
        """Copy ``pages`` to a host blob and free them on the device."""
        blob = self.read_pages(pages)
        self.allocator.free(list(pages))
        return blob

    def restore_pages(self, blob: Blob) -> np.ndarray:
        """Reserve fresh pages and write ``blob`` into them, in place
        (``index_copy_`` per layer); returns the new page ids.  The blob
        may also be a snapshot's (host tensors that are not pinned, in
        the cache's dtype)."""
        if self.cfg.quantized != isinstance(blob, PageBlob):
            raise TypeError(
                "a blob of another page encoding: an int8 cache restores "
                "a PageBlob (codes + scales), an fp cache a tensor; the "
                "source pool's quantization must match")
        n = int(blob.shape[1])
        pages = self.reserve(n)
        stores = self._stores()
        dev = stores[0].device
        idx = torch.as_tensor(pages, dtype=torch.long).to(dev)
        parts = [blob.payload, blob.scale] if self.cfg.quantized else [blob]
        for store, host in zip(stores, parts):
            for layer in range(store.shape[0]):
                store[layer].index_copy_(
                    0, idx, host[layer].to(dev, non_blocking=True))
        return pages
