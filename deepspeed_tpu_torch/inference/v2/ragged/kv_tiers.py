"""Host and disk tier of the prefix cache, below the device page pool.

Counterpart of ``deepspeed_tpu/inference/v2/ragged/kv_tiers.py``.  The
device prefix cache is the otherwise idle pool, so under load a parked
prefix is evicted within minutes and a returning conversation pays its
whole prefill again.  Pages that ``StateManager.ensure_free`` would
reclaim are *demoted* here instead:

    device pool --evict--> host ring --overflow--> disk files

Entries are keyed by the prefix cache's chained blake2b digests, so a
page's identity is the same in every tier.  ``take_many`` (promotion)
removes a run of entries and hands their blobs back for a restore into
fresh device pages.

A blob is one page: a host tensor ``[L, 1, page, 2, K, D]`` (pinned
when it came from the card), or an int8 :class:`~.kv_cache.PageBlob`
(codes and scales travel together, never re-encoded).  A disk entry is
one file per digest holding the payload's raw bytes (then the scales');
its dtype and shape stay in this process's index, so bf16 pages need no
numpy dtype, as in the snapshot bundles.  Disk I/O goes through the
async I/O handle (``ops/aio``): a spill is a ``sync_pwrite`` a part, and
a promotion submits the reads of every disk page of its chain (payload
and scales) before it waits on any, so the reads overlap.  Only when the
native extension cannot be built does the store fall back to plain
buffered file I/O (logged once); ``stats()["plain_io"]`` counts the
file operations that took that path.

This is a cache: an I/O error (a failed spill, a torn or unreadable
file) drops the entry and counts in ``io_errors``; a promotion stops at
it and the caller prefills the rest, so a failed read never returns a
blob.  ``check_invariants`` audits that every digest the store accepted
is in exactly one of {host ring, disk, in-flight promotion} and the
count and byte bounds.
"""

from __future__ import annotations

import math
import os
import shutil
import tempfile
import warnings
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

import torch

from ....utils.logging import logger
from .kv_cache import PageBlob


class _DiskMeta:
    """This process's record of one disk entry."""

    __slots__ = ("path", "shape", "dtype", "scale_shape", "scale_dtype",
                 "nbytes")

    def __init__(self, path, shape, dtype, scale_shape, scale_dtype,
                 nbytes):
        self.path = path
        self.shape = shape
        self.dtype = dtype
        self.scale_shape = scale_shape
        self.scale_dtype = scale_dtype
        self.nbytes = nbytes


def _blob_nbytes(blob) -> int:
    """Bytes of one page blob (a tensor's or a PageBlob's)."""
    return int(blob.nbytes)


def _bytes_view(t: torch.Tensor):
    """A host tensor's bytes as a flat numpy uint8 view (no copy when it
    is contiguous), whatever its dtype."""
    return t.contiguous().reshape(-1).view(torch.uint8).numpy()


def _from_raw(raw: bytes, shape, dtype: torch.dtype) -> torch.Tensor:
    return torch.frombuffer(bytearray(raw), dtype=torch.uint8).view(
        dtype).reshape(shape)


class TieredPageStore:
    """A bounded host ring and a bounded disk spill for single-page KV
    blobs, in LRU order.  ``bytes_per_page`` bounds the disk tier in
    bytes too (``disk_pages`` pages of that size)."""

    def __init__(self, host_pages: int, disk_pages: int = 0,
                 disk_dir: Optional[str] = None,
                 bytes_per_page: int = 0) -> None:
        if host_pages < 1:
            raise ValueError(
                f"tier host ring needs >= 1 page, got {host_pages}")
        self._host_cap = int(host_pages)
        self._disk_cap = max(0, int(disk_pages))
        self._bytes_per_page = max(0, int(bytes_per_page))
        self._disk_bytes_cap = self._disk_cap * self._bytes_per_page
        self._host_bytes = 0
        self._disk_bytes = 0
        #: digest -> blob, oldest first
        self._host: "OrderedDict[bytes, object]" = OrderedDict()
        #: digest -> _DiskMeta, oldest first
        self._disk: "OrderedDict[bytes, _DiskMeta]" = OrderedDict()
        #: digests handed out by take_many and not yet restored on the
        #: device by the caller (``landed``)
        self._inflight = 0
        self._indexed = 0
        self._dir = None
        self._own_dir = False
        self._aio = None
        self._aio_failed = False
        if self._disk_cap:
            if disk_dir:
                os.makedirs(disk_dir, exist_ok=True)
                self._dir = disk_dir
            else:
                self._dir = tempfile.mkdtemp(prefix="ds_kv_tier_")
                self._own_dir = True
        self.demoted_pages = 0
        self.promoted_pages = 0
        self.spilled_pages = 0
        self.io_errors = 0
        #: file operations (writes and reads) that took the plain path
        #: because the async I/O extension could not be built
        self.plain_io = 0

    # -- population ------------------------------------------------------------
    @property
    def host_pages(self) -> int:
        return len(self._host)

    @property
    def disk_pages(self) -> int:
        return len(self._disk)

    @property
    def host_bytes(self) -> int:
        return self._host_bytes

    @property
    def disk_bytes(self) -> int:
        return self._disk_bytes

    @property
    def inflight_pages(self) -> int:
        return self._inflight

    @property
    def indexed_pages(self) -> int:
        return self._indexed

    def contains(self, digest: bytes) -> Optional[str]:
        """Which tier holds ``digest`` ("host" or "disk"), else None."""
        if digest in self._host:
            return "host"
        if digest in self._disk:
            return "disk"
        return None

    # -- file I/O (the async I/O handle; plain files without it) -------------
    def _get_aio(self):
        """The store's async I/O handle, built at first use; None when the
        native extension cannot be built (plain file I/O then, the same
        files)."""
        if self._aio is None and not self._aio_failed:
            try:
                from ....ops.aio import AsyncIOHandle
                self._aio = AsyncIOHandle()
            except Exception as e:
                self._aio_failed = True
                logger.info("kv tier: native AIO unavailable (%s: %s); "
                            "the disk tier uses plain file I/O",
                            type(e).__name__, e)
        return self._aio

    def _write_file(self, path: str, parts: List[torch.Tensor]) -> None:
        aio = self._get_aio()
        if aio is not None:
            off = 0
            for t in parts:
                arr = _bytes_view(t)
                aio.sync_pwrite(arr, path, off)
                off += arr.nbytes
            return
        self.plain_io += 1
        with open(path, "wb") as f:
            for t in parts:
                f.write(_bytes_view(t).tobytes())

    def _read_file_plain(self, meta: _DiskMeta):
        self.plain_io += 1
        with open(meta.path, "rb") as f:
            raw = f.read()
        if len(raw) != meta.nbytes:
            raise OSError(f"torn tier file {meta.path}")
        n = math.prod(meta.shape) * meta.dtype.itemsize
        payload = _from_raw(raw[:n], meta.shape, meta.dtype)
        if meta.scale_shape is None:
            return payload
        return PageBlob(payload, _from_raw(raw[n:], meta.scale_shape,
                                           meta.scale_dtype))

    @staticmethod
    def _submit_read(aio, meta: _DiskMeta):
        """Submit the reads of one disk entry: ``(buffers, request
        ids)``, the payload's bytes then the scales'."""
        n = math.prod(meta.shape) * meta.dtype.itemsize
        sizes = [n] + ([meta.nbytes - n] if meta.scale_shape is not None
                       else [])
        bufs, reqs, off = [], [], 0
        for size in sizes:
            buf = torch.empty(size, dtype=torch.uint8)
            reqs.append(aio.pread(buf.numpy(), meta.path, off))
            bufs.append(buf)
            off += size
        return bufs, reqs

    @staticmethod
    def _blob_of(meta: _DiskMeta, bufs: List[torch.Tensor]):
        payload = bufs[0].view(meta.dtype).reshape(meta.shape)
        if meta.scale_shape is None:
            return payload
        return PageBlob(payload, bufs[1].view(meta.scale_dtype).reshape(
            meta.scale_shape))

    # -- demotion (device eviction -> host -> disk) ----------------------------
    def put(self, digest: bytes, blob) -> bool:
        """Take one evicted page's blob under its chain digest.  False
        when it was not stored (a digest already held: the first writer
        wins, as in the device index)."""
        if digest in self._host or digest in self._disk:
            if digest in self._host:
                self._host.move_to_end(digest)
            return False
        self._host[digest] = blob
        self._host_bytes += _blob_nbytes(blob)
        self._indexed += 1
        self.demoted_pages += 1
        while len(self._host) > self._host_cap:
            d, spill = self._host.popitem(last=False)
            self._host_bytes -= _blob_nbytes(spill)
            if not self._spill_to_disk(d, spill):
                self._indexed -= 1  # left the tier altogether
        return True

    def _evict_disk_lru(self) -> None:
        d, meta = self._disk.popitem(last=False)
        self._disk_bytes -= meta.nbytes
        self._indexed -= 1
        try:
            os.unlink(meta.path)
        except OSError:
            pass

    def _spill_to_disk(self, digest: bytes, blob) -> bool:
        """The host ring's oldest entry goes to a file of its own; a full
        disk tier drops its own oldest file first.  A failure drops the
        entry."""
        if not self._disk_cap or self._dir is None:
            return False
        while len(self._disk) >= self._disk_cap:
            self._evict_disk_lru()
        path = os.path.join(self._dir, digest.hex() + ".kvp")
        quantized = isinstance(blob, PageBlob)
        payload = blob.payload if quantized else blob
        scale = blob.scale if quantized else None
        new_bytes = int(payload.nbytes) + (int(scale.nbytes)
                                           if quantized else 0)
        if self._disk_bytes_cap:
            # the byte bound: files go oldest first until the entry fits;
            # an entry larger than the whole bound is dropped
            while (self._disk
                   and self._disk_bytes + new_bytes > self._disk_bytes_cap):
                self._evict_disk_lru()
            if self._disk_bytes + new_bytes > self._disk_bytes_cap:
                return False
        try:
            self._write_file(path, [payload] + ([scale] if quantized
                                                else []))
        except (OSError, RuntimeError) as e:
            self.io_errors += 1
            warnings.warn(f"kv tier: disk spill failed ({e}); entry "
                          "dropped (clean miss)")
            try:
                os.unlink(path)
            except OSError:
                pass
            return False
        self._disk[digest] = _DiskMeta(
            path, tuple(payload.shape), payload.dtype,
            tuple(scale.shape) if quantized else None,
            scale.dtype if quantized else None, new_bytes)
        self._disk_bytes += new_bytes
        self.spilled_pages += 1
        return True

    # -- promotion (tier -> device) --------------------------------------------
    def take_many(self, digests: List[bytes]
                  ) -> Tuple[List[object], List[str]]:
        """Remove and return the blobs of a CONTIGUOUS run of chain
        digests, stopping at the first miss or failed read.  Returns
        ``(blobs, tiers)``, ``tiers[i]`` "host" or "disk"."""
        plan: List[Tuple[bytes, str]] = []
        for d in digests:
            t = self.contains(d)
            if t is None:
                break
            plan.append((d, t))
        aio = (self._get_aio() if any(t == "disk" for _, t in plan)
               else None)
        #: digest -> (buffers, request ids), or None when a submit failed
        pending: Dict[bytes, Optional[tuple]] = {}
        if aio is not None:
            # every disk read of the chain is in flight before the first
            # wait
            for d, t in plan:
                if t != "disk":
                    continue
                try:
                    pending[d] = self._submit_read(aio, self._disk[d])
                except (OSError, RuntimeError):
                    pending[d] = None
        blobs: List[object] = []
        tiers: List[str] = []
        for d, t in plan:
            if t == "host":
                got = self._host.pop(d)
                self._host_bytes -= _blob_nbytes(got)
                blobs.append(got)
                tiers.append("host")
                self._inflight += 1
                continue
            meta = self._disk[d]
            try:
                if aio is None:
                    blob = self._read_file_plain(meta)
                else:
                    got = pending.pop(d)
                    if got is None:
                        raise OSError(f"tier read submit failed for "
                                      f"{meta.path}")
                    bufs, reqs = got
                    for req in reqs:
                        aio.wait(req)
                    blob = self._blob_of(meta, bufs)
            except (OSError, RuntimeError, ValueError) as e:
                # the chain is only usable up to here: drop the entry and
                # stop (the rest stays for a later promotion)
                self.io_errors += 1
                warnings.warn(f"kv tier: promotion read failed ({e}); "
                              "entry dropped (clean miss)")
                self._drop(d)
                break
            del self._disk[d]
            self._disk_bytes -= meta.nbytes
            try:
                os.unlink(meta.path)
            except OSError:
                pass
            blobs.append(blob)
            tiers.append("disk")
            self._inflight += 1
        # reads submitted past a failed one are drained and dropped; their
        # entries stay on disk for a later promotion
        for got in pending.values():
            for req in (got[1] if got is not None else ()):
                try:
                    aio.wait(req)
                except (OSError, RuntimeError):
                    pass
        self.promoted_pages += len(blobs)
        return blobs, tiers

    def landed(self, n: int) -> None:
        """The caller restored ``n`` promoted pages on the device (or
        gave them up): their in-flight accounting closes."""
        self._inflight -= n
        self._indexed -= n

    def discard(self, digest: bytes) -> None:
        """Forget ``digest`` if held: the device index took that prefix
        again another way (a fresh prefill), and a digest is never both
        device-indexed and tier-resident."""
        self._drop(digest)

    def _drop(self, digest: bytes) -> None:
        blob = self._host.pop(digest, None)
        if blob is not None:
            self._host_bytes -= _blob_nbytes(blob)
            self._indexed -= 1
            return
        meta = self._disk.pop(digest, None)
        if meta is not None:
            self._disk_bytes -= meta.nbytes
            self._indexed -= 1
            try:
                os.unlink(meta.path)
            except OSError:
                pass

    def clear(self) -> None:
        """Drop every entry (a cold start that keeps the store)."""
        self._host.clear()
        self._host_bytes = 0
        for meta in self._disk.values():
            try:
                os.unlink(meta.path)
            except OSError:
                pass
        self._disk.clear()
        self._disk_bytes = 0
        self._indexed = self._inflight

    # -- audit and lifecycle ---------------------------------------------------
    def check_invariants(self) -> None:
        """host + disk + in flight == indexed, the caps and the byte
        bound respected, the byte ledger exact, every disk entry's file
        present.  RuntimeError on a violation."""
        if (len(self._host) + len(self._disk) + self._inflight
                != self._indexed):
            raise RuntimeError(
                f"KV tier invariant: host({len(self._host)}) + "
                f"disk({len(self._disk)}) + inflight({self._inflight}) "
                f"!= indexed({self._indexed})")
        if len(self._host) > self._host_cap:
            raise RuntimeError(
                f"KV tier invariant: host ring {len(self._host)} over "
                f"cap {self._host_cap}")
        if len(self._disk) > self._disk_cap:
            raise RuntimeError(
                f"KV tier invariant: disk tier {len(self._disk)} over "
                f"cap {self._disk_cap}")
        if self._disk_bytes_cap and self._disk_bytes > self._disk_bytes_cap:
            raise RuntimeError(
                f"KV tier invariant: disk tier {self._disk_bytes}B over "
                f"byte bound {self._disk_bytes_cap}B")
        if self._disk_bytes != sum(m.nbytes for m in self._disk.values()):
            raise RuntimeError(
                "KV tier invariant: disk byte ledger "
                f"({self._disk_bytes}) != sum of entry sizes")
        if self._host_bytes != sum(_blob_nbytes(b)
                                   for b in self._host.values()):
            raise RuntimeError(
                "KV tier invariant: host byte ledger "
                f"({self._host_bytes}) != sum of blob sizes")
        for meta in self._disk.values():
            if not os.path.exists(meta.path):
                raise RuntimeError(
                    f"KV tier invariant: disk entry lost its file "
                    f"{meta.path}")

    def stats(self) -> dict:
        return {"host_pages": len(self._host),
                "disk_pages": len(self._disk),
                "host_bytes": self._host_bytes,
                "disk_bytes": self._disk_bytes,
                "inflight_pages": self._inflight,
                "demoted_pages": self.demoted_pages,
                "promoted_pages": self.promoted_pages,
                "spilled_pages": self.spilled_pages,
                "io_errors": self.io_errors,
                "plain_io": self.plain_io}

    def close(self) -> None:
        """Drop every entry and delete every disk file (in a directory
        the caller gave too: the index dies with the process, so a file
        left behind could never be read again) and an owned directory.
        The store is unusable afterwards."""
        if self._aio is not None:
            try:
                self._aio.close()
            except Exception:
                pass
            self._aio = None
        self._host.clear()
        self._host_bytes = 0
        for meta in self._disk.values():
            try:
                os.unlink(meta.path)
            except OSError:
                pass
        self._disk.clear()
        self._disk_bytes = 0
        self._inflight = 0
        self._indexed = 0
        if self._own_dir and self._dir:
            shutil.rmtree(self._dir, ignore_errors=True)
