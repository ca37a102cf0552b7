"""Persistent state manager: tracked sequences + blocked KV cache.

Counterpart of ``deepspeed_tpu/inference/v2/ragged/manager.py``.  The
manager owns the :class:`PrefixCache` and
is the one place pages leave a block table (flush, preemption offload,
sliding-window eviction), so every release is shared-page aware: a page
returns to the free list only when its last sharer drops it AND the
prefix cache no longer keeps it.  ``free_pages`` counts free-list pages
plus parked ones: the cache is the otherwise idle pool, reclaimed LRU
under allocation pressure.  A preempted sequence holds its private
pages in a host blob (``offload_sequence``); the manager counts those
blobs and their bytes, and ``check_invariants`` audits the counts.
``export_state`` / ``import_state`` move the whole state (sequences,
page contents, host blobs, the prefix index) through a snapshot bundle
in the JAX package's layout.  The selective export of some sequences
(``export_state(seq_ids=...)``) and its merge into a live manager are the
disaggregated prefill -> decode handoff: pages whose chain digest the
importer's prefix cache already indexes attach by reference instead of
streaming.  ``export_prefix`` / ``import_prefix`` move a digest chain's
pages between two replicas' prefix caches (the pool's page fetch).

With a host/disk tier (``tier_host_pages`` > 0, under the prefix cache
only) an evicted parked page is demoted into a
:class:`~.kv_tiers.TieredPageStore` under its chain digest before its
page is reclaimed, and a prefix match that misses on the device walks on
into the tier and promotes the pages it finds into fresh device pages,
indexed again.
"""

from __future__ import annotations

import time
from collections import Counter
from typing import Dict, List, Optional, Set

import numpy as np
import torch

from ....telemetry import metrics as tm
from ....telemetry.flight_recorder import get_flight_recorder
from ....runtime.fault_injection import get_fault_injector
from ....telemetry.tracer import trace_span
from ....utils.comms_logging import serving_counters
from ..snapshot import SnapshotError
from .blocked_allocator import NULL_PAGE, KVAllocationError
from .kv_cache import (BlockedKVCache, KVCacheConfig, PageBlob,
                       blob_columns, concat_blobs)
from .kv_tiers import TieredPageStore
from .prefix_cache import PrefixCache
from .sequence import SequenceDescriptor


class StateManager:
    def __init__(self, kv_config: KVCacheConfig, device: torch.device,
                 max_tracked_sequences: int = 2048,
                 prefix_caching: bool = True,
                 tier_host_pages: int = 0,
                 tier_disk_pages: int = 0,
                 tier_dir: Optional[str] = None):
        self.kv_config = kv_config
        self.max_tracked_sequences = max_tracked_sequences
        self.kv_cache = BlockedKVCache(kv_config, device)
        self.prefix_cache: Optional[PrefixCache] = (
            PrefixCache(kv_config.page_size) if prefix_caching else None)
        # the tier is keyed by the prefix cache's digests: none without it
        self.tiers: Optional[TieredPageStore] = None
        if tier_host_pages > 0 and self.prefix_cache is not None:
            self.tiers = TieredPageStore(
                tier_host_pages, disk_pages=tier_disk_pages,
                disk_dir=tier_dir or None,
                bytes_per_page=kv_config.bytes_per_page)
        #: chain digests whose pages were fetched from a peer replica: a
        #: digest's FIRST local match counts as a "remote" tier hit
        self._remote_digests: Set[bytes] = set()
        self._seqs: Dict[int, SequenceDescriptor] = {}
        # host blobs of preempted sequences, which the page counts do not
        # see: a flush of a preempted sequence must release its blob
        self._offload_blobs = 0
        self._offload_bytes = 0
        #: host seconds demotion spent waiting for its page copies (the
        #: copies are queued on the stream that may still run a step)
        self.demote_wait_s = 0.0

    def close(self) -> None:
        """Release the tier (its disk files and owned directory)."""
        if self.tiers is not None:
            self.tiers.close()

    @property
    def offloaded_blobs(self) -> int:
        """Sequences holding an offloaded host blob."""
        return self._offload_blobs

    @property
    def offloaded_blob_bytes(self) -> int:
        """Host bytes those blobs hold."""
        return self._offload_bytes

    @property
    def n_tracked_sequences(self) -> int:
        return len(self._seqs)

    @property
    def free_pages(self) -> int:
        """Schedulable pages: the free list plus cache-parked pages
        (reclaimed on demand by ``ensure_free``)."""
        free = self.kv_cache.free_pages
        if self.prefix_cache is not None:
            free += self.kv_cache.allocator.parked_pages
        return free

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

    # -- shared-page-aware release ------------------------------------------
    def _release_pages(self, pages: List[int]) -> None:
        """Drop one table reference from each page.  A page whose last
        sharer left is PARKED while the prefix cache indexes it and goes
        back to the free list otherwise."""
        if not pages:
            return
        alloc = self.kv_cache.allocator
        zeroed = alloc.decref(pages)
        if not zeroed:
            return
        if self.prefix_cache is None:
            alloc.reclaim(zeroed)
            return
        reclaim = []
        for p in zeroed:
            if self.prefix_cache.contains_page(p):
                self.prefix_cache.touch_page(p)  # in use until now
            else:
                reclaim.append(p)
        if reclaim:
            alloc.reclaim(reclaim)

    def ensure_free(self, num_pages: int) -> None:
        """Make the free list hold ``num_pages`` by LRU-evicting parked
        prefix-cache pages if needed; with a tier the evicted pages are
        demoted into it first (read while still allocated)."""
        alloc = self.kv_cache.allocator
        deficit = num_pages - alloc.free_pages
        if deficit <= 0 or self.prefix_cache is None:
            return
        with trace_span("kv.evict"):
            entries = self.prefix_cache.evict_entries(deficit,
                                                      alloc.is_parked)
            if not entries:
                return
            if self.tiers is not None:
                self._demote(entries)
            alloc.reclaim([p for _, p in entries])
            serving_counters.record_prefix_evicted(len(entries))
            get_flight_recorder().record("kv.evict", pages=len(entries))

    def _demote(self, entries) -> None:
        """Store the evicted pages' contents in the tier under their
        chain digests.  The copies are queued on the current stream
        (behind a step that may still be running): the host waits for
        them before the tier holds the blob.  A refused put only loses
        that page's warmth; the eviction goes on."""
        with trace_span("kv.demote"):
            blob = self.kv_cache.read_pages([p for _, p in entries])
            dev = self.kv_cache._stores()[0].device
            if dev.type == "cuda":
                t = time.perf_counter()
                torch.cuda.current_stream(dev).synchronize()
                self.demote_wait_s += time.perf_counter() - t
            stored = sum(self.tiers.put(digest, blob_columns(blob, [i]))
                         for i, (digest, _page) in enumerate(entries))
            if stored:
                get_flight_recorder().record("kv.demote", pages=stored)

    # -- prefix cache -------------------------------------------------------
    def match_prefix(self, sd: SequenceDescriptor,
                     prompt: np.ndarray) -> int:
        """Attach the longest cached prefix of ``prompt`` to a FRESH
        sequence: full pages only, leaving at least one suffix token to
        prefill (the step needs last-token logits).  Registers the prompt
        for indexing either way.  Returns the tokens attached."""
        if self.prefix_cache is None or sd.seen_tokens or sd.pages \
                or sd.host_blob is not None:
            return 0  # a started sequence keeps its registration
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        sd.prompt_tokens = prompt
        page = self.kv_config.page_size
        max_pages = (len(prompt) - 1) // page
        if max_pages <= 0:
            return 0
        with trace_span("kv.match_prefix"):
            pages, digest = self.prefix_cache.match(prompt, max_pages)
        hits = {"device": 0, "host": 0, "disk": 0, "remote": 0}
        if pages:
            # attach the device hits first: live references keep them
            # from being evicted while a promotion frees its pages
            self.kv_cache.allocator.add_ref(pages)
            self._attribute_device_hits(prompt, len(pages), hits)
        promoted: List[int] = []
        if self.tiers is not None and len(pages) < max_pages:
            promoted, digest = self._promote_chain(
                prompt, len(pages), digest, max_pages, hits)
        pages = [int(p) for p in pages] + promoted
        if not pages:
            return 0
        sd.pages = pages
        sd.seen_tokens = len(pages) * page
        sd.indexed_pages = len(pages)
        sd.last_digest = digest
        sd.tier_hits = hits
        return sd.seen_tokens

    def _attribute_device_hits(self, prompt: np.ndarray, n_pages: int,
                               hits: dict) -> None:
        """Split a device match into device-born and remote-born tokens:
        a page fetched from a peer counts as "remote" at its digest's
        FIRST match, and as a device page after that."""
        page = self.kv_config.page_size
        if not self._remote_digests:
            hits["device"] = n_pages * page
            return
        d = b""
        for i in range(n_pages):
            d = self.prefix_cache.chain(d, prompt[i * page:(i + 1) * page])
            if d in self._remote_digests:
                self._remote_digests.discard(d)
                hits["remote"] += page
            else:
                hits["device"] += page

    def _promote_chain(self, prompt: np.ndarray, n_matched: int,
                       digest: bytes, max_pages: int, hits: dict) -> tuple:
        """Extend a device match past its first miss along the same
        digest chain into the tier: the blobs found are restored into
        fresh device pages (refcount 1: this sequence's) and indexed
        again, so the next request with the prefix hits on the device.
        Returns (promoted page ids, the chain cursor); a miss or a
        failure ends the walk early (a shorter warm prefix)."""
        page = self.kv_config.page_size
        chain: List[bytes] = []
        d = digest
        for i in range(n_matched, max_pages):
            d = self.prefix_cache.chain(d, prompt[i * page:(i + 1) * page])
            if self.tiers.contains(d) is None:
                break
            chain.append(d)
        if not chain:
            return [], digest
        t0 = time.perf_counter()
        with trace_span("kv.promote"):
            blobs, hit_tiers = self.tiers.take_many(chain)
            if not blobs:
                return [], digest
            try:
                self.ensure_free(len(blobs))
                new_pages = self.kv_cache.restore_pages(
                    concat_blobs(blobs))
            except KVAllocationError:
                # the pool is full of live pages: the promotion is lost
                # (the blobs already left the tier), a miss and no error
                self.tiers.landed(len(blobs))
                return [], digest
            self.tiers.landed(len(blobs))
            for cd, p in zip(chain, new_pages):
                self.prefix_cache.insert(cd, int(p))
            for t in hit_tiers:
                hits[t] += page
            tm.KV_TIER_PROMOTE_MS.observe(
                (time.perf_counter() - t0) * 1000.0)
            get_flight_recorder().record(
                "kv.promote", pages=len(blobs),
                host=hit_tiers.count("host"), disk=hit_tiers.count("disk"))
        return [int(p) for p in new_pages], chain[len(blobs) - 1]

    def index_prefix(self, sd: SequenceDescriptor) -> None:
        """Index the newly committed FULL prompt pages (after each
        commit).  Pages past the prompt are never indexed, so the page a
        chained decode step writes past a stop token is never a cache
        page."""
        if self.prefix_cache is None or sd.prompt_tokens is None:
            return
        page = self.kv_config.page_size
        full = min(sd.seen_tokens, len(sd.prompt_tokens)) // page
        if full <= sd.indexed_pages:
            return
        with trace_span("kv.index_prefix"):
            for i in range(sd.indexed_pages, full):
                digest = self.prefix_cache.chain(
                    sd.last_digest,
                    sd.prompt_tokens[i * page:(i + 1) * page])
                p = sd.pages[i] if i < len(sd.pages) else NULL_PAGE
                # a window-evicted slot has no page; a prefix prefilled
                # again supersedes its demoted copy (never device-indexed
                # and in the tier at once)
                if p != NULL_PAGE and self.prefix_cache.insert(
                        digest, int(p)) and self.tiers is not None:
                    self.tiers.discard(digest)
                sd.last_digest = digest
                sd.indexed_pages = i + 1

    def export_digests(self, top_k: int = 64) -> List[str]:
        """The prefix cache's bounded affinity hint: up to ``top_k`` most
        recently used cumulative digests as hex, most recent first;
        empty with caching off."""
        if self.prefix_cache is None:
            return []
        return self.prefix_cache.export_digests(top_k)

    def reset_prefix_cache(self) -> None:
        """Drop the whole index and reclaim its parked pages (a cold
        start; live sequences' pages free at their flush)."""
        if self.prefix_cache is None:
            return
        alloc = self.kv_cache.allocator
        parked = [p for p in self.prefix_cache.clear() if alloc.is_parked(p)]
        if parked:
            alloc.reclaim(parked)
        if self.tiers is not None:
            self.tiers.clear()      # a cold start is cold in every tier

    # -- lifecycle ----------------------------------------------------------
    def offloadable_slots(self, sd: SequenceDescriptor) -> List[int]:
        """Table slots an offload would move to the host: non-null and
        held by this sequence alone (refcount 1).  Shared pages stay
        resident; the scheduler ranks preemption victims by this count,
        so a victim whose pages are all shared is never picked."""
        alloc = self.kv_cache.allocator
        return [i for i, p in enumerate(sd.pages)
                if p != NULL_PAGE and alloc.ref_count(p) == 1]

    def _release_blob(self, sd: SequenceDescriptor) -> None:
        self._offload_blobs -= 1
        self._offload_bytes -= sd.host_blob.nbytes
        sd.host_blob = None
        sd.live_slots = []

    def flush_sequence(self, uid: int) -> None:
        sd = self._seqs.pop(uid, None)
        if sd is not None:
            with trace_span("kv.flush"):
                # window eviction leaves null slots: not this sequence's
                # pages
                self._release_pages([p for p in sd.pages if p != NULL_PAGE])
                if sd.host_blob is not None:
                    # a request that ends while preempted releases its
                    # blob
                    self._release_blob(sd)

    def offload_sequence(self, uid: int) -> None:
        """Preempt: move a sequence's private live pages to a host blob
        and free them.  Shared pages stay resident (freeing them would
        take KV from under the sharers); private pages the prefix cache
        indexes are unindexed and offloaded, and the sequence stops
        indexing (its digest chain now passes through unindexed pages,
        so any later entry could never be matched).  The sequence stays
        tracked and is not schedulable until ``restore_sequence``."""
        sd = self._seqs.get(uid)
        if sd is None or sd.host_blob is not None:
            return
        with trace_span("kv.offload"):
            self._offload_impl(sd)

    def _offload_impl(self, sd: SequenceDescriptor) -> None:
        sd.live_slots = self.offloadable_slots(sd)
        live = [sd.pages[i] for i in sd.live_slots]
        if not live:
            return
        if self.prefix_cache is not None:
            dropped = [p for p in live if self.prefix_cache.contains_page(p)]
            if dropped:
                self.prefix_cache.drop_pages(dropped)
                sd.prompt_tokens = None
        sd.host_blob = self.kv_cache.offload_pages(live)
        self._offload_blobs += 1
        self._offload_bytes += sd.host_blob.nbytes
        for i in sd.live_slots:
            sd.pages[i] = NULL_PAGE

    def restore_sequence(self, uid: int) -> None:
        """Bring a preempted sequence's pages back to the device, into
        fresh pages at their old table slots.  Raises
        ``KVAllocationError`` when the pool lacks the pages."""
        sd = self._seqs.get(uid)
        if sd is None or sd.host_blob is None:
            return
        with trace_span("kv.restore"):
            self.ensure_free(int(sd.host_blob.shape[1]))
            pages = self.kv_cache.restore_pages(sd.host_blob)
            for slot, p in zip(sd.live_slots, pages):
                sd.pages[slot] = int(p)
            self._release_blob(sd)

    def evict_window(self, sd: SequenceDescriptor, window: int) -> int:
        """Release every page wholly below ``seen_tokens - window + 1``,
        the earliest position a later query can attend.  A shared page
        only loses this sequence's reference (its sharers and the prefix
        cache keep it).  Returns the number of slots cleared."""
        min_attended = sd.seen_tokens - window + 1
        if min_attended <= 0:
            return 0
        freed = sd.evict_pages_below(min_attended // self.kv_config.page_size)
        if freed:
            self._release_pages(freed)
        return len(freed)

    def pages_needed(self, sd: SequenceDescriptor, n_new_tokens: int) -> int:
        """Extra pages required to hold ``n_new_tokens`` more tokens."""
        page = self.kv_config.page_size
        need = -(-(sd.seen_tokens + n_new_tokens) // page)  # ceil
        return max(0, need - sd.allocated_capacity)

    def allocate_for(self, sd: SequenceDescriptor, n_new_tokens: int) -> None:
        """Reserve the pages ``n_new_tokens`` more tokens need, evicting
        parked prefix pages first; the ``kv.alloc_oom`` fault site raises
        ``KVAllocationError`` here, as a starved allocator does."""
        extra = self.pages_needed(sd, n_new_tokens)
        if extra:
            get_fault_injector().maybe_raise(
                "kv.alloc_oom", KVAllocationError,
                f"injected KV allocator OOM ({extra} pages requested)")
            self.ensure_free(extra)
            sd.extend_pages(self.kv_cache.reserve(extra))

    # -- snapshot export / import -------------------------------------------
    def export_state(self, seq_ids: Optional[List[int]] = None) -> tuple:
        """Every tracked sequence, the prefix index and the contents of
        every page they reference (each page once: sharing and refcounts
        are rebuilt from the block tables on import), as ``(meta,
        arrays)`` with the JAX package's meta keys and array names.
        Needs drained state (no tokens in flight).

        With ``seq_ids`` (the disaggregated handoff) the export is
        selective: only those sequences, only the pages their tables
        reference, and only the prefix entries bound to those pages (the
        digests let the importer attach pages it already holds instead
        of streaming them); no parked page rides along, and the meta is
        marked ``selective`` so ``import_state`` merges it."""
        if seq_ids is not None:
            missing = [u for u in seq_ids if int(u) not in self._seqs]
            if missing:
                raise SnapshotError(
                    f"selective export of untracked sequences {missing}")
            export_seqs = {int(u): self._seqs[int(u)] for u in seq_ids}
        else:
            export_seqs = self._seqs
        page_order: List[int] = []
        seen = set()
        for sd in export_seqs.values():
            if sd.in_flight_tokens:
                raise SnapshotError(
                    f"sequence {sd.uid} has {sd.in_flight_tokens} in-flight "
                    "tokens: drain the step before export")
            for p in sd.pages:
                if p != NULL_PAGE and p not in seen:
                    seen.add(p)
                    page_order.append(int(p))
        prefix_entries = []
        if self.prefix_cache is not None and seq_ids is None:
            prefix_entries = self.prefix_cache.export_entries()
            for _, p in prefix_entries:
                if p not in seen:           # a parked (cache-kept) page
                    seen.add(p)
                    page_order.append(int(p))
        elif self.prefix_cache is not None:
            # selective: the entries of the pages the bundle carries
            prefix_entries = [(d, p) for d, p
                              in self.prefix_cache.export_entries()
                              if p in seen]
        arrays: Dict[str, object] = {}
        if page_order:
            self._pack_blob(arrays, "page_blob",
                            self._read_pages_sync(page_order))
        seqs = []
        for uid, sd in export_seqs.items():
            seqs.append({"uid": int(uid), "seen_tokens": int(sd.seen_tokens),
                         "pages": [int(p) for p in sd.pages],
                         "live_slots": [int(i) for i in sd.live_slots],
                         "indexed_pages": int(sd.indexed_pages),
                         "last_digest": sd.last_digest.hex(),
                         "has_prompt": sd.prompt_tokens is not None,
                         "has_blob": sd.host_blob is not None})
            if sd.prompt_tokens is not None:
                arrays[f"prompt_{uid}"] = np.asarray(sd.prompt_tokens,
                                                     np.int32)
            if sd.host_blob is not None:
                self._pack_blob(arrays, f"hostblob_{uid}", sd.host_blob)
        meta = {"kv": self._kv_meta(),
                "prefix_caching": self.prefix_cache is not None,
                "page_ids": page_order,
                "sequences": seqs,
                "prefix": [[d.hex(), int(p)] for d, p in prefix_entries]}
        if seq_ids is not None:
            meta["selective"] = True
        return meta, arrays

    def _read_pages_sync(self, pages: List[int]):
        """``read_pages`` waited for: on the card its copies into pinned
        memory are queued on the current stream."""
        blob = self.kv_cache.read_pages(pages)
        dev = self.kv_cache._stores()[0].device
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        return blob

    def _kv_meta(self) -> dict:
        cfg = self.kv_config
        return {"num_layers": cfg.num_layers, "kv_heads": cfg.kv_heads,
                "head_dim": cfg.head_dim, "page_size": cfg.page_size,
                "dtype": str(cfg.dtype).replace("torch.", ""),
                "quantization": cfg.quantization}

    def _check_kv_meta(self, meta: dict) -> None:
        kv = dict(meta["kv"])
        kv.setdefault("quantization", "none")  # bundles from before int8
        ours = self._kv_meta()
        if kv != ours:
            raise SnapshotError(
                f"KV geometry mismatch: bundle {kv} vs engine {ours}")

    @staticmethod
    def _pack_blob(arrays: dict, key: str, blob) -> None:
        """A page blob under ``key``; an int8 :class:`PageBlob` as its
        codes and ``key + "_scale"``."""
        if isinstance(blob, PageBlob):
            arrays[key] = blob.payload
            arrays[key + "_scale"] = blob.scale
        else:
            arrays[key] = blob

    @staticmethod
    def _unpack_blob(arrays: dict, key: str):
        """Inverse of ``_pack_blob`` as host tensors; None when ``key`` is
        absent."""
        payload = arrays.get(key)
        if payload is None:
            return None
        payload = torch.as_tensor(payload)
        scale = arrays.get(key + "_scale")
        if scale is not None:
            return PageBlob(payload, torch.as_tensor(scale))
        return payload

    def import_state(self, meta: dict, arrays: dict) -> Optional[dict]:
        """Rebuild exported state in this empty manager: fresh pages are
        reserved and written from the blob, the block tables remapped
        onto them with their refcounts (shared pages shared again, pages
        only the cache kept parked again), host blobs attached to their
        preempted sequences, and the prefix index rebuilt in its LRU
        order.  :class:`SnapshotError` on a geometry or prefix-caching
        mismatch, a manager that is not empty, a pool too small or an
        inconsistent bundle.

        A ``selective`` bundle instead MERGES into this possibly busy
        manager (``_import_selective``) and returns ``{"pages_streamed",
        "pages_shared"}``."""
        if meta.get("selective"):
            return self._import_selective(meta, arrays)
        alloc = self.kv_cache.allocator
        if self._seqs or alloc.live_pages or alloc.parked_pages:
            raise SnapshotError(
                "import_state needs an empty state manager "
                f"({len(self._seqs)} tracked sequences, {alloc.live_pages} "
                f"live / {alloc.parked_pages} parked pages)")
        self._check_kv_meta(meta)
        if bool(meta.get("prefix_caching")) != (self.prefix_cache
                                                is not None):
            raise SnapshotError(
                "prefix_caching differs between the bundle and the engine: "
                "restore with the same serving config")
        old_ids = [int(p) for p in meta["page_ids"]]
        if len(old_ids) > alloc.free_pages:
            raise SnapshotError(f"bundle needs {len(old_ids)} KV pages, the "
                                f"pool has {alloc.free_pages} free")
        mapping = {NULL_PAGE: NULL_PAGE}
        if old_ids:
            blob = self._unpack_blob(arrays, "page_blob")
            if blob is None or blob.shape[1] != len(old_ids):
                raise SnapshotError(
                    "page blob missing or inconsistent with page_ids")
            new = self.kv_cache.restore_pages(blob)     # refcount 1 each
            mapping.update((o, int(n)) for o, n in zip(old_ids, new))
        # the block tables give the true refcounts (0: parked)
        refs = Counter(int(p) for m in meta["sequences"] for p in m["pages"]
                       if p != NULL_PAGE)
        for old in old_ids:
            n, newp = refs.get(old, 0), mapping[old]
            if n == 0:
                alloc.decref([newp])        # parked; indexed again below
            elif n > 1:
                alloc.add_ref([newp] * (n - 1))
        for m in meta["sequences"]:
            uid = int(m["uid"])
            try:
                pages = [mapping[int(p)] for p in m["pages"]]
            except KeyError as e:
                raise SnapshotError(
                    f"sequence {uid} references unexported page {e}")
            sd = SequenceDescriptor(
                uid=uid, seen_tokens=int(m["seen_tokens"]), pages=pages,
                live_slots=[int(i) for i in m["live_slots"]],
                indexed_pages=int(m["indexed_pages"]),
                last_digest=bytes.fromhex(m["last_digest"]))
            if m["has_prompt"]:
                sd.prompt_tokens = np.asarray(arrays[f"prompt_{uid}"],
                                              np.int32)
            if m["has_blob"]:
                sd.host_blob = self._unpack_blob(arrays, f"hostblob_{uid}")
                if sd.host_blob is None:
                    raise SnapshotError(f"sequence {uid}'s host blob is "
                                        "missing from the bundle")
                self._offload_blobs += 1
                self._offload_bytes += sd.host_blob.nbytes
            self._seqs[uid] = sd
        if self.prefix_cache is not None:
            for d_hex, p in meta["prefix"]:
                newp = mapping.get(int(p))
                if newp is None:
                    raise SnapshotError(
                        f"prefix index references unexported page {p}")
                self.prefix_cache.insert(bytes.fromhex(d_hex), newp)
        return None

    def _import_selective(self, meta: dict, arrays: dict) -> dict:
        """Merge one selective (handoff) bundle into this possibly busy
        manager.  A refused import mutates nothing: (1) validate the uids
        and the geometry and map each exported page either onto a local
        page whose chain digest this cache already indexes (attached by
        reference) or onto the streamed set, (2) check the streamed
        pages against the schedulable pages (``KVAllocationError``,
        retryable), (3) attach the shared pages, evict for and write the
        streamed ones, (4) rebuild the descriptors and host blobs and
        index the digests, so the next handoff of this prefix shares
        too."""
        self._check_kv_meta(meta)
        alloc = self.kv_cache.allocator
        for m in meta["sequences"]:
            if int(m["uid"]) in self._seqs:
                raise SnapshotError(
                    f"selective import: uid {m['uid']} already tracked")
        if (len(self._seqs) + len(meta["sequences"])
                > self.max_tracked_sequences):
            # backpressure: the pool frees tracked slots as requests end
            raise KVAllocationError(
                f"handoff import would track "
                f"{len(self._seqs) + len(meta['sequences'])} sequences "
                f"(limit {self.max_tracked_sequences}); retry after the "
                "pool drains")
        old_ids = [int(p) for p in meta["page_ids"]]
        blob = self._unpack_blob(arrays, "page_blob")
        if old_ids and (blob is None or blob.shape[1] != len(old_ids)):
            raise SnapshotError(
                "page blob missing or inconsistent with page_ids")
        # a full prefix page whose chained digest this cache indexes holds
        # the same KV (same tokens, same weights): attach the local page
        digest_of = {int(p): bytes.fromhex(d) for d, p in meta["prefix"]}
        mapping = {NULL_PAGE: NULL_PAGE}
        dedup: Dict[int, int] = {}
        stream: List[int] = []
        for old in old_ids:
            local = None
            d = digest_of.get(old)
            if d is not None and self.prefix_cache is not None:
                local = self.prefix_cache.lookup(d)
                if local is not None and not alloc.is_allocated(local):
                    local = None    # never attach a freed page
            if local is not None:
                dedup[old] = int(local)
                mapping[old] = int(local)
            else:
                stream.append(old)
        # parked pages about to be attached become live below, so they
        # cannot also be evicted to make room for the streamed pages
        parked_dedup = sum(1 for local in dedup.values()
                           if alloc.is_parked(local))
        available = alloc.free_pages + alloc.parked_pages - parked_dedup
        if len(stream) > available:
            raise KVAllocationError(
                f"handoff import needs {len(stream)} streamed pages, the "
                f"pool has {available} schedulable; retry after it drains")
        # the true refcounts: appearances in the imported block tables
        refs = Counter(int(p) for m in meta["sequences"] for p in m["pages"]
                       if p != NULL_PAGE)
        for old, local in dedup.items():
            n = refs.get(old, 0)
            if n:
                alloc.add_ref([local] * n)
        if stream:
            self.ensure_free(len(stream))
            # every page streams: the blob as it came (pinned when the
            # exporter was on the card), not a pageable copy of it
            col = {p: i for i, p in enumerate(old_ids)}
            sub = (blob if len(stream) == len(old_ids)
                   else blob_columns(blob, [col[p] for p in stream]))
            new = self.kv_cache.restore_pages(sub)     # refcount 1 each
            for old, newp in zip(stream, new):
                mapping[old] = int(newp)
                n = refs.get(old, 0)
                if n < 1:
                    raise SnapshotError(
                        f"selective bundle streams unreferenced page {old}")
                if n > 1:
                    alloc.add_ref([int(newp)] * (n - 1))
        for m in meta["sequences"]:
            uid = int(m["uid"])
            try:
                pages = [mapping[int(p)] for p in m["pages"]]
            except KeyError as e:
                raise SnapshotError(
                    f"sequence {uid} references unexported page {e}")
            sd = SequenceDescriptor(
                uid=uid, seen_tokens=int(m["seen_tokens"]), pages=pages,
                live_slots=[int(i) for i in m["live_slots"]],
                indexed_pages=int(m["indexed_pages"]),
                last_digest=bytes.fromhex(m["last_digest"]))
            if m["has_prompt"]:
                sd.prompt_tokens = np.asarray(arrays[f"prompt_{uid}"],
                                              np.int32)
            if m["has_blob"]:
                sd.host_blob = self._unpack_blob(arrays, f"hostblob_{uid}")
                if sd.host_blob is None:
                    raise SnapshotError(f"sequence {uid}'s host blob is "
                                        "missing from the bundle")
                self._offload_blobs += 1
                self._offload_bytes += sd.host_blob.nbytes
            self._seqs[uid] = sd
        if self.prefix_cache is not None:
            for d_hex, p in meta["prefix"]:
                newp = mapping.get(int(p))
                if newp is not None:
                    d = bytes.fromhex(d_hex)
                    if self.prefix_cache.insert(d, int(newp)) \
                            and self.tiers is not None:
                        self.tiers.discard(d)
        return {"pages_streamed": len(stream), "pages_shared": len(dedup)}

    # -- cross-replica page fetch --------------------------------------------
    # When the router's least-backlog placement loses an affinity match,
    # the chosen replica imports the matched prefix pages from the replica
    # holding them instead of prefilling them again.  Only (digest, page
    # contents) cross; the imported pages land parked and indexed, so the
    # request's admission matches them at once.

    def export_prefix(self, digests_hex: List[str],
                      max_pages: int = 64) -> Optional[tuple]:
        """The KV contents of the leading run of ``digests_hex`` (a
        request's cumulative chain, root first) that this prefix index
        holds, as ``(meta, arrays)`` in the handoff codec's layout (int8
        pages travel as codes and scales), or None on a cold index."""
        if self.prefix_cache is None or not digests_hex:
            return None
        alloc = self.kv_cache.allocator
        chain: List[tuple] = []
        for h in digests_hex[:max_pages]:
            try:
                d = bytes.fromhex(h)
            except ValueError:
                break
            p = self.prefix_cache.lookup(d)
            if p is None or not alloc.is_allocated(int(p)):
                break       # the chain is only usable contiguously
            chain.append((d, int(p)))
        if not chain:
            return None
        with trace_span("kv.export_prefix"):
            arrays: Dict[str, object] = {}
            self._pack_blob(arrays, "page_blob",
                            self._read_pages_sync([p for _, p in chain]))
            meta = {"kv": self._kv_meta(), "page_fetch": True,
                    "digests": [d.hex() for d, _ in chain]}
            return meta, arrays

    def import_prefix(self, meta: dict, arrays: dict) -> dict:
        """Merge a peer's exported prefix pages into this prefix cache as
        parked, indexed pages.  Digests already held (on the device or in
        the tier) are skipped; a pool without room raises the retryable
        ``KVAllocationError`` before any change.  Returns
        ``{"pages_imported", "pages_skipped"}``."""
        if self.prefix_cache is None:
            return {"pages_imported": 0, "pages_skipped": 0}
        self._check_kv_meta(meta)
        alloc = self.kv_cache.allocator
        blob = self._unpack_blob(arrays, "page_blob")
        digests = [bytes.fromhex(h) for h in meta.get("digests", [])]
        if digests and (blob is None or blob.shape[1] != len(digests)):
            raise SnapshotError(
                "page-fetch blob missing or inconsistent with digests")
        keep = [i for i, d in enumerate(digests)
                if self.prefix_cache.lookup(d) is None
                and not (self.tiers is not None and self.tiers.contains(d))]
        if not keep:
            return {"pages_imported": 0, "pages_skipped": len(digests)}
        if len(keep) > alloc.free_pages + alloc.parked_pages:
            raise KVAllocationError(
                f"page fetch needs {len(keep)} pages, the pool has "
                f"{alloc.free_pages + alloc.parked_pages} schedulable; "
                "retry after the pool drains")
        with trace_span("kv.import_prefix"):
            self.ensure_free(len(keep))
            new = self.kv_cache.restore_pages(
                blob if len(keep) == len(digests)
                else blob_columns(blob, keep))
            imported = 0
            for i, p in zip(keep, new):
                if self.prefix_cache.insert(digests[i], int(p)):
                    self._remote_digests.add(digests[i])
                    imported += 1
                # parks an indexed page, reclaims one the index refused
                self._release_pages([int(p)])
        return {"pages_imported": imported,
                "pages_skipped": len(digests) - imported}

    def check_invariants(self) -> None:
        """Page-accounting audit: every block-table reference is backed
        by exactly one allocator reference, ``free + live + parked ==
        total``, every parked page is still prefix-cache indexed, and
        the offloaded-blob counters match the tracked sequences.
        Raises RuntimeError on a violation (the scheduler runs it after
        every step under ``DS_KV_DEBUG=1``)."""
        alloc = self.kv_cache.allocator
        alloc.audit()
        refs = Counter(p for sd in self._seqs.values() for p in sd.pages
                       if p != NULL_PAGE)
        for p, n in refs.items():
            if not alloc.is_allocated(p):
                raise RuntimeError(
                    f"KV invariant: page {p} is in a block table but on "
                    "the free list")
            if alloc.ref_count(p) != n:
                raise RuntimeError(
                    f"KV invariant: page {p} has allocator refcount "
                    f"{alloc.ref_count(p)} but appears in {n} block "
                    "tables")
        live, parked = alloc.live_pages, alloc.parked_pages
        if live != len(refs):
            raise RuntimeError(
                f"KV invariant: allocator sees {live} live pages, block "
                f"tables reference {len(refs)}")
        if alloc.free_pages + live + parked != alloc.total_pages:
            raise RuntimeError(
                f"KV invariant: free({alloc.free_pages}) + live({live}) "
                f"+ cached({parked}) != total({alloc.total_pages})")
        blobs = [sd.host_blob for sd in self._seqs.values()
                 if sd.host_blob is not None]
        blob_bytes = sum(b.nbytes for b in blobs)
        if (len(blobs), blob_bytes) != (self._offload_blobs,
                                        self._offload_bytes):
            raise RuntimeError(
                f"KV invariant: the offload counters say "
                f"{self._offload_blobs} blobs / {self._offload_bytes} "
                f"bytes, the sequences hold {len(blobs)} / {blob_bytes}")
        if parked:
            if self.prefix_cache is None:
                raise RuntimeError(
                    f"KV invariant: {parked} parked pages with prefix "
                    "caching off")
            indexed = set(self.prefix_cache.pages())
            for p in alloc.parked_page_ids():
                if int(p) not in indexed:
                    raise RuntimeError(
                        f"KV invariant: parked page {int(p)} is not "
                        "prefix-cache indexed (leaked)")
        if self.tiers is not None:
            # a digest demotes only at eviction and promotes only on a
            # device miss: never both device-indexed and tier-resident
            self.tiers.check_invariants()
            for d, _ in self.prefix_cache.export_entries():
                if self.tiers.contains(d) is not None:
                    raise RuntimeError(
                        "KV invariant: digest indexed on device AND "
                        f"tier-resident (double-held prefix {d.hex()})")
