"""InferenceEngineV2 — ragged continuous-batching inference engine.

Counterpart of ``deepspeed_tpu/inference/v2/engine.py``:
``put(uids, tokens)`` runs one ragged forward returning last-token
logits per sequence (with ``fused=False`` one forward per Q bucket, the
split escape hatch); ``step_sample`` runs forward + on-device
sampling, so only int32 tokens cross device->host; ``step_decode_chained``
gathers its input tokens on the device from the previous step's, so the
scheduler's async chain never waits on the host; ``query`` /
``can_schedule`` expose KV and token occupancy to the scheduler;
``match_prefix`` attaches a new sequence's cached prompt pages;
``flush(uid)`` frees sequence state; ``offload_sequence`` /
``restore_sequence`` move a preempted sequence's KV to host memory and
back.  Speculative decoding: ``step_spec`` verifies host-drafted tokens
and returns the [S, 2] int32 verdict, ``step_draft_spec`` runs a draft
trunk's loop and the verify in one step ([S, 2+k]), ``step_draft_fill``
catches the draft trunk's KV pool up, and ``commit_spec`` advances each
row by the tokens it committed.  After every forward the engine indexes
newly full prompt pages and, for a sliding-window model, releases the
pages the window has left behind.  A step mixing decode rows with
prefill chunks runs as two segments ([S_d, 1] + [S_p, Q]) so decode
rows never pad to the chunk width.  Each step key is one CUDA graph on
the card (``model.py``); ``precompile`` captures a lattice of them
before serving.  The engine builds the KV cache: fp pages, or int8
``KVPages`` when ``serving.kv_quantization`` says so; for a model built
without ``kv_config`` its geometry comes from ``config.kv_cache``, and
``num_pages=None`` sizes the pool from free device memory.  With
``serving.keyed_sampling`` (fixed at build) every sampling step takes
each row's request uid and generation position (``row_pos``) and the
scheduler's base key, and draws each sampled row from its own key.
``serving.lattice = "auto:<artifact-or-trace>"`` (fixed at build) buckets
every batch to a mined lattice's tops, and ``precompile`` captures that
lattice's keys; ``serving.kv_tier_host_pages`` / ``kv_tier_disk_pages``
give the prefix cache a host and disk tier (``ragged/kv_tiers.py``);
``serving.compile_cache_dir`` (or ``DS_COMPILE_CACHE``) is where the
kernel libraries are built and loaded (``compile_cache.py``).  For the
serving fleet (``serving/``): ``export_digests`` is a replica's prefix
affinity hint, ``export_prefix`` / ``import_prefix`` move a digest
chain's pages between two engines, and ``precompile(kinds=...)`` shrinks
the lattice to a disaggregated role's keys.  With
``quantization.enabled`` the engine quantises the model's projection
weights into ``quantization.fmt`` before it sizes the KV pool.

Telemetry, as in the JAX engine: every dispatch advances the
``ds_serving_*`` counters (``utils/comms_logging.serving_counters``: one
program, the host-to-device bytes of its batch arrays, the logits bytes
``put`` hands back, the prefix lookups); the build applies the config's
``telemetry`` and ``fault_injection`` blocks, points the ``ds_kv_*``
gauges at this engine, registers its subsystems with the memory ledger
(weights, ``kv_pages``, ``draft_kv``, ``tier_host``, ``tier_disk``,
``offload``) and binds ``ds_mem_headroom_seqs`` (:meth:`headroom`), and
publishes :meth:`export_digests` on the metrics endpoint's
``/snapshot?digests=1``.  The newest engine of a process owns these
bindings, through weakrefs.
"""

from __future__ import annotations

import dataclasses
import enum
import hashlib
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ...telemetry import metrics as tm
from ...telemetry.flight_recorder import get_flight_recorder
from ...telemetry.tracer import trace_span
from .compile_cache import cache_dir_from_env_or_config, enable_compile_cache
from .config import RaggedInferenceEngineConfig
from .lattice import enumerate_lattice_keys, resolve_lattice
from .model import RaggedInferenceModel
from ...tree import tree_leaves, tree_map
from ...utils.comms_logging import serving_counters
from .ragged import (KVCacheConfig, RaggedBatch, StateManager, build_batch,
                     placeholder)
from .ragged.batch import MIN_PAGES, MIN_SLOTS, _bucket
from .ragged.kv_cache import pages_for_memory
from .sampling import SamplingParams


class SchedulingResult(enum.Enum):
    Success = 0
    EngineSequenceLimitExceeded = 1
    BatchSequenceLimitExceeded = 2
    BatchTokenLimitExceeded = 3
    KVCacheLimitExceeded = 4


class SchedulingError(RuntimeError):
    def __init__(self, result: SchedulingResult):
        super().__init__(f"cannot schedule batch: {result.name}")
        self.result = result


#: key classes ``lattice_keys(kinds=...)`` filters on: "prefill" = Q>1
#: logits/sample keys (fresh variants included), "decode" = Q==1
#: logits/sample keys, "chain" = the chained decode family, "spec" = the
#: speculative families (spec, draft_spec and draft_fill)
LATTICE_KINDS = ("prefill", "decode", "chain", "spec")


def _validate_kinds(kinds: Sequence[str]) -> None:
    unknown = set(kinds) - set(LATTICE_KINDS)
    if unknown:
        raise ValueError(
            f"unknown lattice kinds {sorted(unknown)} "
            f"(expected a subset of {LATTICE_KINDS})")


def lattice_kind_of(key: Tuple) -> str:
    """Which :data:`LATTICE_KINDS` class one step key belongs to."""
    kind = key[4] if len(key) > 4 else "logits"
    if kind == "chain":
        return "chain"
    if kind in ("spec", "draft_spec", "draft_fill"):
        return "spec"
    if kind == "mixed":
        return "prefill"  # a mixed key carries a prefill segment
    return "prefill" if key[1] > 1 else "decode"


def lattice_keys(max_prompt: int, max_new_tokens: int,
                 max_concurrency: int, page_size: int,
                 max_ragged_batch_size: int, has_fresh: bool,
                 sampling: bool, spec_max_draft: int = 0,
                 kinds: Optional[Sequence[str]] = None,
                 draft: bool = False) -> List[Tuple]:
    """Every step key of the power-of-two bucket lattice for this
    geometry: S over slot buckets up to ``max_concurrency``, Q over {1}
    and the prompt buckets up to ``max_prompt``, P over the page buckets
    up to ``max_prompt + max_new_tokens`` tokens; ``spec_max_draft`` > 0
    adds the spec keys at Q = the bucket of ``1 + spec_max_draft``, and
    ``draft`` the model-drafted twins.  ``kinds`` keeps a subset of
    :data:`LATTICE_KINDS`.  The key families are
    ``lattice.enumerate_lattice_keys``'s."""
    if kinds is not None:
        _validate_kinds(kinds)
    s_vals, q_vals, p_vals = [], [1], []
    s = _bucket(1, MIN_SLOTS)
    while s <= _bucket(max_concurrency, MIN_SLOTS):
        s_vals.append(s)
        s *= 2
    q = 2
    while q <= _bucket(max_prompt):
        q_vals.append(q)
        q *= 2
    total = max_prompt + max_new_tokens  # decode growth headroom
    max_pages_needed = _bucket(-(-total // page_size), MIN_PAGES)
    p = _bucket(1, MIN_PAGES)
    while p <= max_pages_needed:
        p_vals.append(p)
        p *= 2
    keys = enumerate_lattice_keys(
        s_vals, q_vals, p_vals, page_size=page_size,
        max_ragged_batch_size=max_ragged_batch_size,
        has_fresh=has_fresh, sampling=sampling,
        spec_q=_bucket(1 + spec_max_draft) if spec_max_draft > 0 else 0,
        draft=draft)
    if kinds is not None:
        keys = [k for k in keys if lattice_kind_of(k) in set(kinds)]
    return keys


class InferenceEngineV2:
    def __init__(self, model: RaggedInferenceModel,
                 config: Optional[RaggedInferenceEngineConfig] = None):
        self._config = config or RaggedInferenceEngineConfig()
        sv = self._config.serving
        sv.validate()
        self._model = model
        drafter = sv.spec_drafter or "ngram"
        if drafter not in ("ngram", "model", "auto"):
            raise ValueError(
                f"serving.spec_drafter={drafter!r} is not a drafter: choose "
                "'ngram' (prompt lookup), 'model' (a draft trunk drafting "
                "on the device) or 'auto' (chosen per request)")
        #: model-drafted speculation: a draft trunk and its own KV pool
        self._draft_enabled = bool(sv.speculative) and drafter != "ngram"
        L = model.cfg.num_layers
        want = int(sv.spec_draft_layers or 0)
        self._draft_layers = ((min(want, L) if want > 0 else L)
                              if self._draft_enabled else 0)
        if self._config.quantization.enabled:
            # weight-only quantisation before the KV pool is sized, so
            # the freed bytes become pages (rewrites model.params in
            # place; a no-op when the model already has this format)
            model.quantize_weights(self._config.quantization.fmt)
        model.kv_config = self._resolve_kv_config(model)
        # keyed sampling changes the inputs of every sampling step, so it
        # is fixed here, before any capture; graphs captured for an
        # earlier engine wrote that engine's cache (and may have been
        # captured in the other sampling mode)
        model.keyed_sampling = bool(sv.keyed_sampling)
        model.reset_steps()
        self._build_draft(model)
        # the mined bucket lattice: fixed at build (it shapes every step
        # key), its geometry digest checked against this engine's
        self._lattice = resolve_lattice(
            sv.lattice or "", page_size=model.kv_config.page_size,
            vocab_size=int(model.cfg.vocab_size),
            max_ragged_batch_size=(
                self._config.state_manager.max_ragged_batch_size))
        prior = model.lattice
        if getattr(model, "_lattice_bound", False) and (
                (prior.digest if prior is not None else None)
                != (self._lattice.digest if self._lattice is not None
                    else None)):
            # the mixed step's pad reads the model's lattice: engines over
            # one model with other lattices would bucket against it
            warnings.warn(
                "engine build rebinds model.lattice ("
                f"{prior.digest if prior is not None else '<power>'} -> "
                f"{self._lattice.digest if self._lattice else '<power>'}):"
                " the mixed step's pad follows the newest engine's lattice;"
                " engines sharing one model must share one lattice config")
        model.lattice = self._lattice
        model._lattice_bound = True
        # where the kernel libraries are built and loaded
        cache_dir = cache_dir_from_env_or_config(sv.compile_cache_dir or "")
        self._compile_cache_dir = (enable_compile_cache(cache_dir)
                                   if cache_dir else None)
        self._state = StateManager(
            model.kv_config, model.device,
            max_tracked_sequences=(
                self._config.state_manager.max_tracked_sequences),
            prefix_caching=sv.prefix_caching,
            tier_host_pages=int(sv.kv_tier_host_pages or 0),
            tier_disk_pages=int(sv.kv_tier_disk_pages or 0),
            tier_dir=sv.kv_tier_dir or None)
        self._config.telemetry.apply()
        self._config.fault_injection.apply()
        self._bind_kv_gauges()
        self._pages_dist_cache = None
        recorder = get_flight_recorder()
        recorder.set_config("inference_v2", self._config)
        recorder.record("engine.build", engine="fastgen",
                        kv_pages=model.kv_config.num_pages,
                        page_size=model.kv_config.page_size)
        # the draft pool: unquantised, at the cache dtype, addressed by the
        # target's page ids and tables (allocation and rollback ride the
        # target's allocator; a rejected draft's slots are written again
        # before they are read).  Draft pages are never prefix-indexed,
        # so a shared prefix page's draft KV may be stale: that lowers
        # the accept rate until the catch-up fill, never a token
        self._draft_kv: Optional[torch.Tensor] = None
        #: uid -> committed tokens the draft pool covers
        self._draft_seen: Dict[int, int] = {}
        if self._draft_enabled:
            kv = model.kv_config
            self._draft_kv = torch.zeros(
                (self._draft_layers, kv.num_pages + 1, kv.page_size, 2,
                 kv.kv_heads, kv.head_dim), dtype=kv.dtype,
                device=model.device)
        self._bind_memory_accountants()
        self._bind_digest_source()

    def _bind_digest_source(self) -> None:
        """Publish this engine's prefix-cache affinity hint on the process
        metrics endpoint (``/snapshot?digests=1``), so a router scrapes a
        replica process's hints like any other replica fact.  Weakref
        bound, newest engine wins (the ``ds_kv_*`` gauge rule)."""
        import weakref
        from ...telemetry import server as tserver
        ref = weakref.ref(self)

        def _digests(top_k: int, r=ref) -> dict:
            eng = r()
            if eng is None:
                return {"page_size": 0, "digests": []}
            return {"page_size": eng.model.kv_config.page_size,
                    "digests": eng.export_digests(top_k)}

        tserver.set_digest_source(_digests)

    def _bind_kv_gauges(self) -> None:
        """Point the ``ds_kv_*`` gauges at this engine's allocator and
        tier (the newest engine of the process owns them), through
        weakrefs: the registry keeps no discarded pool alive, and a dead
        reference reads 0."""
        import weakref
        ref = weakref.ref(self._state.kv_cache.allocator)

        def read(attr):
            def _read(r=ref, a=attr):
                alloc = r()
                return getattr(alloc, a) if alloc is not None else 0
            return _read

        tm.KV_FREE_PAGES.bind(read("free_pages"))
        tm.KV_LIVE_PAGES.bind(read("live_pages"))
        tm.KV_PARKED_PAGES.bind(read("parked_pages"))
        tm.KV_TOTAL_PAGES.bind(read("total_pages"))
        tref = weakref.ref(self._state)

        def tier_read(attr):
            def _read(r=tref, a=attr):
                st = r()
                tiers = st.tiers if st is not None else None
                return getattr(tiers, a) if tiers is not None else 0
            return _read

        tm.KV_TIER_HOST_PAGES.bind(tier_read("host_pages"))
        tm.KV_TIER_DISK_PAGES.bind(tier_read("disk_pages"))

    @staticmethod
    def _params_resident_bytes(params) -> int:
        """Resident bytes of the parameter tensors (a quantised leaf's
        ``q`` and ``scale`` both count); a tensor reached twice counts
        once."""
        total, seen = 0, set()
        for leaf in tree_leaves(params):
            if not isinstance(leaf, torch.Tensor):
                continue
            key = (leaf.device, leaf.data_ptr(), leaf.numel())
            if key not in seen:
                seen.add(key)
                total += leaf.numel() * leaf.element_size()
        return total

    def _bind_memory_accountants(self) -> None:
        """Register this engine's subsystems with the memory ledger (the
        weakref / newest-owner rule of the ``ds_kv_*`` gauges).  Weights
        and pool footprints are fixed after the build and computed here;
        the tier and offload accountants read the live manager.  Every
        accountant reads host state only, so a scrape never touches the
        card (it may run while a step graph captures)."""
        import weakref
        from ...telemetry.memory import get_memory_ledger
        led = get_memory_ledger()
        wbytes = self._params_resident_bytes(self._model.params)
        led.register_object("weights", self, lambda e, b=wbytes: b)
        kv_bytes = self._model.kv_config.total_bytes()
        led.register_object("kv_pages", self._state,
                            lambda st, b=kv_bytes: b)
        draft = self._draft_kv
        draft_bytes = (draft.numel() * draft.element_size()
                       if draft is not None else 0)
        led.register_object("draft_kv", self, lambda e, b=draft_bytes: b)
        led.register_object(
            "tier_host", self._state,
            lambda st: st.tiers.host_bytes if st.tiers is not None else 0)
        led.register_object(
            "tier_disk", self._state,
            lambda st: st.tiers.disk_bytes if st.tiers is not None else 0)
        led.register_object("offload", self._state,
                            lambda st: st.offloaded_blob_bytes)
        # admissible sequences at the observed per-sequence page need,
        # sampled into the time series so a `capacity` objective burns
        ref = weakref.ref(self)

        def _headroom_seqs(r=ref):
            eng = r()
            return eng.headroom()["headroom_seqs"] if eng is not None else 0

        tm.MEM_HEADROOM_SEQS.bind(_headroom_seqs)

    def headroom(self) -> Dict:
        """How many more sequences fit now: free + parked pages over the
        observed p90 pages per sequence, capped by the free tracked
        sequence slots (the JAX engine's model).  The per-sequence need
        comes from the workload trace while it is on, else the live
        sequences, else a 512-token default."""
        alloc = self._state.kv_cache.allocator
        free = int(alloc.free_pages)
        parked = int(alloc.parked_pages)
        tiers = self._state.tiers
        demotable = 0
        if tiers is not None:
            spare = max(tiers._host_cap - tiers.host_pages, 0)
            if tiers._disk_cap:
                spare += max(tiers._disk_cap - tiers.disk_pages, 0)
            demotable = min(parked, spare)
        pages = free + parked
        p50, p90, basis = self._pages_per_seq_estimate()
        slots = max(int(self._config.state_manager.max_tracked_sequences)
                    - self._state.n_tracked_sequences, 0)
        seqs = min(pages // max(p90, 1), slots)
        return {
            "free_pages": free,
            "parked_pages": parked,
            "demotable_pages": demotable,
            "headroom_pages": pages,
            "slot_headroom": slots,
            "pages_per_seq_p50": p50,
            "pages_per_seq_p90": p90,
            "basis": basis,
            "headroom_seqs": max(int(seqs), 0),
        }

    def _pages_per_seq_estimate(self) -> Tuple[int, int, str]:
        """(p50, p90, basis) of the pages a sequence needs: from the
        workload trace's request tail ("trace"), else the live pool's
        pages per tracked sequence ("live"), else 512 tokens
        ("default").  Cached 10 s: the trace tail is a file read and the
        headroom gauge rides every time-series sample."""
        import json
        import time
        now = time.monotonic()
        cached = self._pages_dist_cache
        if cached is not None and now < cached[0]:
            return cached[1], cached[2], cached[3]
        page = int(self._model.kv_config.page_size)
        p50 = p90 = 0
        basis = "default"
        try:
            from ...telemetry.workload_trace import get_workload_trace
            tail = get_workload_trace().tail_text()
        except Exception:
            tail = None
        if tail:
            lens = []
            for line in tail.splitlines()[-1024:]:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if rec.get("kind") != "request":
                    continue
                toks = (int(rec.get("prompt_len", 0))
                        + int(rec.get("gen_len", 0)))
                if toks > 0:
                    lens.append(-(-toks // page))
            if lens:
                lens.sort()
                p50 = lens[len(lens) // 2]
                p90 = lens[min(int(len(lens) * 0.9), len(lens) - 1)]
                basis = "trace"
        if not p90:
            alloc = self._state.kv_cache.allocator
            n = self._state.n_tracked_sequences
            if n > 0 and alloc.live_pages > 0:
                p50 = p90 = -(-int(alloc.live_pages) // n)
                basis = "live"
        if not p90:
            p50 = p90 = max(-(-512 // page), 1)
            basis = "default"
        self._pages_dist_cache = (now + 10.0, p50, p90, basis)
        return p50, p90, basis

    def _resolve_kv_config(self, model: RaggedInferenceModel) -> KVCacheConfig:
        """The cache the engine builds, with the serving knob
        ``kv_quantization`` as its encoding (an encoding, not geometry).
        A model given a ``kv_config`` keeps its geometry; otherwise
        ``config.kv_cache`` sets it, and ``num_pages=None`` takes as many
        pages as ``state_manager.memory_fraction`` of the free device
        memory holds (on the CPU, which reports none, the model's
        default count)."""
        quant = self._config.serving.kv_quantization or "none"
        if model.kv_config_explicit:
            return dataclasses.replace(model.kv_config, quantization=quant)
        user = self._config.kv_cache
        kv_cfg = dataclasses.replace(
            model.kv_config, page_size=user.page_size,
            num_pages=user.num_pages or model.kv_config.num_pages,
            dtype=user.dtype, quantization=quant)
        if user.num_pages is None:
            free = self._free_device_memory(model.device)
            if free is not None:
                budget = int(free * self._config.state_manager.memory_fraction)
                if self._draft_enabled:
                    L = model.cfg.num_layers
                    budget = int(budget * L / (L + self._draft_layers))
                kv_cfg = dataclasses.replace(
                    kv_cfg, num_pages=pages_for_memory(kv_cfg, budget))
        return kv_cfg

    def _build_draft(self, model: RaggedInferenceModel) -> None:
        """Attach the draft trunk to the model (or detach it): the same
        family at ``_draft_layers`` layers over the target's own tensors,
        the whole tree for the self-draft, else its leading layers.
        Embedding, final norm and lm head are always the target's."""
        if not self._draft_enabled:
            model.draft_cfg = model.draft_params = None
            return
        cfg = model.cfg
        L, L_d = cfg.num_layers, self._draft_layers
        model.draft_cfg = dataclasses.replace(cfg, num_layers=L_d)
        if L_d == L:
            model.draft_params = model.params
            return
        layers = model.params["layers"]
        if cfg.scan_layers:
            dlayers = tree_map(lambda leaf: leaf[:L_d], layers)
        else:
            dlayers = {f"layer_{i}": layers[f"layer_{i}"] for i in range(L_d)}
        model.draft_params = dict(model.params, layers=dlayers)

    @property
    def draft_enabled(self) -> bool:
        """The engine built a draft trunk (``speculative`` on and
        ``spec_drafter`` model or auto)."""
        return self._draft_enabled

    @property
    def draft_digest(self) -> str:
        """The draft trunk's identity ("" without one): a snapshot records
        it and ``restore`` refuses a bundle taken under another draft
        trunk.  The JAX package hashes its own config class's repr, so a
        bundle with a draft trunk restores only within the package that
        took it; without one both packages write ""."""
        if not self._draft_enabled:
            return ""
        facts = f"{self._draft_layers}:{self._model.draft_cfg!r}"
        return hashlib.blake2b(facts.encode("utf-8"),
                               digest_size=8).hexdigest()

    @property
    def draft_kv(self) -> Optional[torch.Tensor]:
        """The draft trunk's KV pool [L_draft, pages+1, page, 2, K, D]."""
        return self._draft_kv

    def draft_lag(self, uid: int) -> int:
        """Committed tokens of ``uid`` the draft pool does not cover
        (prefill, decode steps that did not draft and prefix hits advance
        the target alone); the scheduler runs a draft_fill while it is
        > 0."""
        sd = self._state.get_sequence(uid)
        if sd is None:
            return 0
        return max(sd.seen_tokens - self._draft_seen.get(uid, 0), 0)

    def mark_draft_seen(self, uids: Sequence[int]) -> None:
        """After ``commit_spec`` of a draft_spec step: the draft loop wrote
        draft KV at every committed position of these rows."""
        for uid in uids:
            sd = self._state.get_sequence(uid)
            if sd is not None:
                self._draft_seen[uid] = sd.seen_tokens

    def seen_tokens(self, uid: int) -> int:
        sd = self._state.get_sequence(uid)
        return sd.seen_tokens if sd is not None else 0

    def _kv_for(self, key) -> object:
        """The store(s) a step key writes: the target pool, the draft
        pool (draft_fill) or the pair (draft_spec).  ValueError for a
        draft key on an engine without the draft trunk."""
        kind = key[4] if len(key) > 4 else "logits"
        kv = self._state.kv_cache.data
        if kind in ("draft_spec", "draft_fill"):
            if self._draft_kv is None:
                raise ValueError(
                    f"step key {key} needs the draft pool, and this engine "
                    "was built without spec_drafter model or auto")
            return (kv, self._draft_kv) if kind == "draft_spec" \
                else self._draft_kv
        return kv

    @staticmethod
    def _free_device_memory(device: torch.device) -> Optional[int]:
        """Bytes a new KV pool could take on ``device``: the free device
        memory (``torch.cuda.mem_get_info``) plus what PyTorch's caching
        allocator holds unused; None on the CPU."""
        if device.type != "cuda":
            return None
        free, _ = torch.cuda.mem_get_info(device)
        return free + (torch.cuda.memory_reserved(device)
                       - torch.cuda.memory_allocated(device))

    # -- the step lattice ----------------------------------------------------
    def precompile(self, max_prompt: int, max_concurrency: int = 0,
                   max_new_tokens: int = 256, strict: bool = False,
                   sampling: bool = False,
                   spec_max_draft: Optional[int] = None,
                   kinds: Optional[Sequence[str]] = None) -> List[Tuple]:
        """Capture the graphs of the bucket lattice this engine can hit
        (``lattice_keys``) before serving, so no capture lands on the
        request path: S up to ``max_concurrency`` (default: the state
        manager's ``max_ragged_sequence_count``), Q up to ``max_prompt``,
        P up to ``max_prompt + max_new_tokens`` tokens.  The logits keys
        serve ``put`` (the split step); ``sampling`` adds the sample and
        chain keys (the fused scheduler's steps) and the spec keys at
        ``spec_max_draft`` (default: the serving config's, 0 with
        ``speculative`` off), with the draft trunk's twins when the
        engine has one.  ``strict`` makes any later key outside the set
        raise.  ``kinds`` keeps a disaggregated role's key classes
        (:data:`LATTICE_KINDS`; a prefill engine takes ``("prefill",
        "decode")``, a decode engine ``("decode", "chain", "spec")``) and
        guards the shrink: on the power-of-two lattice a filter that
        keeps every key raises.  A failed capture raises.  Returns the
        keys."""
        sm = self._config.state_manager
        sv = self._config.serving
        if spec_max_draft is None:
            spec_max_draft = (int(sv.spec_max_draft or 0)
                              if sv.speculative else 0)
        if self._lattice is not None:
            # a mined lattice: its key set, fitted to this engine
            keys = self._auto_lattice_keys(sampling, spec_max_draft,
                                           kinds, strict=strict)
        else:
            kwargs = dict(
                max_prompt=max_prompt, max_new_tokens=max_new_tokens,
                max_concurrency=(max_concurrency
                                 or sm.max_ragged_sequence_count),
                page_size=self._model.kv_config.page_size,
                max_ragged_batch_size=sm.max_ragged_batch_size,
                has_fresh=self._model._fresh_attention is not None,
                sampling=sampling, spec_max_draft=spec_max_draft,
                draft=(self._draft_enabled and sampling
                       and spec_max_draft > 0))
            keys = lattice_keys(kinds=kinds, **kwargs)
            if kinds is not None:
                full = len(lattice_keys(**kwargs))
                if len(keys) >= full:
                    raise ValueError(
                        f"precompile(kinds={tuple(kinds)}) enumerated "
                        f"{len(keys)} keys but the full lattice has {full}: "
                        "the role filter did not shrink the captured set "
                        "(capturing both roles' keys in each engine "
                        "defeats the disaggregation)")
        for key in keys:
            self._model.precompile_step(key, self._kv_for(key))
        if strict:
            self._model.strict_shapes = True
        return keys

    def _auto_lattice_keys(self, sampling: bool, spec_max_draft: int,
                           kinds: Optional[Sequence[str]] = None,
                           strict: bool = False) -> List[Tuple]:
        """The mined lattice's keys this engine can form: the sampling
        families only with ``sampling``, fresh variants only when the
        model has a fresh path, spec keys only with speculation on (at
        this engine's spec bucket, and generated over the lattice's tops
        when the trace had none), draft keys only with a draft trunk, S *
        Q within this engine's budget; ``strict`` drops the mixed keys (a
        strict scheduler serves mixed steps split).  A lattice mined on a
        model without a fresh path gets the fresh twins a fresh-capable
        engine forms."""
        sm = self._config.state_manager
        has_fresh = self._model._fresh_attention is not None
        lat = self._lattice
        spec_q = lat.bucket_q(1 + spec_max_draft)
        keys: List[Tuple] = []
        for key in lat.keys:
            kind = key[4] if len(key) > 4 else "logits"
            if not sampling and kind != "logits":
                continue
            if strict and kind == "mixed":
                continue
            if kind == "spec" and (spec_max_draft <= 0 or key[1] != spec_q):
                continue
            if kind in ("draft_spec", "draft_fill"):
                if not (self._draft_enabled and spec_max_draft > 0):
                    continue
                if kind == "draft_spec" and key[1] != spec_q:
                    continue
            if not has_fresh and (bool(key[3]) or (
                    kind == "mixed" and bool(key[8]))):
                continue
            if kind == "mixed":
                if key[0] + key[6] * key[5] > 2 * sm.max_ragged_batch_size:
                    continue
            elif key[0] * key[1] > sm.max_ragged_batch_size:
                continue
            keys.append(key)
            if has_fresh and not lat.has_fresh:
                if (key[1] > 1 and kind in ("logits", "sample")
                        and not bool(key[3])):
                    keys.append((key[0], key[1], key[2], True) + key[4:])
                elif kind == "mixed" and not bool(key[8]):
                    keys.append(key[:8] + (True,) + key[9:])
        if sampling and spec_max_draft > 0:
            page = self._model.kv_config.page_size
            have = set(keys)
            for S in lat.s_tops:
                if S * spec_q > sm.max_ragged_batch_size:
                    continue
                for P in lat.p_tops:
                    if P * page < spec_q:
                        continue
                    for greedy in (True, False):
                        for kk in (("spec", greedy),) + (
                                (("draft_spec", greedy),)
                                if self._draft_enabled else ()):
                            key = (S, spec_q, P, False) + kk
                            if key not in have:
                                keys.append(key)
                                have.add(key)
            if self._draft_enabled:
                for S in lat.s_tops:
                    for Q in lat.q_tops:
                        if S * Q > sm.max_ragged_batch_size:
                            continue
                        for P in lat.p_tops:
                            if P * page < Q:
                                continue
                            key = (S, Q, P, False, "draft_fill")
                            if key not in have:
                                keys.append(key)
                                have.add(key)
        if kinds is not None:
            _validate_kinds(kinds)
            want = set(kinds)
            filtered = [k for k in keys if lattice_kind_of(k) in want]
            if len(filtered) >= len(keys):
                # a mined lattice may be role-pure already (mined from one
                # role's own trace): noted, not refused
                warnings.warn(
                    f"precompile(kinds={tuple(kinds)}): the mined lattice "
                    "holds no key outside these kinds; nothing to shrink")
            keys = filtered
        return keys

    @property
    def lattice(self):
        """The mined ``BucketLattice`` this engine buckets under (None:
        the power-of-two default)."""
        return self._lattice

    @property
    def lattice_digest(self) -> str:
        """The lattice's content digest ("" for the power-of-two
        default): a snapshot records it and ``restore`` compares it."""
        return self._lattice.digest if self._lattice is not None else ""

    def compiled_keys(self, dispatched_only: bool = True) -> List[Tuple]:
        """The step keys traffic dispatched (default), or every key in
        the model's step cache."""
        keys = (self._model.dispatch_counts if dispatched_only
                else self._model._step_cache)
        return sorted(keys, key=repr)

    def precompile_keys(self, keys: Sequence[Sequence]) -> int:
        """Capture an explicit key list (JSON-round-tripped lists
        accepted).  A key this model cannot form (malformed, or of a kind
        the port does not serve, or a draft key without a draft trunk)
        warns and is skipped: a manifest from another build must not block
        serving.  A failed capture raises.  Returns the number of keys
        captured."""
        done = 0
        for k in keys:
            try:
                key = self._model.check_key(k)
                kv = self._kv_for(key)
            except ValueError as e:
                warnings.warn(f"precompile_keys: skipping key {k!r} ({e})")
                continue
            self._model.precompile_step(key, kv)
            done += 1
        return done

    def predict_step_key(self, batch_uids: Sequence[int],
                         batch_tokens: Sequence, suffix: tuple = (),
                         min_q: int = 1) -> tuple:
        """The step key a single-geometry dispatch of this batch will
        form, before admission (``build_batch``'s bucketing).  ``suffix``
        extends (S, Q, P, fresh): ``("sample", greedy)``, ``("chain",
        prev_len, greedy)``, ``("spec", greedy)`` or ``("draft_spec",
        greedy)`` (with ``min_q`` the spec bucket, fresh pinned False),
        or ``("draft_fill",)``."""
        page = self._model.kv_config.page_size
        pages, all_new = [], True
        for uid, toks in zip(batch_uids, batch_tokens):
            sd = self._state.get_sequence(uid)
            seen = sd.seen_tokens if sd is not None else 0
            cap = sd.allocated_capacity if sd is not None else 0
            pages.append(max(cap, -(-(seen + len(toks)) // page)))
            all_new = all_new and not seen
        if self._lattice is not None:
            S = self._lattice.bucket_s(len(batch_uids))
            Q = self._lattice.bucket_q(
                max(max(len(t) for t in batch_tokens), min_q))
            P = self._lattice.bucket_p(max(pages))
        else:
            S = _bucket(len(batch_uids), MIN_SLOTS)
            Q = _bucket(max(max(len(t) for t in batch_tokens), min_q))
            P = _bucket(max(pages), MIN_PAGES)
        fresh = (all_new and Q > 1
                 and suffix[:1] not in (("spec",), ("draft_spec",),
                                        ("draft_fill",))
                 and self._model._fresh_attention is not None)
        return (S, Q, P, fresh) + tuple(suffix)

    # -- introspection -------------------------------------------------------
    @property
    def free_blocks(self) -> int:
        return self._state.free_pages

    @property
    def model(self) -> RaggedInferenceModel:
        return self._model

    @property
    def state_manager(self) -> StateManager:
        return self._state

    # -- scheduling queries --------------------------------------------------
    def query(self, uid: int, max_request_tokens: int,
              max_request_blocks: int) -> Tuple[int, int]:
        sd = self._state.get_sequence(uid)
        if sd is None:
            if (self._state.n_tracked_sequences
                    >= self._config.state_manager.max_tracked_sequences):
                return (0, 0)
            sd = placeholder()
        return self._model.get_kv_requirements(
            sd.seen_tokens, sd.allocated_capacity,
            max_request_tokens, max_request_blocks)

    def can_schedule(self, uids: Sequence[int],
                     lengths: Sequence[int]) -> SchedulingResult:
        sm_cfg = self._config.state_manager
        if len(uids) > sm_cfg.max_ragged_sequence_count:
            return SchedulingResult.BatchSequenceLimitExceeded
        cur_seqs = self._state.n_tracked_sequences
        free = self._state.free_pages
        batch_tokens = 0
        for uid, length in zip(uids, lengths):
            sd = self._state.get_sequence(uid)
            if sd is None:
                cur_seqs += 1
                sd = placeholder()
            tokens, pages = self._model.get_kv_requirements(
                sd.seen_tokens, sd.allocated_capacity, length, free)
            if tokens != length:
                return SchedulingResult.KVCacheLimitExceeded
            batch_tokens += length
            free -= pages
        if cur_seqs > sm_cfg.max_tracked_sequences:
            return SchedulingResult.EngineSequenceLimitExceeded
        if batch_tokens > sm_cfg.max_ragged_batch_size:
            return SchedulingResult.BatchTokenLimitExceeded
        return SchedulingResult.Success

    # -- the forward ---------------------------------------------------------
    def _admit_batch(self, batch_uids, batch_tokens, do_checks):
        """Schedulability check + KV reservation + in-flight marking."""
        with trace_span("engine.admit"):
            if do_checks:
                res = self.can_schedule(batch_uids,
                                        [len(t) for t in batch_tokens])
                if res != SchedulingResult.Success:
                    raise SchedulingError(res)
            descs = []
            for uid, toks in zip(batch_uids, batch_tokens):
                sd = self._state.get_or_create_sequence(uid)
                self._state.allocate_for(sd, len(toks))
                sd.pre_forward(len(toks))
                descs.append(sd)
            return descs

    def _commit_batch(self, descs) -> None:
        """Commit the host bookkeeping (the token VALUES may still be on
        their way from the device), index newly full prompt pages, then
        release the pages a sliding window has left behind (in that
        order: an indexed page the window releases stays parked in the
        prefix cache)."""
        with trace_span("engine.commit"):
            window = self._model.cfg.sliding_window
            for sd in descs:
                sd.post_forward()
                self._state.index_prefix(sd)
                if window:
                    # every later query starts past these pages: live KV
                    # stays O(window), not O(context)
                    self._state.evict_window(sd, window)

    def _build_batch(self, descs, tokens, min_q: int = 1,
                     h2d_tokens: bool = True):
        """Pack one segment; its host-to-device bytes count here, the
        dispatch at the caller (a mixed step feeds two segments to one
        program).  ``h2d_tokens=False`` for a chained step, whose token
        ids never leave the card."""
        with trace_span("engine.build_batch"):
            batch = build_batch(
                descs, [np.asarray(t) for t in tokens],
                self._model.kv_config.page_size,
                fresh_supported=self._model._fresh_attention is not None,
                min_q=min_q, lattice=self._lattice)
            nbytes = (batch.q_lens.nbytes + batch.start_pos.nbytes
                      + batch.page_table.nbytes)
            if h2d_tokens:
                nbytes += batch.token_ids.nbytes
            serving_counters.record_h2d(nbytes)
            return batch

    def put(self, batch_uids: Sequence[int],
            batch_tokens: Sequence[np.ndarray],
            do_checks: bool = True,
            fused: Optional[bool] = None) -> torch.Tensor:
        """Ragged forward; returns fp32 logits [len(batch_uids), V] in
        input order, on the model's device.  ``fused`` (None: the
        engine's ``serving.fused_step``) runs one forward over one
        superbucket; False runs one forward per Q bucket, so decode rows
        never pad to a prefill chunk's width."""
        if fused is None:
            fused = self._config.serving.fused_step
        descs = self._admit_batch(batch_uids, batch_tokens, do_checks)
        kv = self._state.kv_cache.data
        if fused:
            batch = self._build_batch(descs, batch_tokens)
            serving_counters.record_program()
            logits = self._model.forward(batch, kv)[:len(batch_uids)]
            self._commit_batch(descs)
            serving_counters.record_logits_exposed(logits.numel() * 4)
            return logits
        groups: Dict[int, List[int]] = {}
        for i, toks in enumerate(batch_tokens):
            groups.setdefault(_bucket(len(toks)), []).append(i)
        rows: List[Optional[torch.Tensor]] = [None] * len(batch_uids)
        for q in sorted(groups):
            idxs = groups[q]
            batch = self._build_batch([descs[i] for i in idxs],
                                      [batch_tokens[i] for i in idxs])
            serving_counters.record_program()
            logits = self._model.forward(batch, kv)
            for row, i in enumerate(idxs):
                rows[i] = logits[row]
        self._commit_batch(descs)
        out = torch.stack(rows)
        serving_counters.record_logits_exposed(out.numel() * 4)
        return out

    @staticmethod
    def _pad_sample_params(row_params, S):
        """Per-row sampling params padded to the slot bucket; padding
        rows are greedy (argmax over garbage nobody reads)."""
        temps = np.zeros(S, np.float32)
        top_ks = np.zeros(S, np.int32)
        top_ps = np.ones(S, np.float32)
        for i, p in enumerate(row_params):
            temps[i] = p.temperature
            top_ks[i] = p.top_k
            top_ps[i] = p.top_p
        return temps, top_ks, top_ps

    def _pad_keyed(self, batch_uids, row_pos, S):
        """The keyed inputs padded to the slot bucket: [S] int32 uids
        (cast from the request uid, as the JAX engine casts it) and
        generation positions; padding rows draw garbage nobody reads.
        (None, None) when the mode is off, and also when a keyed engine
        is stepped without positions, so the model raises instead of
        pinning every draw to position 0."""
        if not self._model.keyed_sampling or row_pos is None:
            return None, None
        uids = np.zeros(S, np.int32)
        pos = np.zeros(S, np.int32)
        uids[:len(batch_uids)] = np.asarray(batch_uids, np.int64).astype(
            np.int32)
        pos[:len(row_pos)] = np.asarray(row_pos, np.int32)
        return uids, pos

    def step_sample(self, batch_uids: Sequence[int],
                    batch_tokens: Sequence[np.ndarray],
                    row_params: Sequence[SamplingParams], rng,
                    do_checks: bool = True,
                    row_pos: Optional[Sequence[int]] = None
                    ) -> Tuple[torch.Tensor, List[int]]:
        """One SplitFuse step: forward + on-device sampling.  Returns
        (device token array int32, output row per input).  Rows still
        mid-prefill sample garbage the caller ignores.  ``rng`` is the
        scheduler's generator, or on a keyed engine its base key, with
        each row's generation position in ``row_pos``."""
        descs = self._admit_batch(batch_uids, batch_tokens, do_checks)
        dec_idx = [i for i, t in enumerate(batch_tokens) if len(t) == 1]
        pre_idx = [i for i, t in enumerate(batch_tokens) if len(t) > 1]
        kv = self._state.kv_cache.data

        if not dec_idx or not pre_idx:       # single-geometry step
            batch = self._build_batch(descs, batch_tokens)
            temps, top_ks, top_ps = self._pad_sample_params(
                row_params, batch.num_slots)
            kuids, kpos = self._pad_keyed(batch_uids, row_pos,
                                          batch.num_slots)
            greedy_only = not bool((temps > 0.0).any())
            serving_counters.record_program(
                h2d_bytes=temps.nbytes + top_ks.nbytes + top_ps.nbytes)
            tokens = self._model.sample_step(batch, kv, rng, temps, top_ks,
                                             top_ps, greedy_only,
                                             row_uids=kuids, row_pos=kpos)
            self._commit_batch(descs)
            return tokens, list(range(len(batch_uids)))

        dec = self._build_batch([descs[i] for i in dec_idx],
                                [batch_tokens[i] for i in dec_idx])
        pre = self._build_batch([descs[i] for i in pre_idx],
                                [batch_tokens[i] for i in pre_idx])
        row_of_input = [0] * len(batch_uids)
        ordered = [SamplingParams()] * (dec.num_slots + pre.num_slots)
        for row, i in enumerate(dec_idx):
            row_of_input[i] = row
            ordered[row] = row_params[i]
        for row, i in enumerate(pre_idx):
            row_of_input[i] = dec.num_slots + row
            ordered[dec.num_slots + row] = row_params[i]
        temps, top_ks, top_ps = self._pad_sample_params(ordered, len(ordered))
        # the keyed inputs follow the same segment order as the params
        kuids = kpos = None
        if self._model.keyed_sampling and row_pos is not None:
            kuids = np.zeros(len(ordered), np.int32)
            kpos = np.zeros(len(ordered), np.int32)
            for i, row in enumerate(row_of_input):
                kuids[row] = np.int64(batch_uids[i]).astype(np.int32)
                kpos[row] = int(row_pos[i])
        greedy_only = not bool((temps > 0.0).any())
        serving_counters.record_program(
            h2d_bytes=temps.nbytes + top_ks.nbytes + top_ps.nbytes)
        tokens = self._model.sample_step_mixed(dec, pre, kv, rng, temps,
                                               top_ks, top_ps, greedy_only,
                                               row_uids=kuids, row_pos=kpos)
        self._commit_batch(descs)
        return tokens, row_of_input

    def step_decode_chained(self, batch_uids: Sequence[int],
                            prev_tokens: torch.Tensor,
                            gather_idx: Sequence[int],
                            row_params: Sequence[SamplingParams], rng,
                            row_pos: Optional[Sequence[int]] = None
                            ) -> torch.Tensor:
        """Decode step whose input tokens are gathered ON THE DEVICE from
        the previous step's tokens (``prev_tokens``, possibly still being
        computed): row i continues the sequence in row ``gather_idx[i]``
        of the previous step's output.  No host sync on this path: the
        async scheduler drains step k while step k+1 runs."""
        placeholder_toks = [np.zeros(1, np.int32)] * len(batch_uids)
        descs = self._admit_batch(batch_uids, placeholder_toks,
                                  do_checks=False)
        batch = self._build_batch(descs, placeholder_toks, h2d_tokens=False)
        temps, top_ks, top_ps = self._pad_sample_params(
            row_params, batch.num_slots)
        greedy_only = not bool((temps > 0.0).any())
        gather = np.zeros(batch.num_slots, np.int32)
        gather[:len(batch_uids)] = np.asarray(gather_idx, np.int32)
        kuids, kpos = self._pad_keyed(batch_uids, row_pos, batch.num_slots)
        serving_counters.record_program(
            h2d_bytes=temps.nbytes + top_ks.nbytes + top_ps.nbytes
            + gather.nbytes)
        tokens = self._model.chained_step(
            batch, self._state.kv_cache.data, prev_tokens, gather, rng,
            temps, top_ks, top_ps, greedy_only, row_uids=kuids,
            row_pos=kpos)
        self._commit_batch(descs)
        return tokens

    # -- speculative decoding -----------------------------------------------
    def _spec_batch(self, batch_uids, batch_tokens, row_params, min_q,
                    row_pos):
        descs = self._admit_batch(batch_uids, batch_tokens, do_checks=False)
        # every spec dispatch pads to the one spec Q bucket (min_q = 1 +
        # spec_max_draft): a short-draft step forms no smaller key
        batch = self._build_batch(descs, batch_tokens, min_q=min_q)
        temps, top_ks, top_ps = self._pad_sample_params(
            row_params, batch.num_slots)
        kuids, kpos = self._pad_keyed(batch_uids, row_pos, batch.num_slots)
        serving_counters.record_program(
            h2d_bytes=temps.nbytes + top_ks.nbytes + top_ps.nbytes)
        return (batch, (temps, top_ks, top_ps, not bool((temps > 0.0).any())),
                dict(row_uids=kuids, row_pos=kpos))

    def step_spec(self, batch_uids: Sequence[int],
                  batch_tokens: Sequence[np.ndarray],
                  row_params: Sequence[SamplingParams], rng,
                  min_q: int = 1,
                  row_pos: Optional[Sequence[int]] = None) -> torch.Tensor:
        """Speculative verify: each row's tokens are ``[last_committed,
        d_1..d_k]`` (k may differ per row, 0 allowed).  Returns the device
        [S, 2] int32 verdict (accepted drafts, corrected token) per row.
        The commit waits for :meth:`commit_spec` with each row's
        committed count (a step may commit 1..1+k tokens of a row).  On
        a keyed engine ``row_pos`` is each row's generation index at its
        first position."""
        batch, rows, keyed = self._spec_batch(batch_uids, batch_tokens,
                                              row_params, min_q, row_pos)
        return self._model.spec_step(batch, self._state.kv_cache.data, rng,
                                     *rows, **keyed)

    def step_draft_spec(self, batch_uids: Sequence[int],
                        batch_tokens: Sequence[np.ndarray],
                        row_params: Sequence[SamplingParams], rng,
                        min_q: int = 1,
                        row_pos: Optional[Sequence[int]] = None
                        ) -> torch.Tensor:
        """Model-drafted speculative step: as :meth:`step_spec`, but each
        row is ``[last, 0...0]`` of length ``1 + room`` (room: the drafts
        the row may commit) and the draft trunk drafts on the device.
        Returns the device [S, 2+k] int32 verdict (accepted, corrected,
        the k drafts).  Call :meth:`commit_spec`, then
        :meth:`mark_draft_seen`."""
        batch, rows, keyed = self._spec_batch(batch_uids, batch_tokens,
                                              row_params, min_q, row_pos)
        return self._model.draft_spec_step(
            batch, (self._state.kv_cache.data, self._draft_kv), rng, *rows,
            **keyed)

    def step_draft_fill(self, batch_uids: Sequence[int],
                        batch_tokens: Sequence[np.ndarray]) -> None:
        """The draft pool's catch-up: ``batch_tokens[i]`` is the committed
        history ``[draft_seen : draft_seen + chunk]`` of uid i, run
        through the draft trunk into the draft pool over the sequence's
        own page table.  The target pool, the seen counts and the
        allocator stay as they are; nothing reaches the host.  Advances
        each uid's draft mark."""
        sds, starts, caps = [], [], []
        for uid in batch_uids:
            sd = self._state.get_sequence(uid)
            if sd is None:
                raise ValueError(f"step_draft_fill: unknown sequence {uid}")
            sds.append(sd)
            starts.append(self._draft_seen.get(uid, 0))
            caps.append(max(sd.allocated_capacity, 1))
        lengths = [len(t) for t in batch_tokens]
        if self._lattice is not None:
            S = self._lattice.bucket_s(len(batch_uids))
            Q = self._lattice.bucket_q(max(lengths))
            P = self._lattice.bucket_p(max(caps))
        else:
            S = _bucket(len(batch_uids), MIN_SLOTS)
            Q = _bucket(max(lengths))
            P = _bucket(max(caps), MIN_PAGES)
        token_ids = np.zeros((S, Q), np.int32)
        q_lens = np.zeros(S, np.int32)
        start_pos = np.zeros(S, np.int32)
        page_table = np.zeros((S, P), np.int32)
        for i, (sd, toks, start) in enumerate(zip(sds, batch_tokens,
                                                  starts)):
            toks = np.asarray(toks, np.int32).reshape(-1)
            token_ids[i, :len(toks)] = toks
            q_lens[i] = len(toks)
            start_pos[i] = start
            page_table[i] = sd.page_table(P)
        serving_counters.record_program(
            h2d_bytes=token_ids.nbytes + q_lens.nbytes + start_pos.nbytes
            + page_table.nbytes)
        self._model.draft_fill_step(
            RaggedBatch(token_ids, q_lens, start_pos, page_table,
                        list(batch_uids)), self._draft_kv)
        for uid, start, n in zip(batch_uids, starts, lengths):
            self._draft_seen[uid] = start + n

    def commit_spec(self, batch_uids: Sequence[int],
                    committed: Sequence[int]) -> None:
        """Variable-advance commit of a spec or draft_spec step: each
        row's ``seen_tokens`` moves by its committed count (1 + accepted
        drafts, cut at a stop token), then newly full prompt pages are
        indexed and a window's pages released, as after any forward.
        Generated tokens are never indexed, so a rejected draft cannot
        reach a shared page."""
        with trace_span("engine.commit"):
            window = self._model.cfg.sliding_window
            for uid, n in zip(batch_uids, committed):
                sd = self._state.get_sequence(uid)
                if sd is None:
                    continue
                sd.commit_tokens(int(n))
                self._state.index_prefix(sd)
                if window:
                    self._state.evict_window(sd, window)

    # -- prefix caching ------------------------------------------------------
    def match_prefix(self, uid: int, prompt: Sequence[int]) -> int:
        """Attach the longest prefix-cache hit for a NEW sequence's
        prompt: matched full pages join its block table read-only and
        ``seen_tokens`` moves past them, so only the suffix is
        prefilled.  Registers the prompt for indexing either way.
        Returns the tokens served from the cache (0 on a miss, with
        caching off, or for a started sequence)."""
        if self._state.prefix_cache is None:
            return 0
        if (self._state.get_sequence(uid) is None
                and self._state.n_tracked_sequences
                >= self._config.state_manager.max_tracked_sequences):
            return 0  # no sequence the manager cannot track
        sd = self._state.get_or_create_sequence(uid)
        prompt = np.asarray(prompt, dtype=np.int32).reshape(-1)
        hit = self._state.match_prefix(sd, prompt)
        serving_counters.record_prefix_lookup(len(prompt), hit)
        return hit

    def export_digests(self, top_k: int = 64) -> List[str]:
        """The prefix cache's bounded affinity hint: the ``top_k`` most
        recently used cumulative page digests as hex, most recent first
        (empty with caching off); the one cache introspection a pool
        router needs."""
        return self._state.export_digests(top_k)

    def reset_prefix_cache(self) -> None:
        """Drop every cache entry (the host and disk tier's too) and
        return parked pages to the pool (a cold start)."""
        self._state.reset_prefix_cache()

    def export_prefix(self, digests_hex: List[str], max_pages: int = 64):
        """The KV contents of the leading run of a request's digest chain
        this engine's prefix cache holds, as ``(meta, arrays)`` (the page
        fetch's export half), or None when cold."""
        return self._state.export_prefix(digests_hex, max_pages=max_pages)

    def import_prefix(self, meta: dict, arrays: dict) -> dict:
        """Merge a peer's exported prefix pages into this engine's cache
        as parked, indexed pages (the fetched request's admission then
        matches them).  Raises the retryable ``KVAllocationError`` when
        the pool lacks room."""
        return self._state.import_prefix(meta, arrays)

    def cost_summary(self) -> Dict:
        """The dispatched steps' analytic cost (the model's
        ``cost_summary``): FLOPs and bytes in total and per key, the
        window and the rates over it."""
        return self._model.cost_summary()

    def tier_hits(self, uid: int) -> Optional[dict]:
        """The tokens a tracked sequence's prefix match attached, by tier
        of origin (``{"device", "host", "disk", "remote"}``), or None
        before a match attached any."""
        sd = self._state.get_sequence(uid)
        return None if sd is None else sd.tier_hits

    def flush(self, uid: int) -> None:
        self._state.flush_sequence(uid)
        self._draft_seen.pop(uid, None)

    def offload_sequence(self, uid: int) -> None:
        """Preempt a sequence: its private KV pages move to host memory
        and return to the pool.  It cannot be stepped until
        ``restore_sequence``.  Its draft mark stays as it was, as in the
        JAX engine: the restored pages' draft KV is not moved, and
        ``draft_lag`` reads 0 after the cycle (ROADMAP Queue 3)."""
        self._state.offload_sequence(uid)

    def restore_sequence(self, uid: int) -> None:
        """Bring a preempted sequence's KV back into fresh pages (raises
        ``KVAllocationError`` when the pool lacks them)."""
        self._state.restore_sequence(uid)
