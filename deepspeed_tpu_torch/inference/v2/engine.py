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
back.  After every forward the engine indexes newly full prompt pages
and, for a sliding-window model, releases the pages the window has left
behind.  A step mixing decode rows with
prefill chunks runs as two segments ([S_d, 1] + [S_p, Q]) so decode
rows never pad to the chunk width.  Each step key is one CUDA graph on
the card (``model.py``); ``precompile`` captures a lattice of them
before serving.  The engine builds the KV cache: fp pages, or int8
``KVPages`` when ``serving.kv_quantization`` says so; for a model built
without ``kv_config`` its geometry comes from ``config.kv_cache``, and
``num_pages=None`` sizes the pool from free device memory.
"""

from __future__ import annotations

import dataclasses
import enum
import warnings
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import RaggedInferenceEngineConfig
from .lattice import enumerate_lattice_keys
from .model import RaggedInferenceModel
from .ragged import KVCacheConfig, StateManager, build_batch, placeholder
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
#: speculative families (not ported)
LATTICE_KINDS = ("prefill", "decode", "chain", "spec")


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
                 sampling: bool,
                 kinds: Optional[Sequence[str]] = None) -> List[Tuple]:
    """Every step key of the power-of-two bucket lattice for this
    geometry: S over slot buckets up to ``max_concurrency``, Q over {1}
    and the prompt buckets up to ``max_prompt``, P over the page buckets
    up to ``max_prompt + max_new_tokens`` tokens.  ``kinds`` keeps a
    subset of :data:`LATTICE_KINDS`.  The key families are
    ``lattice.enumerate_lattice_keys``'s."""
    if kinds is not None:
        unknown = set(kinds) - set(LATTICE_KINDS)
        if unknown:
            raise ValueError(
                f"unknown lattice kinds {sorted(unknown)} "
                f"(expected a subset of {LATTICE_KINDS})")
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
        has_fresh=has_fresh, sampling=sampling)
    if kinds is not None:
        keys = [k for k in keys if lattice_kind_of(k) in set(kinds)]
    return keys


class InferenceEngineV2:
    def __init__(self, model: RaggedInferenceModel,
                 config: Optional[RaggedInferenceEngineConfig] = None):
        self._config = config or RaggedInferenceEngineConfig()
        self._config.serving.validate()
        self._model = model
        model.kv_config = self._resolve_kv_config(model)
        # graphs captured for an earlier engine wrote that engine's cache
        model.reset_steps()
        self._state = StateManager(
            model.kv_config, model.device,
            max_tracked_sequences=(
                self._config.state_manager.max_tracked_sequences),
            prefix_caching=self._config.serving.prefix_caching)

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
                kv_cfg = dataclasses.replace(
                    kv_cfg, num_pages=pages_for_memory(kv_cfg, budget))
        return kv_cfg

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
                   sampling: bool = False) -> List[Tuple]:
        """Capture the graphs of the bucket lattice this engine can hit
        (``lattice_keys``) before serving, so no capture lands on the
        request path: S up to ``max_concurrency`` (default: the state
        manager's ``max_ragged_sequence_count``), Q up to ``max_prompt``,
        P up to ``max_prompt + max_new_tokens`` tokens.  The logits keys
        serve ``put`` (the split step); ``sampling`` adds the sample and
        chain keys (the fused scheduler's steps).  ``strict`` makes any
        later key outside the set raise.  A failed capture raises.
        Returns the keys."""
        sm = self._config.state_manager
        keys = lattice_keys(
            max_prompt=max_prompt, max_new_tokens=max_new_tokens,
            max_concurrency=max_concurrency or sm.max_ragged_sequence_count,
            page_size=self._model.kv_config.page_size,
            max_ragged_batch_size=sm.max_ragged_batch_size,
            has_fresh=self._model._fresh_attention is not None,
            sampling=sampling)
        kv = self._state.kv_cache.data
        for key in keys:
            self._model.precompile_step(key, kv)
        if strict:
            self._model.strict_shapes = True
        return keys

    def compiled_keys(self, dispatched_only: bool = True) -> List[Tuple]:
        """The step keys traffic dispatched (default), or every key in
        the model's step cache."""
        keys = (self._model.dispatch_counts if dispatched_only
                else self._model._step_cache)
        return sorted(keys, key=repr)

    def precompile_keys(self, keys: Sequence[Sequence]) -> int:
        """Capture an explicit key list (JSON-round-tripped lists
        accepted).  A key this model cannot form (malformed, or of a kind
        the port does not serve) warns and is skipped: a manifest from
        another build must not block serving.  A failed capture raises.
        Returns the number of keys captured."""
        done = 0
        for k in keys:
            try:
                key = self._model.check_key(k)
            except ValueError as e:
                warnings.warn(f"precompile_keys: skipping key {k!r} ({e})")
                continue
            self._model.precompile_step(key, self._state.kv_cache.data)
            done += 1
        return done

    def predict_step_key(self, batch_uids: Sequence[int],
                         batch_tokens: Sequence, suffix: tuple = ()
                         ) -> tuple:
        """The step key a single-geometry dispatch of this batch will
        form, before admission (``build_batch``'s bucketing)."""
        page = self._model.kv_config.page_size
        pages, all_new = [], True
        for uid, toks in zip(batch_uids, batch_tokens):
            sd = self._state.get_sequence(uid)
            seen = sd.seen_tokens if sd is not None else 0
            cap = sd.allocated_capacity if sd is not None else 0
            pages.append(max(cap, -(-(seen + len(toks)) // page)))
            all_new = all_new and not seen
        S = _bucket(len(batch_uids), MIN_SLOTS)
        Q = _bucket(max(len(t) for t in batch_tokens))
        P = _bucket(max(pages), MIN_PAGES)
        fresh = (all_new and Q > 1
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
        window = self._model.cfg.sliding_window
        for sd in descs:
            sd.post_forward()
            self._state.index_prefix(sd)
            if window:
                # every later query starts past these pages: live KV
                # stays O(window), not O(context)
                self._state.evict_window(sd, window)

    def _build_batch(self, descs, tokens):
        return build_batch(
            descs, [np.asarray(t) for t in tokens],
            self._model.kv_config.page_size,
            fresh_supported=self._model._fresh_attention is not None)

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
            logits = self._model.forward(batch, kv)[:len(batch_uids)]
            self._commit_batch(descs)
            return logits
        groups: Dict[int, List[int]] = {}
        for i, toks in enumerate(batch_tokens):
            groups.setdefault(_bucket(len(toks)), []).append(i)
        rows: List[Optional[torch.Tensor]] = [None] * len(batch_uids)
        for q in sorted(groups):
            idxs = groups[q]
            logits = self._model.forward(self._build_batch(
                [descs[i] for i in idxs], [batch_tokens[i] for i in idxs]),
                kv)
            for row, i in enumerate(idxs):
                rows[i] = logits[row]
        self._commit_batch(descs)
        return torch.stack(rows)

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

    def step_sample(self, batch_uids: Sequence[int],
                    batch_tokens: Sequence[np.ndarray],
                    row_params: Sequence[SamplingParams],
                    generator: torch.Generator,
                    do_checks: bool = True) -> Tuple[torch.Tensor, List[int]]:
        """One SplitFuse step: forward + on-device sampling.  Returns
        (device token array int32, output row per input).  Rows still
        mid-prefill sample garbage the caller ignores."""
        descs = self._admit_batch(batch_uids, batch_tokens, do_checks)
        dec_idx = [i for i, t in enumerate(batch_tokens) if len(t) == 1]
        pre_idx = [i for i, t in enumerate(batch_tokens) if len(t) > 1]
        kv = self._state.kv_cache.data

        if not dec_idx or not pre_idx:       # single-geometry step
            batch = self._build_batch(descs, batch_tokens)
            temps, top_ks, top_ps = self._pad_sample_params(
                row_params, batch.num_slots)
            greedy_only = not bool((temps > 0.0).any())
            tokens = self._model.sample_step(batch, kv, generator, temps,
                                             top_ks, top_ps, greedy_only)
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
        greedy_only = not bool((temps > 0.0).any())
        tokens = self._model.sample_step_mixed(dec, pre, kv, generator, temps,
                                               top_ks, top_ps, greedy_only)
        self._commit_batch(descs)
        return tokens, row_of_input

    def step_decode_chained(self, batch_uids: Sequence[int],
                            prev_tokens: torch.Tensor,
                            gather_idx: Sequence[int],
                            row_params: Sequence[SamplingParams],
                            generator: torch.Generator) -> torch.Tensor:
        """Decode step whose input tokens are gathered ON THE DEVICE from
        the previous step's tokens (``prev_tokens``, possibly still being
        computed): row i continues the sequence in row ``gather_idx[i]``
        of the previous step's output.  No host sync on this path: the
        async scheduler drains step k while step k+1 runs."""
        placeholder_toks = [np.zeros(1, np.int32)] * len(batch_uids)
        descs = self._admit_batch(batch_uids, placeholder_toks,
                                  do_checks=False)
        batch = self._build_batch(descs, placeholder_toks)
        temps, top_ks, top_ps = self._pad_sample_params(
            row_params, batch.num_slots)
        greedy_only = not bool((temps > 0.0).any())
        gather = np.zeros(batch.num_slots, np.int32)
        gather[:len(batch_uids)] = np.asarray(gather_idx, np.int32)
        tokens = self._model.chained_step(
            batch, self._state.kv_cache.data, prev_tokens, gather,
            generator, temps, top_ks, top_ps, greedy_only)
        self._commit_batch(descs)
        return tokens

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
        return self._state.match_prefix(
            sd, np.asarray(prompt, dtype=np.int32).reshape(-1))

    def reset_prefix_cache(self) -> None:
        """Drop every cache entry and return parked pages to the pool (a
        cold start)."""
        self._state.reset_prefix_cache()

    def flush(self, uid: int) -> None:
        self._state.flush_sequence(uid)

    def offload_sequence(self, uid: int) -> None:
        """Preempt a sequence: its private KV pages move to host memory
        and return to the pool.  It cannot be stepped until
        ``restore_sequence``."""
        self._state.offload_sequence(uid)

    def restore_sequence(self, uid: int) -> None:
        """Bring a preempted sequence's KV back into fresh pages (raises
        ``KVAllocationError`` when the pool lacks them)."""
        self._state.restore_sequence(uid)
