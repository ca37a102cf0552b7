"""InferenceEngineV2 — ragged continuous-batching inference engine.

Counterpart of ``deepspeed_tpu/inference/v2/engine.py`` for the fused
serving path: ``put(uids, tokens)`` runs ONE ragged forward returning
last-token logits per sequence; ``step_sample`` runs forward + on-device
sampling, so only int32 tokens cross device->host; ``query`` /
``can_schedule`` expose KV and token occupancy to the scheduler;
``flush(uid)`` frees sequence state.  A step mixing decode rows with
prefill chunks runs as two segments ([S_d, 1] + [S_p, Q]) so decode
rows never pad to the chunk width.  The engine builds the KV cache: fp
pages, or int8 ``KVPages`` when ``serving.kv_quantization`` says so.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from .config import RaggedInferenceEngineConfig
from .model import RaggedInferenceModel
from .ragged import KVCacheConfig, StateManager, build_batch, placeholder
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


class InferenceEngineV2:
    def __init__(self, model: RaggedInferenceModel,
                 config: Optional[RaggedInferenceEngineConfig] = None):
        self._config = config or RaggedInferenceEngineConfig()
        self._config.serving.validate()
        self._model = model
        model.kv_config = self._resolve_kv_config(model)
        self._state = StateManager(
            model.kv_config, model.device,
            max_tracked_sequences=self._config.state_manager.max_tracked_sequences)

    def _resolve_kv_config(self, model: RaggedInferenceModel) -> KVCacheConfig:
        """The cache the engine builds: the model's page geometry and
        dtype (given or default), with the serving knob
        ``kv_quantization`` in place of the model's cache encoding (it is
        an encoding, not geometry)."""
        quant = self._config.serving.kv_quantization or "none"
        return dataclasses.replace(model.kv_config, quantization=quant)

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

    @staticmethod
    def _commit_batch(descs) -> None:
        for sd in descs:
            sd.post_forward()

    def _build_batch(self, descs, tokens):
        return build_batch(
            descs, [np.asarray(t) for t in tokens],
            self._model.kv_config.page_size,
            fresh_supported=self._model._fresh_attention is not None)

    def put(self, batch_uids: Sequence[int],
            batch_tokens: Sequence[np.ndarray],
            do_checks: bool = True) -> torch.Tensor:
        """One ragged forward; returns fp32 logits [len(batch_uids), V]
        in input order, on the model's device."""
        descs = self._admit_batch(batch_uids, batch_tokens, do_checks)
        batch = self._build_batch(descs, batch_tokens)
        logits = self._model.forward(batch, self._state.kv_cache.data)
        self._commit_batch(descs)
        return logits[:len(batch_uids)]

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

    def flush(self, uid: int) -> None:
        self._state.flush_sequence(uid)
