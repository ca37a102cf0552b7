"""Inference engine v1 (the ``init_inference`` path).

Counterpart of ``deepspeed_tpu/inference/engine.py`` (``InferenceConfig``
:49, ``DTYPES`` :70, ``InferenceEngine`` :75-193): a model, given as a
``(TransformerConfig, params)`` pair, one of the port's ``CausalLM``
models or a ``transformers`` model, behind a guarded ``generate()`` and a
dense ``forward()``.  Generation runs on the ragged v2 engine
(``RaggedInferenceModel`` and ``InferenceEngineV2``: paged KV, the fused
serving step, one CUDA graph per step key on the card); ``forward`` gives
``[B, S, V]`` fp32 logits through ``models/transformer.py``'s forward
(on the card the flash-forward kernel).  The floating weights are cast to
the engine's dtype once at build, where the JAX engine casts them inside
each compiled step: the same rounding, without a cast copy a step
(norm vectors and biases stay fp32, as the serving norm kernels take
them).

``fp16`` and ``float16`` map to bf16, as in JAX's ``DTYPES`` (the port
has no fp16 kernel).  An unknown config key warns and is dropped.  This
slice serves on one card: ``tensor_parallel.tp_size`` above 1 raises,
naming ROADMAP Queue 1 item 13.
"""

from __future__ import annotations

import dataclasses
from typing import Any, List, Optional, Sequence, Union

import numpy as np
import torch

from ..accelerator import DeviceLike, resolve_device
from ..models import transformer as T
from ..runtime.config import outside_slice
from ..utils.logging import log_dist, logger
from .v2.config import RaggedInferenceEngineConfig
from .v2.engine import InferenceEngineV2
from .v2.model import RaggedInferenceModel
from .v2.sampling import SamplingParams
from .v2.scheduler import generate as _ragged_generate


@dataclasses.dataclass
class DeepSpeedTPConfig:
    enabled: bool = True
    tp_size: int = 1


@dataclasses.dataclass
class InferenceConfig:
    """The keys the v1 engine reads (JAX ``InferenceConfig``)."""
    dtype: str = "bfloat16"
    tensor_parallel: DeepSpeedTPConfig = dataclasses.field(
        default_factory=DeepSpeedTPConfig)
    replace_with_kernel_inject: bool = False
    max_out_tokens: int = 1024
    min_out_tokens: int = 1
    max_tokens_per_batch: int = 2048
    kv_cache_pages: Optional[int] = None
    #: accepted: on the card every step key is a CUDA graph already
    enable_cuda_graph: bool = False

    def __post_init__(self):
        if isinstance(self.tensor_parallel, dict):
            self.tensor_parallel = DeepSpeedTPConfig(**self.tensor_parallel)
        elif self.tensor_parallel is None:
            self.tensor_parallel = DeepSpeedTPConfig()


DTYPES = {"float32": torch.float32, "fp32": torch.float32,
          "bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
          "float16": torch.bfloat16, "fp16": torch.bfloat16}


class InferenceEngine:
    """v1 engine: ``generate()`` and ``forward()`` over one model."""

    def __init__(self, model: Any = None, config: Any = None,
                 device: DeviceLike = None, **kwargs):
        if isinstance(config, InferenceConfig):
            self.config = config
        else:
            cfg_dict = dict(config or {})
            cfg_dict.update(kwargs)
            known = {f.name for f in dataclasses.fields(InferenceConfig)}
            for k in [k for k in cfg_dict if k not in known]:
                logger.warning("init_inference: ignoring config key %r", k)
                cfg_dict.pop(k)
            self.config = InferenceConfig(**cfg_dict)
        dtype = DTYPES[self.config.dtype.lower()]
        self.device = resolve_device(device)

        tp = max(1, self.config.tensor_parallel.tp_size)
        if tp > 1:
            raise NotImplementedError(
                f"init_inference at tensor_parallel.tp_size {tp} is not "
                "ported yet: the port serves on one card (ROADMAP Queue 1 "
                "item 13)")

        if isinstance(model, tuple) and len(model) == 2:
            tcfg, params = model          # a loaded (cfg, params) pair
        elif isinstance(model, T.CausalLM):
            tcfg, params = model.cfg, model.init_params(0, self.device)
        else:
            from ..checkpoint.hf import from_pretrained
            tcfg, params = from_pretrained(model, dtype=dtype,
                                           device=self.device)
        if tcfg.dtype != dtype:
            tcfg = dataclasses.replace(tcfg, dtype=dtype)
        self.module_config = tcfg
        params = T.cast_params(params, dtype, self.device)

        self._model = RaggedInferenceModel(tcfg, params, device=self.device)
        v2cfg = RaggedInferenceEngineConfig()
        if self.config.kv_cache_pages:
            v2cfg.kv_cache.num_pages = self.config.kv_cache_pages
        self._engine = InferenceEngineV2(self._model, v2cfg)
        self.module = self._model
        log_dist(f"init_inference: tp={tp} dtype={self.config.dtype} "
                 f"layers={tcfg.num_layers} heads={tcfg.num_heads}",
                 ranks=[0])

    # ------------------------------------------------------------ forward
    def forward(self, input_ids, attention_mask=None) -> torch.Tensor:
        """Dense fp32 logits [B, S, V] (an HF-style forward for
        scoring)."""
        cfg = self._model.cfg
        if cfg.moe_num_experts > 0:
            raise outside_slice("the dense forward of an MoE model",
                                "11h (pipeline, MoE)")
        ids = torch.as_tensor(np.asarray(input_ids)).to(self.device)
        if ids.dim() == 1:
            ids = ids[None]
        if attention_mask is not None:
            attention_mask = torch.as_tensor(
                np.asarray(attention_mask)).to(self.device)
        with torch.no_grad():
            return T.forward(cfg, self._model.params, ids.long(),
                             attention_mask=attention_mask)

    __call__ = forward

    # ----------------------------------------------------------- generate
    def generate(self,
                 input_ids: Union[Sequence[Sequence[int]], Any],
                 max_new_tokens: int = 64,
                 max_length: Optional[int] = None,
                 do_sample: bool = False,
                 temperature: float = 1.0,
                 top_k: int = 0,
                 top_p: float = 1.0,
                 eos_token_id: Optional[int] = None,
                 **ignored) -> List[List[int]]:
        """Batch generation with JAX's guard rails: ``max_length`` caps
        each sequence's total length (a per-prompt budget), and a budget
        above ``max_out_tokens`` raises ``ValueError``."""
        prompts = self._normalize_prompts(input_ids)
        if max_length is not None:
            budgets = [max(self.config.min_out_tokens, max_length - len(p))
                       for p in prompts]
        else:
            budgets = [int(max_new_tokens)] * len(prompts)
        for b in budgets:
            if b > self.config.max_out_tokens:
                raise ValueError(
                    f"max_new_tokens {b} exceeds engine "
                    f"max_out_tokens {self.config.max_out_tokens}")
        params = [SamplingParams(
            max_new_tokens=int(b),
            temperature=float(temperature) if do_sample else 0.0,
            top_k=int(top_k), top_p=float(top_p),
            stop_token=eos_token_id) for b in budgets]
        return _ragged_generate(self._engine, prompts, params,
                                token_budget=self.config.max_tokens_per_batch)

    @staticmethod
    def _normalize_prompts(input_ids) -> List[List[int]]:
        if isinstance(input_ids, torch.Tensor):
            input_ids = input_ids.cpu().numpy()
        arr = np.asarray(input_ids, dtype=object) \
            if isinstance(input_ids, (list, tuple)) else np.asarray(input_ids)
        if arr.dtype != object and arr.ndim == 1:
            return [list(map(int, arr))]
        if arr.dtype != object and arr.ndim == 2:
            return [list(map(int, row)) for row in arr]
        return [list(map(int, p)) for p in input_ids]

    # ------------------------------------------------------- profiling API
    def profile_model_time(self, use_cuda_events: bool = False):
        self._profile = True

    def flush(self) -> None:
        for uid in list(self._engine.state_manager._seqs):
            self._engine.flush(uid)
