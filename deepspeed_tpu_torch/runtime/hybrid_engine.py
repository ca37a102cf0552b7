"""Hybrid engine: one set of weights for training and for rollouts (RLHF).

Counterpart of ``deepspeed_tpu/runtime/hybrid_engine.py`` (:34-126), the
DeepSpeed-Chat actor: train, generate rollouts from the current weights,
train again.  ``train_batch`` is the training engine's; ``generate``
runs the ragged v2 engine (``InferenceEngineV2`` over a
``RaggedInferenceModel``) on the masters cast to the compute dtype.

Two things differ from the JAX engine, each forced by eager CUDA:

* **The refresh copies in place.**  JAX rebinds the rollout model's
  params to the new cast tree (sound under ``jit``, which takes them as
  arguments).  Here every step key's CUDA graph holds the addresses of
  the rollout model's tensors, so a rebind would replay the old weights.
  The rollout engine is built once; each later refresh ``copy_``s the
  masters into the rollout model's own tensors (a cast per leaf, the
  rounding of the training step's compute copy; norm vectors and biases
  stay fp32, as the serving norm kernels take them, where JAX casts them
  too), so every data pointer and every captured graph stays valid.  ``refresh_seconds`` times it.
  The refresh also drops the prefix cache: its pages hold KV computed
  under the old weights, which a rollout of the same prompts would
  otherwise reuse (the JAX engine keeps them; ROADMAP Queue 3).
* **The KV pool leaves the training step its memory.**  The rollout
  engine sizes its pool from ``state_manager.memory_fraction`` of the
  free device memory, as in JAX, where free memory is the card's less
  what is live.  PyTorch allocates the optimizer's moments at the first
  update and a step's compute copy, gradients and activations while it
  runs; a pool sized without them takes what the next step needs.  So
  the hybrid engine creates the optimizer's state at build (JAX's optax
  state exists from the engine's build on), and when it builds the pool
  it first measures a step's transient bytes with one forward and
  backward at the micro-batch size and the model's longest sequence
  (``train_transient_bytes``), then holds that many bytes while the pool
  is sized.  The fraction then applies to the rest (ROADMAP Queue 3,
  "Where the port's arithmetic differs").

``hybrid_engine.max_out_tokens``, ``inference_tp_size``,
``release_inference_cache``, ``pin_parameters`` and
``tp_gather_partition_size`` are accepted and read by nothing, as in
JAX; the config's ``serving_optimization`` section goes to the rollout
engine (``to_v2_dict``).
"""

from __future__ import annotations

import time
from typing import List, Optional, Sequence

import torch

from ..ops.fused_optimizer import PortOptimizer
from ..models.transformer import cast_params
from ..tree import tree_leaves
from ..utils.logging import log_dist
from .engine import DeepSpeedEngine


class DeepSpeedHybridEngine(DeepSpeedEngine):
    """Training engine with in-place rollout generation."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        if self._multi:
            raise NotImplementedError(
                "the hybrid engine across ranks (rollouts over sharded "
                "weights) is not in the port yet (ROADMAP Queue 1 item 4)")
        if not hasattr(self.module, "cfg"):
            raise ValueError(
                "hybrid engine needs a transformer model exposing .cfg "
                "(TransformerConfig) for the inference path")
        self._inflight_engine = None
        self._inference_params_step = -1
        self._in_eval = False
        self._generate_latency = 0.0
        self._generate_tokens = 0
        #: seconds the last weight refresh took (the build on the first)
        self.refresh_seconds = 0.0
        #: bytes a training step allocates above what is live, measured
        #: when the pool is sized (on the card; None before and elsewhere)
        self.train_transient_bytes: Optional[int] = None
        if isinstance(self.optimizer, PortOptimizer):
            for group in self.optimizer.param_groups:
                for p in group["params"]:
                    state = self.optimizer.state[p]
                    if not state:
                        self.optimizer._init_state(p, state)

    # ----------------------------------------------------------- modes
    def eval(self) -> "DeepSpeedHybridEngine":
        self._in_eval = True
        return super().eval()

    def train(self, mode: bool = True) -> "DeepSpeedHybridEngine":
        self._in_eval = not mode
        return super().train(mode)

    # ------------------------------------------------------- inference
    def _cast_masters(self):
        """The masters as the rollout model holds them: the compute dtype,
        norm vectors and biases fp32 (``cast_params``)."""
        return cast_params(self.params, self.compute_dtype, copy=True)

    def _step_transient_bytes(self) -> Optional[int]:
        """Bytes a training step allocates above what is live: one forward
        and backward on token 0 at the micro-batch size and the model's
        longest sequence, the most a step's activations can take.  The
        probe's gradients are dropped; the masters, the accumulators, the
        optimizer's state and the step counters are left as they were.
        On the card the measure is the peak allocation after the probe
        less what was live before it.  The peak counter is not reset, so
        a caller's own accounting stands: the measure is exact when the
        probe sets the process's peak, as it does unless something larger
        ran earlier and freed its memory, and an upper bound otherwise.
        None off the card, which reports no memory."""
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
            start = torch.cuda.memory_allocated(self.device)
        ids = torch.zeros((self.train_micro_batch_size_per_gpu(),
                           self.module.cfg.max_seq_len), dtype=torch.int32,
                          device=self.device)
        kept, self._params_c = self._params_c, None
        try:
            params = self._compute_params()
            self.module.loss(params, {"input_ids": ids,
                                      "labels": ids}).backward()
        finally:
            self._params_c = kept
        del params
        if not cuda:
            return None
        torch.cuda.synchronize(self.device)
        return torch.cuda.max_memory_allocated(self.device) - start

    def _build_inference_engine(self):
        from ..inference.v2.config import RaggedInferenceEngineConfig
        from ..inference.v2.engine import InferenceEngineV2
        from ..inference.v2.model import RaggedInferenceModel
        self.train_transient_bytes = self._step_transient_bytes()
        model = RaggedInferenceModel(self.module.cfg, self._cast_masters(),
                                     device=self.device)
        v2cfg = RaggedInferenceEngineConfig.from_dict({
            "serving_optimization":
                self.config.serving_optimization.to_v2_dict()})
        reserve = None
        if self.train_transient_bytes is not None:
            # held while the pool is sized, so memory_fraction applies
            # to the memory the training step leaves
            reserve = torch.empty(self.train_transient_bytes,
                                  dtype=torch.uint8, device=self.device)
        engine = InferenceEngineV2(model, v2cfg)
        del reserve
        return engine

    def _inference_engine(self):
        """The rollout engine, its weights refreshed when a step changed
        the masters."""
        if self._inflight_engine is not None and \
                self._inference_params_step == self.global_steps:
            return self._inflight_engine
        t0 = time.perf_counter()
        if self._inflight_engine is None:
            self._inflight_engine = self._build_inference_engine()
        else:
            dst = tree_leaves(self._inflight_engine.model.params)
            with torch.no_grad():
                for d, m in zip(dst, self._masters, strict=True):
                    d.copy_(m)
            self._inflight_engine.reset_prefix_cache()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.refresh_seconds = time.perf_counter() - t0
        self._inference_params_step = self.global_steps
        return self._inflight_engine

    def generate(self, prompts: Sequence[Sequence[int]],
                 max_new_tokens: int = 64,
                 temperature: float = 1.0,
                 top_k: int = 0, top_p: float = 1.0,
                 do_sample: bool = True,
                 eos_token_id: Optional[int] = None) -> List[List[int]]:
        """Rollouts from the current training weights."""
        from ..inference.v2.sampling import SamplingParams
        from ..inference.v2.scheduler import generate as ragged_generate

        engine = self._inference_engine()
        t0 = time.perf_counter()
        outs = ragged_generate(
            engine, [list(map(int, p)) for p in prompts],
            SamplingParams(
                max_new_tokens=int(max_new_tokens),
                temperature=float(temperature) if do_sample else 0.0,
                top_k=int(top_k), top_p=float(top_p),
                stop_token=eos_token_id))
        dt = time.perf_counter() - t0
        n_tok = sum(len(o) for o in outs)
        self._generate_latency += dt
        self._generate_tokens += n_tok
        log_dist(f"hybrid generate: {n_tok} tokens in {dt:.2f}s "
                 f"({n_tok / max(dt, 1e-9):.1f} tok/s)", ranks=[0])
        return outs

    # ------------------------------------------------------ train hook
    def train_batch(self, *args, **kwargs):
        loss = super().train_batch(*args, **kwargs)
        # any step invalidates the rollout weights
        self._inference_params_step = -1
        return loss

    def generate_throughput(self) -> float:
        return self._generate_tokens / max(self._generate_latency, 1e-9)
