"""Inference-v2 engine configuration.

The subset of ``deepspeed_tpu/inference/v2/config.py`` the port reads.
:class:`ServingOptimizationConfig` has the JAX package's defaults:
``fused_step=True, on_device_sampling=True, async_scheduling=True,
prefix_caching=True, speculative=False, tp_degree=1,
keyed_sampling=False``, and the degradation knobs off.  Speculative
decoding takes JAX's knobs (``spec_max_draft``, ``spec_ngram_min``,
``spec_drafter``, ``spec_draft_layers``) with JAX's defaults, and
``keyed_sampling=True`` is served: every sampled token is drawn from a
key that is a pure function of (seed, request uid, position), as in the
JAX package, which makes sampled streams schedule-invariant and lets a
snapshot resume sampled requests exactly.  The snapshot knobs are JAX's
(``snapshot_grace_s``, ``snapshot_path``), and so are the cold-start
and tier knobs: ``lattice`` (``"auto:<artifact-or-trace>"``, a mined
bucket lattice), ``compile_cache_dir`` (where the kernel libraries are
built and loaded) and ``kv_tier_host_pages`` / ``kv_tier_disk_pages`` /
``kv_tier_dir`` (the prefix cache's host and disk tier).
:class:`TelemetryConfig` has every field of the JAX package's
``telemetry`` block, and :class:`FaultInjectionConfig` its
``fault_injection`` block (both applied at engine build).  ``role`` ("both", "prefill" or "decode") splits serving across
a prefill and a decode engine (``serving.DisaggPool``).  ``tp_degree`` stays at 1
(another value raises, naming the ROADMAP item that brings it).  The KV
cache geometry
is the model's ``kv_config`` when the model was given one, else
:class:`KVCacheUserConfig`'s, whose ``num_pages=None`` sizes the pool
from free device memory.  :class:`QuantizationConfig` turns on
weight-only quantised serving (fp8, fp6, fp4 or int8 weights), and
:meth:`RaggedInferenceEngineConfig.from_dict` reads the JAX package's
dict form.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ...runtime.config import FaultInjectionConfig, TelemetryConfig  # noqa: F401


@dataclasses.dataclass
class StateManagerConfig:
    max_tracked_sequences: int = 2048
    max_ragged_sequence_count: int = 512
    max_ragged_batch_size: int = 768       # token budget per forward
    memory_fraction: float = 0.8           # of free device memory, for KV


@dataclasses.dataclass
class KVCacheUserConfig:
    """The KV pool of a model built without ``kv_config``."""
    page_size: int = 64
    #: None: as many pages as ``memory_fraction`` of the free device
    #: memory holds (on the CPU, which reports none, the model's default)
    num_pages: Optional[int] = None
    dtype: torch.dtype = torch.bfloat16


@dataclasses.dataclass
class QuantizationConfig:
    """Weight-only quantised serving (reference v2 core_ops FP6/FP8
    quantized GEMM + ``quantization_mode``): with ``enabled`` the engine
    quantises the model's projection weights channelwise into ``fmt``
    (``RaggedInferenceModel.quantize_weights``) before it sizes the KV
    pool."""
    enabled: bool = False
    fmt: str = "fp8_e4m3"   # fp8_e4m3|fp8_e5m2|fp6_e3m2|fp6_e2m3|fp4_e2m1|int8


# flag -> (the one value the port runs, ROADMAP Queue 1 item)
_FIXED_SERVING_FLAGS = {
    "tp_degree": (1, "13 (tensor-parallel serving)"),
}


@dataclasses.dataclass
class ServingOptimizationConfig:
    """Serving-step knobs.  The fixed fields exist so a configuration
    written for the JAX package says what it expects, and
    :meth:`validate` (run at construction and again at engine build)
    raises ``NotImplementedError`` for a value the port does not run."""
    #: one step graph for a mixed prefill + decode step (off: the split
    #: escape hatch, one logits forward per Q bucket and sampling outside
    #: the step)
    fused_step: bool = True
    #: sample inside the step graph, so only int32 tokens reach the host
    #: (off: [S, V] fp32 logits come out of the step and are sampled
    #: in calls of their own, one per parameter group)
    on_device_sampling: bool = True
    #: double-buffered scheduler: step k+1 (a chained decode step whose
    #: tokens are gathered on the device) is dispatched before step k's
    #: tokens are read, so tokens reach the host one step late
    async_scheduling: bool = True
    #: automatic prefix cache over the paged KV pool: full prompt pages
    #: are shared across sequences and kept after they finish (LRU
    #: eviction under pool pressure), so a warm prefix is not prefilled
    #: again.  Fixed at engine build
    prefix_caching: bool = True
    #: speculative decoding: draft up to ``spec_max_draft`` tokens per
    #: decode row and verify them all in one Q = 1 + spec_max_draft
    #: step; the accepted drafts commit as a block in the same scheduler
    #: step.  Greedy tokens are those of the step without it.  Served
    #: only with ``fused_step`` and ``on_device_sampling`` (the split
    #: step never speculates)
    speculative: bool = False
    #: drafted tokens per decode row per step
    spec_max_draft: int = 3
    #: shortest trailing n-gram the prompt-lookup drafter matches on
    #: (longer ones are tried first)
    spec_ngram_min: int = 2
    #: "ngram" (host prompt lookup), "model" (a draft trunk drafts on
    #: the device inside the verify step, from a KV pool of its own) or
    #: "auto" (per request: ngram -> model -> off on the accept rate).
    #: "model" and "auto" build the draft trunk and its pool at engine
    #: build; another name raises ``ValueError`` there
    spec_drafter: str = "ngram"
    #: the draft trunk: the first ``spec_draft_layers`` target layers
    #: (embedding, final norm and lm head shared); 0 = every layer (the
    #: self-draft)
    spec_draft_layers: int = 0
    #: scheduler role: "both" (one engine prefills and decodes),
    #: "prefill" (prompt chunks and the FIRST token only; a finished
    #: prefill parks handoff-ready for a ``serving.DisaggPool`` to stream
    #: to a decode engine) or "decode" (admits handoff imports only: a
    #: plain submit ends with ``RequestError(code="misrouted")``).
    #: Another value raises ``ValueError`` when a scheduler is built
    role: str = "both"
    tp_degree: int = 1
    #: schedule-invariant sampling: a sampled row draws from
    #: ``fold_in(fold_in(key(seed), uid), position)``, so a request's
    #: sampled tokens do not depend on the batch, the step kind or the
    #: engine that samples them.  Fixed at engine build (it adds the
    #: uid and position inputs to every sampling step)
    keyed_sampling: bool = False
    #: KV page storage format: "none" (fp pages at the cache dtype) or
    #: "int8" (block-scaled codes + one fp32 scale per head_dim block).
    #: Fixed at engine build: it shapes the cache tensors.  An unknown
    #: format raises ``ValueError`` there (``KVCacheConfig``)
    kv_quantization: str = "none"
    #: graceful degradation, 0 / False = off.  Submits past this many
    #: pending requests are shed with a structured error (0: unbounded)
    max_queue_depth: int = 0
    #: shed a submit while the oldest pending request has waited longer
    #: than this (ms; 0: off)
    shed_queue_wait_ms: float = 0.0
    #: default per-request TTL in seconds; an expired request ends with a
    #: structured error (0: no deadline)
    default_ttl_s: float = 0.0
    #: where the scheduler would deadlock, shed the most demanding
    #: request with an "oom" error instead of raising
    shed_unservable: bool = False
    #: grace budget in seconds of the SIGTERM drain -> snapshot path;
    #: past it the live requests end with a "migrated" error
    snapshot_grace_s: float = 5.0
    #: the bundle the SIGTERM handler writes (with DS_DRAIN_ON_SIGTERM=1
    #: in the environment); empty: explicit ``snapshot()`` calls only
    snapshot_path: str = ""
    #: where the kernel libraries are built and loaded ("": the default
    #: ``build/kernels/``; DS_COMPILE_CACHE in the environment wins).
    #: Entries are namespaced by a digest of what a library depends on
    #: (sources, nvcc, arch, torch), so a second process loads them
    #: instead of building; an unwritable directory warns and builds
    #: into the default (``compile_cache.py``)
    compile_cache_dir: str = ""
    #: bucket lattice: "" = the power-of-two default; "auto:<path>" takes
    #: a mined lattice artifact or a raw workload trace (mined at build):
    #: bucket tops fitted to the traffic, fewer padded rows, the same
    #: tokens.  A geometry digest mismatch raises LatticeError at build
    lattice: str = ""
    #: host prefix tier: parked pages that eviction would free are
    #: demoted into a bounded host ring of this many pages (0 = off),
    #: keyed by the prefix cache's chained digests, and promoted back on
    #: a prefix match.  Needs ``prefix_caching``
    kv_tier_host_pages: int = 0
    #: disk tier below the host ring (pages; 0 = off): the ring's
    #: overflow spills to files in ``kv_tier_dir``
    kv_tier_disk_pages: int = 0
    #: the disk tier's directory ("" = a temporary directory of the
    #: process, removed with the store)
    kv_tier_dir: str = ""

    def __post_init__(self):
        self.validate()

    def validate(self) -> None:
        for flag, (value, item) in _FIXED_SERVING_FLAGS.items():
            if getattr(self, flag) != value:
                raise NotImplementedError(
                    f"serving_optimization.{flag}={getattr(self, flag)!r} "
                    f"is not ported yet: the port runs {flag}={value!r} "
                    f"(ROADMAP Queue 1 item {item})")


@dataclasses.dataclass
class RaggedInferenceEngineConfig:
    state_manager: StateManagerConfig = dataclasses.field(
        default_factory=StateManagerConfig)
    kv_cache: KVCacheUserConfig = dataclasses.field(
        default_factory=KVCacheUserConfig)
    quantization: QuantizationConfig = dataclasses.field(
        default_factory=QuantizationConfig)
    serving: ServingOptimizationConfig = dataclasses.field(
        default_factory=ServingOptimizationConfig)
    telemetry: TelemetryConfig = dataclasses.field(
        default_factory=TelemetryConfig)
    fault_injection: FaultInjectionConfig = dataclasses.field(
        default_factory=FaultInjectionConfig)

    @classmethod
    def from_dict(cls, d: dict) -> "RaggedInferenceEngineConfig":
        """The JAX package's dict form: ``state_manager``, ``kv_cache``,
        ``quantization``, ``serving_optimization`` (``enabled: false``
        turns the fused step, on-device sampling, the async chain and
        prefix caching off), ``telemetry`` and ``fault_injection``
        (applied at engine build); unknown keys inside a block are
        ignored, as in JAX.  ``tensor_parallel.tp_size`` other than 1
        raises, naming its ROADMAP item."""
        cfg = cls()
        for block, target in (("state_manager", cfg.state_manager),
                              ("kv_cache", cfg.kv_cache),
                              ("quantization", cfg.quantization)):
            for k, v in d.get(block, {}).items():
                if hasattr(target, k):
                    setattr(target, k, v)
        srv = d.get("serving_optimization", {})
        if not srv.get("enabled", True):
            # the master escape hatch wins over individual flags
            cfg.serving = ServingOptimizationConfig(
                fused_step=False, on_device_sampling=False,
                async_scheduling=False, prefix_caching=False)
        else:
            for k, v in srv.items():
                if hasattr(cfg.serving, k):
                    setattr(cfg.serving, k, v)
        for block, target in (("telemetry", cfg.telemetry),
                              ("fault_injection", cfg.fault_injection)):
            for k, v in d.get(block, {}).items():
                if hasattr(target, k):
                    setattr(target, k, v)
        cfg.serving.validate()
        if d.get("tensor_parallel", {}).get("tp_size", 1) != 1:
            raise NotImplementedError(
                "tensor_parallel.tp_size other than 1 is not ported yet "
                "(ROADMAP Queue 1 item 13)")
        return cfg
