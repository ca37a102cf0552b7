"""Training config: the subset of the DeepSpeed-style config the port's
training slice reads.

Counterpart of ``deepspeed_tpu/runtime/config.py`` (``OptimizerParams``
:41, ``BF16Config`` :71, ``ZeroConfig`` :110, ``gradient_clipping``
:597, ``precision_dtype`` :686,
``resolve_batch_sizes`` :652), as plain dataclasses.  A config is a dict
or a JSON path with the keys users already write.  The slice is one
device or a process mesh (below); bf16 (fp32 masters and fp32 gradient accumulation, or pure bf16
with ``bf16.master_weights`` / ``accumulate_grads_in_fp32`` false), fp16
(``FP16Config``: static or dynamic loss scaling; the compute runs in
bf16, as in the JAX engine) or fp32; every optimizer name of the JAX
factory; the five LR schedules; ZeRO stages 0 to 3 and ZeRO++
quantised weights.  A key that switches on a feature outside the slice
raises ``NotImplementedError`` naming its ROADMAP item; a key the port
does not know raises too, so no setting is silently dropped.

Every top-level field of the JAX ``DeepSpeedTPUConfig`` is read; only
an ``_OUTSIDE_SLICE`` section that is switched on raises.
``sparse_gradients`` gives the embedding the sparse backward
(``runtime/sparse_tensor.py``); ``prescale_gradients``,
``gradient_predivide_factor`` and ``communication_data_type`` are read
by the engine's accessors only, and so are ``elasticity`` and
``autotuning`` (the JAX launcher acts on them); ``comms_logger``
configures the comms logger at engine build; ``hybrid_engine.enabled``
makes ``initialize`` build the hybrid engine, whose rollout engine takes
``serving_optimization`` (``to_v2_dict``); ``dump_state``,
``disable_allgather`` and ``seq_parallel_communication_data_type`` are
top-level ``NOOP_KEYS``.

``flops_profiler`` (``FlopsProfilerConfig``) and ``data_efficiency``
(its ``data_sampling`` and ``data_routing`` dicts, read by the engine's
accessors only, as in JAX) are read; ``tpu.param_dtype`` and
``tpu.compute_dtype`` are parsed and read by nothing, as in the JAX
engine, whose dtypes come from the precision sections;
``tpu.matmul_precision`` sets ``torch.set_float32_matmul_precision``
at every engine build (``"default"`` resets it to PyTorch's
``"highest"``).

The loader also reads the ``checkpoint``
section (JAX ``CheckpointConfig``: ``async_save``, ``save_retries``,
``save_backoff_s``, ``load_universal``; ``tag_validation``,
``use_node_local_storage`` and ``parallel_write`` are accepted and, as
in JAX, change nothing), ``fault_tolerance`` (self-healing training),
``fault_injection`` and ``telemetry`` (the serving engine's blocks, with
the JAX fields), ``wall_clock_breakdown`` and the monitor sections
``tensorboard``, ``wandb``, ``csv_monitor`` and ``comet``.  A key the
port does not know inside one of them raises like any other.

The memory slice reads ``zero_optimization.offload_optimizer`` (cpu or
nvme: fp32 masters and moments of the offloaded leaves live on the host
and step in the host kernels, ``runtime/zero/offload.py``) and
``offload_param`` (parsed and read by nothing, as in the JAX engine),
the ``aio`` section (the NVMe tier's I/O pool), ``activation_checkpointing``
and the ``tpu`` model keys ``scan_layers``, ``remat``, ``remat_policy``
and ``attention_impl`` (the engine applies them to the model's config as
JAX ``engine.py:288-345`` does), and ``memory_breakdown``.  The host
optimizers' names (``cpuadam``, ``cpulion``, ...) run AdamW and Lion on
the device; Adagrad and ``adam_w_mode=False`` have host kernels only and
raise unless every leaf is offloaded.  The keys of ``NOOP_KEYS`` are
accepted and the engine warns that they change nothing, as JAX's do.

ZeRO across ranks: ``zero_optimization.stage`` 1-3 partition masters,
moments, gradients and (stage 3) parameters over the ``fsdp`` axis of
the process mesh (``tpu.mesh`` with ``data``, ``fsdp``, ``hpz``, ``seq``
and ``tensor``, the last two also from ``sequence_parallel.sp_size`` and
``tensor_parallel.tp_size`` when their sections are enabled; without a
data or fsdp axis, every free rank goes to ``fsdp`` from stage 1 and to
``data`` at stage 0, as JAX ``_topology_from_config`` lays it out;
``sequence_parallel.mode`` is ``"ulysses"`` or ``"ring"``), with ZeRO++
hpZ (``zero_hpz_partition_size``), MiCS (``mics_shard_size``), qgZ
(``zero_quantized_gradients``) and the ``comm_optimization`` scheduler.
At one rank the partition is the identity and stages 1-3 give stage
0's numbers, but for ``zero_quantized_weights`` (ZeRO++ qwZ) at stage
3: every floating leaf of two or more dimensions is snapped to the
blockwise int8 grid once per step before the compute cast (below stage
3 it changes nothing, as in JAX ``engine.py:641``).  The keys in
``ZERO_ONE_RANK_NOOPS`` are accepted and change nothing but the
accessors' values (``stage3_param_persistence_threshold`` also keeps
small leaves whole at stage 3 across ranks).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple, Union

#: optimizer names the slice runs, each through its fused kernel
ADAM_TYPES = ("adam", "adamw", "fusedadam")
LION_TYPES = ("lion", "fusedlion")
LAMB_TYPES = ("lamb", "fusedlamb")
#: the host optimizers' names: on the device they are AdamW and Lion
#: through the fused kernels (JAX ``runtime/optimizers.py:49-69``)
CPU_ADAM_TYPES = ("cpuadam", "deepspeedcpuadam")
CPU_LION_TYPES = ("cpulion",)
#: Adagrad has a host kernel only: it runs with every leaf offloaded
ADAGRAD_TYPES = ("adagrad", "cpuadagrad")

#: zero_optimization keys the engine's accessors read and its numbers do
#: not depend on (buckets, communication overlap, stage-3 prefetch; the
#: persistence threshold also keeps small leaves whole at stage 3)
ZERO_ONE_RANK_NOOPS = (
    "contiguous_gradients", "reduce_scatter", "reduce_bucket_size",
    "allgather_partitions", "allgather_bucket_size", "overlap_comm",
    "sub_group_size", "stage3_max_live_parameters",
    "stage3_max_reuse_distance", "stage3_prefetch_bucket_size",
    "stage3_param_persistence_threshold",
    "stage3_model_persistence_threshold",
    "stage3_gather_16bit_weights_on_model_save",
    "mics_hierarchical_params_gather", "round_robin_gradients",
    "memory_efficient_linear")


def outside_slice(what: str, item: str) -> NotImplementedError:
    """The error for a feature the port's training slice does not run;
    ``item`` names the ROADMAP Queue 1 entry that will bring it."""
    return NotImplementedError(
        f"{what} is not in the port's training slice yet "
        f"(ROADMAP Queue 1 item {item})")


def _enabled(section: Dict[str, Any]) -> bool:
    return bool(section.get("enabled", False))


# config section -> (does it switch a feature on?, ROADMAP Queue 1 item)
_OUTSIDE_SLICE = {
    "compression_training": (lambda s: any(s.values()),
                             "11e (compression)"),
    "pipeline": (lambda s: s.get("stages", 1) > 1,
                 "11h (pipeline, MoE)"),
    "moe": (_enabled, "11h (pipeline, MoE)"),
}

# read by the slice
_READ = ("train_batch_size", "train_micro_batch_size_per_gpu",
         "gradient_accumulation_steps", "gradient_clipping", "optimizer",
         "scheduler", "bf16", "fp16", "zero_optimization", "steps_per_print",
         "wall_clock_breakdown", "checkpoint", "fault_tolerance",
         "fault_injection", "telemetry", "tensorboard", "wandb",
         "csv_monitor", "comet", "aio", "activation_checkpointing", "tpu",
         "memory_breakdown", "flops_profiler", "data_efficiency",
         "prescale_gradients", "gradient_predivide_factor",
         "communication_data_type", "seq_parallel_communication_data_type",
         "sparse_gradients", "dump_state", "disable_allgather",
         "comms_logger", "hybrid_engine", "elasticity", "autotuning",
         "serving_optimization", "comm_optimization", "tensor_parallel",
         "sequence_parallel")

#: keys accepted for compatibility that change nothing, with the reason
#: logged when a config sets one (JAX ``config.py:_NOOP_KEYS``)
NOOP_KEYS = {
    ("zero_optimization", "overlap_comm"):
        "collectives run in the step's order (comm_optimization.overlap "
        "reduces per micro-batch)",
    ("zero_optimization", "contiguous_gradients"):
        "each leaf's gradient is one fp32 tensor already",
    ("zero_optimization", "reduce_bucket_size"):
        "gradients reduce leaf by leaf (comm_optimization sizes the "
        "quantized wire's buckets)",
    ("zero_optimization", "allgather_bucket_size"):
        "parameters gather leaf by leaf",
    ("zero_optimization", "round_robin_gradients"):
        "each rank reduces the same leaves in the same order",
    ("zero_optimization", "memory_efficient_linear"):
        "the remat policies cover it; see tpu.remat_policy",
    ("zero_optimization", "mics_hierarchical_params_gather"):
        "a MiCS gather is one all-gather over the shard group",
    ("activation_checkpointing", "contiguous_memory_optimization"):
        "PyTorch's caching allocator owns activation buffers",
    ("activation_checkpointing", "number_checkpoints"):
        "each transformer layer is the checkpoint unit",
    ("activation_checkpointing", "synchronize_checkpoint_boundary"):
        "eager stream order replaces manual syncs",
    ("activation_checkpointing", "profile"):
        "use the telemetry spans or torch.profiler",
    ("aio", "single_submit"):
        "the native pool always submits asynchronously",
    ("aio", "overlap_events"):
        "completion overlap is inherent to the thread pool",
    ("checkpoint", "use_node_local_storage"):
        "paths are the caller's; point save_dir at local disk",
    ("checkpoint", "parallel_write"):
        "one rank writes one file per kind",
    # top-level keys (section ""): parsed, and read by nothing in the JAX
    # engine either
    ("", "dump_state"):
        "engine.dump_state() logs the state whenever it is called",
    ("", "disable_allgather"):
        "one rank has no parameter all-gather to disable",
    ("", "seq_parallel_communication_data_type"):
        "the sequence-parallel collectives carry the activations' dtype",
}


@dataclasses.dataclass
class OptimizerParams:
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0
    #: SGD's momentum (0: none)
    momentum: float = 0.0
    #: parsed and read by nothing, as in the JAX factory
    bias_correction: bool = True
    #: False: coupled L2 decay (the decayed weights added to the gradient
    #: before Adam's moments)
    adam_w_mode: bool = True


@dataclasses.dataclass
class OptimizerConfig:
    type: str = "adamw"
    params: OptimizerParams = dataclasses.field(
        default_factory=OptimizerParams)


@dataclasses.dataclass
class SchedulerConfig:
    type: str = "WarmupLR"
    params: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class OffloadConfig:
    """``zero_optimization.offload_optimizer`` / ``offload_param`` (JAX
    ``OffloadConfig``): ``device`` none, cpu or nvme; ``nvme_path`` the
    NVMe tier's directory; ``ratio`` the share of parameter elements
    offloaded, largest leaves first (ZeRO-Offload++ Twin-Flow);
    ``aio_threads`` the NVMe tier's I/O threads unless ``aio.thread_count``
    is set.  ``buffer_count``, ``pin_memory``, ``pipeline_read``,
    ``pipeline_write`` and ``fast_init`` are kept and read by nothing,
    as in JAX."""
    device: str = "none"
    nvme_path: Optional[str] = None
    buffer_count: int = 4
    pin_memory: bool = False
    pipeline_read: bool = False
    pipeline_write: bool = False
    fast_init: bool = False
    ratio: float = 1.0
    aio_threads: int = 4

    @property
    def enabled(self) -> bool:
        return self.device not in (None, "none")


@dataclasses.dataclass
class AioConfig:
    """The ``aio`` section (JAX ``AioConfig``): the NVMe tier's I/O pool.
    ``thread_count`` None means unset (4 threads, or the offload block's
    ``aio_threads``)."""
    block_size: int = 1 << 20
    queue_depth: int = 128
    thread_count: Optional[int] = None
    single_submit: bool = False
    overlap_events: bool = True
    use_direct_io: bool = False


@dataclasses.dataclass
class ActivationCheckpointingConfig:
    """The ``activation_checkpointing`` section (JAX
    ``ActivationCheckpointingConfig``).  ``policy`` None means unset (JAX's
    default ``"full"``, which overrides nothing)."""
    partition_activations: bool = False
    cpu_checkpointing: bool = False
    contiguous_memory_optimization: bool = False
    number_checkpoints: Optional[int] = None
    synchronize_checkpoint_boundary: bool = False
    profile: bool = False
    policy: Optional[str] = None


#: the ``tpu`` keys that override the model's config when set
TPU_MODEL_KEYS = ("scan_layers", "remat", "remat_policy", "attention_impl")
#: the ``tpu`` keys parsed and read by nothing (JAX's engine takes its
#: dtypes from the precision sections, ``precision_dtype``)
TPU_UNREAD = ("param_dtype", "compute_dtype", "donate_state")
#: ``tpu.matmul_precision`` -> ``torch.set_float32_matmul_precision``
#: (JAX's names and its aliases; "default" resets to PyTorch's default)
MATMUL_PRECISION = {"default": "highest", "float32": "highest",
                    "highest": "highest", "tensorfloat32": "high",
                    "high": "high", "bfloat16": "medium"}


#: ``tpu.mesh`` axes the port runs at any size; the others must be 1
MESH_PORTED = ("data", "fsdp", "hpz", "seq", "tensor")
#: the other axes, with the ROADMAP Queue 1 item that brings each
MESH_WAITING = {"pipe": "11h (pipeline)", "expert": "11h (experts)"}


@dataclasses.dataclass
class TensorParallelConfig:
    """The ``tensor_parallel`` section (JAX ``TensorParallelConfig``,
    ``config.py:170-173``): with ``enabled``, ``tp_size`` is the mesh's
    ``tensor`` axis unless ``tpu.mesh`` sets it."""
    enabled: bool = False
    tp_size: int = 1


#: ``sequence_parallel.mode``: Ulysses' all-to-alls or ring attention
SP_MODES = ("ulysses", "ring")


@dataclasses.dataclass
class SequenceParallelConfig:
    """The ``sequence_parallel`` section (JAX ``SequenceParallelConfig``,
    ``config.py:175-178``): with ``enabled``, ``sp_size`` is the mesh's
    ``seq`` axis unless ``tpu.mesh`` sets it, and ``mode`` picks the
    attention across the seq ranks.  JAX takes any other mode as
    Ulysses; the port refuses it, as it refuses a key it would drop."""
    enabled: bool = False
    sp_size: int = 1
    mode: str = "ulysses"

    def __post_init__(self):
        if self.mode not in SP_MODES:
            raise ValueError(f"sequence_parallel.mode {self.mode!r} is not "
                             f"one of {SP_MODES}")


def _tpu(section: Dict[str, Any]
         ) -> Tuple[Dict[str, Any], str, Dict[str, int]]:
    """The ``tpu`` section -> (the model keys it sets, the matmul
    precision, the mesh).  ``mesh`` takes the data, fsdp, hpz, seq and
    tensor axes; pipe and expert raise unless they are 1 or -1."""
    section = dict(section or {})
    mesh = {k: int(v) for k, v in (section.pop("mesh", {}) or {}).items()}
    for axis, n in mesh.items():
        if axis in MESH_WAITING and n not in (1, -1):
            raise outside_slice(f"tpu.mesh {mesh} (axis {axis!r})",
                                MESH_WAITING[axis])
        if axis not in MESH_PORTED and axis not in MESH_WAITING:
            raise ValueError(f"tpu.mesh axis {axis!r} is not one of "
                             f"{MESH_PORTED + tuple(MESH_WAITING)}")
    for key in TPU_UNREAD:
        section.pop(key, None)
    precision = str(section.pop("matmul_precision", "default"))
    if precision not in MATMUL_PRECISION:
        raise ValueError(f"tpu.matmul_precision {precision!r} is not one of "
                         f"{sorted(MATMUL_PRECISION)}")
    unknown = sorted(set(section) - set(TPU_MODEL_KEYS))
    if unknown:
        raise NotImplementedError(
            f"tpu keys {unknown} are not fields of the JAX package's tpu "
            f"section; the port refuses a key it would drop")
    return section, precision, mesh


@dataclasses.dataclass
class FP16Config:
    """The ``fp16`` section (JAX ``FP16Config``).  ``loss_scale`` 0 means
    dynamic scaling from ``2 ** initial_scale_power``; ``auto_cast`` is
    kept and read by nothing but its accessor, as in JAX."""
    enabled: bool = False
    loss_scale: float = 0.0
    initial_scale_power: int = 16
    loss_scale_window: int = 1000
    hysteresis: int = 2
    min_loss_scale: float = 1.0
    auto_cast: bool = False


@dataclasses.dataclass
class BF16Config:
    """The ``bf16`` section (JAX ``BF16Config``): with ``master_weights``
    false the masters are bf16 (pure bf16), with
    ``accumulate_grads_in_fp32`` false the gradient accumulators are."""
    enabled: bool = True
    master_weights: bool = True
    accumulate_grads_in_fp32: bool = True


@dataclasses.dataclass
class FlopsProfilerConfig:
    """The ``flops_profiler`` section (JAX ``FlopsProfilerConfig``)."""
    enabled: bool = False
    profile_step: int = 1
    module_depth: int = -1
    top_modules: int = 1
    detailed: bool = True
    output_file: Optional[str] = None


@dataclasses.dataclass
class DataEfficiencyConfig:
    """The ``data_efficiency`` section (JAX ``DataEfficiencyConfig``):
    ``data_sampling`` and ``data_routing`` (``random_ltd``) are dicts
    that the engine's accessors return, as in JAX."""
    enabled: bool = False
    seed: int = 1234
    data_sampling: dict = dataclasses.field(default_factory=dict)
    data_routing: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class TelemetryConfig:
    """The engine config's ``telemetry`` block, the JAX package's fields
    and defaults: ``enabled`` (None keeps the process flag, e.g. from
    ``DS_TELEMETRY``), ``metrics_port`` (0 off, -1 an ephemeral port),
    ``trace_buffer`` (the span ring's capacity), the watchdog's
    ``watchdog`` / ``watchdog_threshold`` / ``watchdog_warmup``,
    ``postmortem_dir`` and ``flight_recorder_events`` (the flight
    recorder's bundle directory and ring size), ``workload_trace_path``
    and ``workload_trace_max_mb`` (the ledger a mined lattice is mined
    from), ``timeseries_interval_s`` / ``timeseries_retention_s`` (the
    sampled ring; a positive interval starts its sampler),
    ``fleet_targets`` (the federation's ``[label=]host:port`` list) and
    ``slo_objectives`` (the burn-rate objectives); 0, -1, "" and None
    keep the process's current settings (``telemetry.apply_settings``)."""
    enabled: Optional[bool] = None
    metrics_port: int = 0
    trace_buffer: int = 0
    watchdog: Optional[bool] = None
    watchdog_threshold: float = 0.0
    watchdog_warmup: int = -1
    postmortem_dir: str = ""
    flight_recorder_events: int = 0
    workload_trace_path: str = ""
    workload_trace_max_mb: int = 0
    timeseries_interval_s: float = 0.0
    timeseries_retention_s: float = 0.0
    fleet_targets: str = ""
    slo_objectives: list = dataclasses.field(default_factory=list)

    def apply(self) -> None:
        from ..telemetry import apply_settings
        apply_settings(self.enabled, self.metrics_port, self.trace_buffer,
                       watchdog=self.watchdog,
                       watchdog_threshold=self.watchdog_threshold,
                       watchdog_warmup=self.watchdog_warmup,
                       postmortem_dir=self.postmortem_dir,
                       flight_recorder_events=self.flight_recorder_events,
                       workload_trace_path=self.workload_trace_path,
                       workload_trace_max_mb=self.workload_trace_max_mb,
                       timeseries_interval_s=self.timeseries_interval_s,
                       timeseries_retention_s=self.timeseries_retention_s,
                       fleet_targets=self.fleet_targets,
                       slo_objectives=self.slo_objectives)


@dataclasses.dataclass
class FaultInjectionConfig:
    """The engine config's ``fault_injection`` block (the deterministic
    chaos registry, ``runtime/fault_injection.py``).  ``enabled=False``
    leaves the process registry alone, so a default-config engine build
    does not disarm a ``DS_CHAOS`` arming."""
    enabled: bool = False
    seed: int = 0
    sites: dict = dataclasses.field(default_factory=dict)

    def apply(self) -> None:
        from .fault_injection import apply_fault_injection
        apply_fault_injection(self.enabled, self.seed, self.sites)


@dataclasses.dataclass
class CheckpointConfig:
    """The ``checkpoint`` section (JAX ``CheckpointConfig``).
    ``async_save`` persists a save from a writer thread over host copies;
    ``save_retries`` / ``save_backoff_s`` bound the retries of an
    ``OSError``; ``load_universal`` makes ``load_checkpoint`` read
    universal atoms.  ``tag_validation``, ``use_node_local_storage`` and
    ``parallel_write`` are kept and read by nothing, as in JAX."""
    tag_validation: str = "Warn"
    load_universal: bool = False
    use_node_local_storage: bool = False
    parallel_write: dict = dataclasses.field(default_factory=dict)
    async_save: bool = True
    save_retries: int = 3
    save_backoff_s: float = 0.05


@dataclasses.dataclass
class FaultToleranceConfig:
    """The ``fault_tolerance`` section (JAX ``FaultToleranceConfig``).
    With ``self_healing`` a non-finite loss or grad norm rolls the engine
    back to the last good checkpoint (or an in-memory host snapshot) and
    skips the batch; a transient fault at dispatch retries the same
    batch.  ``max_retries`` bounds consecutive recoveries, each sleeping
    ``backoff_s * 2**(n-1)``; ``snapshot_interval > 0`` refreshes the
    snapshot every that many healthy steps."""
    self_healing: bool = False
    max_retries: int = 3
    backoff_s: float = 0.05
    snapshot_interval: int = 0


@dataclasses.dataclass
class MonitorConfigItem:
    """One monitor section: ``tensorboard``, ``wandb``, ``csv_monitor``
    or ``comet`` (JAX ``MonitorConfigItem``)."""
    enabled: bool = False
    output_path: str = ""
    job_name: str = "DeepSpeedTPUJob"
    team: str = ""
    group: str = ""
    project: str = "deepspeed_tpu"


@dataclasses.dataclass
class CommOptimizationConfig:
    """The ``comm_optimization`` section (JAX ``CommOptimizationConfig``):
    the collective scheduler's knobs (``runtime/comm/
    collective_scheduler.py``): byte-sized gradient buckets, each on the
    int8 block-scaled wire (``quantize``) with persistent error-feedback
    residuals (``error_feedback``), reduced per micro-batch
    (``overlap``) or once at the accumulation boundary."""
    enabled: bool = False
    allreduce_bucket_size: int = int(5e8)
    quantize: bool = True
    quantize_dtype: str = "int8"
    overlap: bool = True
    error_feedback: bool = True
    quantization_block: int = 512

    def __post_init__(self):
        if self.quantize_dtype != "int8":
            raise ValueError(f"comm_optimization.quantize_dtype must be "
                             f"'int8', got {self.quantize_dtype!r}")


@dataclasses.dataclass
class CommsLoggerConfig:
    """The ``comms_logger`` section (JAX ``CommsLoggerConfig``): with
    ``enabled`` the engine configures the comms logger at build
    (``comm.configure_comms_logger``, ``verbose`` passed on);
    ``debug``, ``prof_all`` and ``prof_ops`` are kept and read by
    nothing, as in JAX."""
    enabled: bool = False
    verbose: bool = False
    debug: bool = False
    prof_all: bool = True
    prof_ops: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass
class ElasticityConfig:
    """The ``elasticity`` section (JAX ``ElasticityConfig``): parsed and
    read by the engine's accessor only; the JAX launcher acts on it."""
    enabled: bool = False
    max_train_batch_size: int = 2000
    micro_batch_sizes: list = dataclasses.field(
        default_factory=lambda: [2, 4, 6])
    min_gpus: int = 1
    max_gpus: int = 10000
    min_time: int = 0
    prefer_larger_batch: bool = True
    ignore_non_elastic_batch_info: bool = False
    version: float = 0.2


@dataclasses.dataclass
class AutotuningConfig:
    """The ``autotuning`` section (JAX ``AutotuningConfig``): parsed and
    read by the engine's accessor only; the JAX launcher acts on it."""
    enabled: bool = False
    fast: bool = True
    results_dir: str = "autotuning_results"
    exps_dir: str = "autotuning_exps"
    overwrite: bool = False
    metric: str = "throughput"
    start_profile_step: int = 3
    end_profile_step: int = 5
    tuner_type: str = "gridsearch"
    tuner_early_stopping: int = 5
    tuner_num_trials: int = 50
    max_train_batch_size: Optional[int] = None
    mp_size: int = 1


@dataclasses.dataclass
class HybridEngineConfig:
    """The ``hybrid_engine`` section (JAX ``HybridEngineConfig``):
    ``enabled`` makes ``initialize`` build ``DeepSpeedHybridEngine``; the
    other keys are accepted and read by nothing, as in JAX."""
    enabled: bool = False
    max_out_tokens: int = 512
    inference_tp_size: int = 1
    release_inference_cache: bool = False
    pin_parameters: bool = True
    tp_gather_partition_size: int = 8


@dataclasses.dataclass
class ServingOptimizationConfig:
    """The training config's ``serving_optimization`` section (JAX
    ``ServingOptimizationConfig``, the training-side copy): the hybrid
    engine's rollout engine takes it through :meth:`to_v2_dict`, and
    ``inference/v2/config.py`` validates it there (``tp_degree`` other
    than 1 raises at the rollout engine's build, naming its item)."""
    enabled: bool = True
    fused_step: bool = True
    on_device_sampling: bool = True
    async_scheduling: bool = True
    prefix_caching: bool = True
    max_queue_depth: int = 0
    shed_queue_wait_ms: float = 0.0
    default_ttl_s: float = 0.0
    shed_unservable: bool = False
    snapshot_grace_s: float = 5.0
    snapshot_path: str = ""
    speculative: bool = False
    spec_max_draft: int = 3
    spec_ngram_min: int = 2
    spec_drafter: str = "ngram"
    spec_draft_layers: int = 0
    role: str = "both"
    keyed_sampling: bool = False
    compile_cache_dir: str = ""
    lattice: str = ""
    kv_quantization: str = "none"
    kv_tier_host_pages: int = 0
    kv_tier_disk_pages: int = 0
    kv_tier_dir: str = ""
    tp_degree: int = 1
    tp_collective_quantization: str = "none"

    def to_v2_dict(self) -> Dict[str, Any]:
        """The ``serving_optimization`` dict the inference-v2 config
        reads (``RaggedInferenceEngineConfig.from_dict``)."""
        return dataclasses.asdict(self)


def _section(cls, name: str, section: Optional[Dict[str, Any]]):
    """``cls(**section)``; a key the dataclass lacks raises."""
    section = dict(section or {})
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(section) - known)
    if unknown:
        raise NotImplementedError(
            f"{name} keys {unknown} are not fields of the JAX package's "
            f"{name} section; the port refuses a key it would drop")
    return cls(**section)


MONITORS = ("tensorboard", "wandb", "csv_monitor", "comet")
#: sections parsed whole into their dataclass
SECTIONS = {"tensor_parallel": TensorParallelConfig,
            "sequence_parallel": SequenceParallelConfig,
            "comms_logger": CommsLoggerConfig,
            "comm_optimization": CommOptimizationConfig,
            "elasticity": ElasticityConfig,
            "autotuning": AutotuningConfig,
            "hybrid_engine": HybridEngineConfig,
            "serving_optimization": ServingOptimizationConfig}


@dataclasses.dataclass
class TrainingConfig:
    train_batch_size: Optional[int] = None
    train_micro_batch_size_per_gpu: Optional[int] = None
    gradient_accumulation_steps: Optional[int] = None
    gradient_clipping: float = 0.0
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig)
    scheduler: Optional[SchedulerConfig] = None
    #: bf16 compute over fp32 masters and fp32 gradient accumulation (the
    #: JAX default); ``enabled`` False (and no fp16) computes in fp32
    bf16: BF16Config = dataclasses.field(default_factory=BF16Config)
    fp16: FP16Config = dataclasses.field(default_factory=FP16Config)
    zero_stage: int = 0
    #: ZeRO++ qwZ; acts at zero_stage 3 only
    zero_quantized_weights: bool = False
    #: ZeRO++ qgZ (the int8 gradient wire from stage 2, through the
    #: collective scheduler), hpZ's secondary partition and MiCS's shard
    #: size (JAX ``ZeroConfig``)
    zero_quantized_gradients: bool = False
    zero_hpz_partition_size: int = 1
    mics_shard_size: int = -1
    #: the ``tpu.mesh`` axis sizes the config set (data, fsdp, hpz, seq,
    #: tensor)
    mesh: Dict[str, int] = dataclasses.field(default_factory=dict)
    #: the tensor and sequence parallel sections (the mesh's tensor and
    #: seq axes when ``tpu.mesh`` leaves them unset; the seq ranks'
    #: attention)
    tensor_parallel: TensorParallelConfig = dataclasses.field(
        default_factory=TensorParallelConfig)
    sequence_parallel: SequenceParallelConfig = dataclasses.field(
        default_factory=SequenceParallelConfig)
    #: ZeRO-Offload of the optimizer (fp32 masters and moments on the
    #: host, the step in the host kernels)
    offload_optimizer: OffloadConfig = dataclasses.field(
        default_factory=OffloadConfig)
    #: parsed and read by nothing, as in the JAX engine (an accessor only)
    offload_param: OffloadConfig = dataclasses.field(
        default_factory=OffloadConfig)
    aio: AioConfig = dataclasses.field(default_factory=AioConfig)
    activation_checkpointing: ActivationCheckpointingConfig = \
        dataclasses.field(default_factory=ActivationCheckpointingConfig)
    #: the ``tpu`` model keys the config set (scan_layers, remat,
    #: remat_policy, attention_impl), applied to the model's config
    tpu: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: ``tpu.matmul_precision`` as ``torch.set_float32_matmul_precision``
    #: takes it
    matmul_precision: str = "highest"
    memory_breakdown: bool = False
    flops_profiler: FlopsProfilerConfig = dataclasses.field(
        default_factory=FlopsProfilerConfig)
    data_efficiency: DataEfficiencyConfig = dataclasses.field(
        default_factory=DataEfficiencyConfig)
    #: the ``zero_optimization`` keys of ``ZERO_ONE_RANK_NOOPS`` the config
    #: set (the engine's accessors read them; JAX's defaults otherwise)
    zero_settings: Dict[str, Any] = dataclasses.field(default_factory=dict)
    #: the (section, key) pairs of ``NOOP_KEYS`` the config set
    noop_keys: Tuple[Tuple[str, str], ...] = ()
    steps_per_print: int = 10
    #: synchronise the card around the train_batch timer and log it at
    #: steps_per_print
    wall_clock_breakdown: bool = False
    checkpoint: CheckpointConfig = dataclasses.field(
        default_factory=CheckpointConfig)
    fault_tolerance: FaultToleranceConfig = dataclasses.field(
        default_factory=FaultToleranceConfig)
    fault_injection: FaultInjectionConfig = dataclasses.field(
        default_factory=FaultInjectionConfig)
    telemetry: TelemetryConfig = dataclasses.field(
        default_factory=TelemetryConfig)
    tensorboard: MonitorConfigItem = dataclasses.field(
        default_factory=MonitorConfigItem)
    wandb: MonitorConfigItem = dataclasses.field(
        default_factory=MonitorConfigItem)
    csv_monitor: MonitorConfigItem = dataclasses.field(
        default_factory=MonitorConfigItem)
    comet: MonitorConfigItem = dataclasses.field(
        default_factory=MonitorConfigItem)
    #: read by the engine's accessors only (``postscale_gradients`` is
    #: ``not prescale_gradients``), as in JAX: one rank averages no
    #: gradient across ranks
    prescale_gradients: bool = False
    gradient_predivide_factor: float = 1.0
    communication_data_type: Optional[str] = None
    #: the keys of ``NOOP_KEYS``'s top-level section: parsed, read by
    #: nothing
    seq_parallel_communication_data_type: str = "fp32"
    dump_state: bool = False
    disable_allgather: bool = False
    #: the embedding takes the sparse backward (``runtime/sparse_tensor``)
    sparse_gradients: bool = False
    comms_logger: CommsLoggerConfig = dataclasses.field(
        default_factory=CommsLoggerConfig)
    comm_optimization: CommOptimizationConfig = dataclasses.field(
        default_factory=CommOptimizationConfig)
    elasticity: ElasticityConfig = dataclasses.field(
        default_factory=ElasticityConfig)
    autotuning: AutotuningConfig = dataclasses.field(
        default_factory=AutotuningConfig)
    hybrid_engine: HybridEngineConfig = dataclasses.field(
        default_factory=HybridEngineConfig)
    serving_optimization: ServingOptimizationConfig = dataclasses.field(
        default_factory=ServingOptimizationConfig)

    @property
    def precision_dtype(self) -> str:
        """JAX ``precision_dtype``: float16 (computed in bf16), bfloat16
        or float32."""
        if self.fp16.enabled:
            return "float16"
        return "bfloat16" if self.bf16.enabled else "float32"

    @property
    def quantized_weights(self) -> bool:
        """Whether each step snaps the compute weights to the int8 grid
        (qwZ at stage 3; below it the flag changes nothing, as in JAX)."""
        return self.zero_stage >= 3 and self.zero_quantized_weights

    def resolve_batch_sizes(self, batch_parallel_world: int = 1) -> None:
        """Enforce train_batch = micro * gas * dp (JAX
        ``resolve_batch_sizes``; ``dp`` the mesh's batch shards),
        inferring what is missing (gas 1 and micro 1 when nothing else
        says)."""
        tb, mb, gas = (self.train_batch_size,
                       self.train_micro_batch_size_per_gpu,
                       self.gradient_accumulation_steps)
        dp = int(batch_parallel_world)
        if tb is not None and mb is None and gas is not None:
            if tb % (gas * dp):
                raise ValueError(f"train_batch_size {tb} not divisible by "
                                 f"gas*dp {gas * dp}")
            mb = tb // (gas * dp)
        if gas is None:
            if tb is not None and mb is not None:
                if tb % (mb * dp):
                    raise ValueError(f"train_batch_size {tb} not divisible "
                                     f"by micro*dp {mb * dp}")
                gas = tb // (mb * dp)
            else:
                gas = 1
        if mb is None:
            if tb is not None and tb % (gas * dp):
                raise ValueError(f"train_batch_size {tb} not divisible by "
                                 f"dp {dp}")
            mb = tb // (gas * dp) if tb is not None else 1
        if tb is None:
            tb = mb * gas * dp
        if tb != mb * gas * dp or tb < 1:
            raise ValueError(f"train_batch_size {tb} != micro_batch {mb} "
                             f"* gas {gas} * dp {dp}")
        self.train_batch_size = tb
        self.train_micro_batch_size_per_gpu = mb
        self.gradient_accumulation_steps = gas


#: the other names of JAX ``get_optimizer``, each one kind
OTHER_TYPES = {"sgd": "sgd", "adafactor": "adafactor", "muon": "muon",
               "onebitadam": "onebitadam", "zerooneadam": "onebitadam",
               "onebitlamb": "onebitlamb"}


def optimizer_kind(name: str, adam_w_mode: bool = True,
                   momentum: float = 0.0) -> str:
    """The optimizer's kind for a DeepSpeed optimizer name (JAX
    ``get_optimizer``'s selection): "adamw" ("adam_l2" for an Adam name
    but "adamw" with ``adam_w_mode`` false), "lion", "lamb", "adagrad",
    "sgd" ("sgd_momentum" with a momentum), "adafactor", "muon",
    "onebitadam" (0/1 Adam too) or "onebitlamb"; the kind names the
    state layout (checkpoints and universal atoms).  An unknown name
    raises JAX's ``ValueError``."""
    key = name.lower().replace("_", "")
    if key in ADAM_TYPES + CPU_ADAM_TYPES:
        return "adamw" if adam_w_mode or key == "adamw" else "adam_l2"
    for kind, names in (("lion", LION_TYPES + CPU_LION_TYPES),
                        ("lamb", LAMB_TYPES), ("adagrad", ADAGRAD_TYPES)):
        if key in names:
            return kind
    if key in OTHER_TYPES:
        kind = OTHER_TYPES[key]
        return "sgd_momentum" if kind == "sgd" and momentum else kind
    raise ValueError(f"unsupported optimizer: {key!r}")


def _optimizer(section: Dict[str, Any]) -> OptimizerConfig:
    name = str(section.get("type", "adamw"))
    params = dict(section.get("params", {}))
    known = {f.name for f in dataclasses.fields(OptimizerParams)}
    unknown = sorted(set(params) - known)
    if unknown:
        raise NotImplementedError(
            f"optimizer params {unknown} are not fields of the JAX "
            f"package's OptimizerParams; the port refuses a key it would "
            f"drop")
    if "betas" in params:
        params["betas"] = tuple(float(b) for b in params["betas"])
    opt = OptimizerConfig(type=name, params=OptimizerParams(**params))
    optimizer_kind(name, opt.params.adam_w_mode, opt.params.momentum)
    return opt


def _precision(config: Dict[str, Any]) -> Tuple[BF16Config, FP16Config]:
    """The ``bf16`` and ``fp16`` sections; fp16 switched on turns bf16
    off (JAX ``_normalize``)."""
    bf16 = _section(BF16Config, "bf16", config.get("bf16"))
    fp16 = _section(FP16Config, "fp16", config.get("fp16"))
    if fp16.enabled:
        bf16.enabled = False
    return bf16, fp16


def _zero(section: Dict[str, Any]
          ) -> Tuple[int, bool, OffloadConfig, OffloadConfig]:
    """(stage, zero_quantized_weights, offload_optimizer, offload_param)
    of a ``zero_optimization`` section; raises for a key JAX's
    ``ZeroConfig`` lacks."""
    stage = int(section.get("stage", 0))
    if stage not in (0, 1, 2, 3):
        raise ValueError(f"ZeRO stage must be 0, 1, 2 or 3, got {stage}")
    offload = [_section(OffloadConfig, f"zero_optimization.{key}",
                        section.get(key))
               for key in ("offload_optimizer", "offload_param")]
    for key, off in zip(("offload_optimizer", "offload_param"), offload):
        if off.device not in (None, "none", "cpu", "nvme"):
            raise ValueError(f"zero_optimization.{key}.device must be "
                             f"none, cpu or nvme, got {off.device!r}")
    known = {"stage", "offload_optimizer", "offload_param",
             "zero_quantized_weights", "zero_quantized_gradients",
             "zero_hpz_partition_size", "mics_shard_size",
             *ZERO_ONE_RANK_NOOPS}
    unknown = sorted(set(section) - known)
    if unknown:
        raise NotImplementedError(
            f"zero_optimization keys {unknown} are not fields of the JAX "
            f"package's ZeroConfig; the port refuses a key it would drop")
    return (stage, bool(section.get("zero_quantized_weights", False)),
            *offload)


def _noop_keys(config: Dict[str, Any]) -> Tuple[Tuple[str, str], ...]:
    return tuple((sec, key) for sec, key in NOOP_KEYS
                 if key in ((config.get(sec) or {}) if sec else config))


def warn_noop_keys(config: TrainingConfig) -> None:
    """One warning for each key of ``NOOP_KEYS`` the config set (JAX
    ``warn_noop_keys``)."""
    from ..utils.logging import logger
    for section, key in config.noop_keys:
        logger.warning(
            "config %s is accepted for compatibility but has no effect "
            "in the port: %s", f"{section}.{key}" if section else key,
            NOOP_KEYS[(section, key)])


def load_config(config: Union[str, os.PathLike, Dict[str, Any],
                              TrainingConfig, None]) -> TrainingConfig:
    """A dict or a JSON path -> :class:`TrainingConfig`.  Raises
    ``NotImplementedError`` for any key outside the slice."""
    if isinstance(config, TrainingConfig):
        return config
    if config is None:
        config = {}
    elif isinstance(config, (str, os.PathLike)):
        with open(config) as f:
            config = json.load(f)
    for key, section in config.items():
        if key in _OUTSIDE_SLICE:
            switched_on, item = _OUTSIDE_SLICE[key]
            if switched_on(section):
                raise outside_slice(f"config section {key!r}", item)
        elif key not in _READ:
            raise NotImplementedError(
                f"config key {key!r} is not a field of the JAX package's "
                f"DeepSpeedTPUConfig; the port refuses a key it would drop")
    stage, qwz, off_opt, off_param = _zero(
        config.get("zero_optimization", {}))
    optimizer = _optimizer(config.get("optimizer", {}))
    bf16, fp16 = _precision(config)
    tpu, precision, mesh = _tpu(config.get("tpu"))
    zsec = config.get("zero_optimization") or {}
    sched = config.get("scheduler")
    return TrainingConfig(
        train_batch_size=config.get("train_batch_size"),
        train_micro_batch_size_per_gpu=config.get(
            "train_micro_batch_size_per_gpu"),
        gradient_accumulation_steps=config.get("gradient_accumulation_steps"),
        gradient_clipping=float(config.get("gradient_clipping", 0.0)),
        optimizer=optimizer,
        scheduler=(SchedulerConfig(type=sched.get("type", "WarmupLR"),
                                   params=dict(sched.get("params", {})))
                   if sched is not None else None),
        bf16=bf16, fp16=fp16,
        zero_stage=stage, zero_quantized_weights=qwz,
        zero_quantized_gradients=bool(
            zsec.get("zero_quantized_gradients", False)),
        zero_hpz_partition_size=int(zsec.get("zero_hpz_partition_size", 1)),
        mics_shard_size=int(zsec.get("mics_shard_size", -1)), mesh=mesh,
        offload_optimizer=off_opt, offload_param=off_param,
        aio=_section(AioConfig, "aio", config.get("aio")),
        activation_checkpointing=_section(
            ActivationCheckpointingConfig, "activation_checkpointing",
            config.get("activation_checkpointing")),
        tpu=tpu, matmul_precision=MATMUL_PRECISION[precision],
        memory_breakdown=bool(config.get("memory_breakdown", False)),
        flops_profiler=_section(FlopsProfilerConfig, "flops_profiler",
                                config.get("flops_profiler")),
        data_efficiency=_section(DataEfficiencyConfig, "data_efficiency",
                                 config.get("data_efficiency")),
        zero_settings={k: v for k, v in
                       (config.get("zero_optimization") or {}).items()
                       if k in ZERO_ONE_RANK_NOOPS},
        noop_keys=_noop_keys(config),
        steps_per_print=int(config.get("steps_per_print", 10)),
        wall_clock_breakdown=bool(config.get("wall_clock_breakdown", False)),
        checkpoint=_section(CheckpointConfig, "checkpoint",
                            config.get("checkpoint")),
        fault_tolerance=_section(FaultToleranceConfig, "fault_tolerance",
                                 config.get("fault_tolerance")),
        fault_injection=_section(FaultInjectionConfig, "fault_injection",
                                 config.get("fault_injection")),
        telemetry=_section(TelemetryConfig, "telemetry",
                           config.get("telemetry")),
        prescale_gradients=bool(config.get("prescale_gradients", False)),
        gradient_predivide_factor=float(
            config.get("gradient_predivide_factor", 1.0)),
        communication_data_type=(
            None if config.get("communication_data_type") is None
            else str(config["communication_data_type"])),
        seq_parallel_communication_data_type=str(
            config.get("seq_parallel_communication_data_type", "fp32")),
        dump_state=bool(config.get("dump_state", False)),
        disable_allgather=bool(config.get("disable_allgather", False)),
        sparse_gradients=bool(config.get("sparse_gradients", False)),
        **{key: _section(cls, key, config.get(key))
           for key, cls in SECTIONS.items()},
        **{m: _section(MonitorConfigItem, m, config.get(m))
           for m in MONITORS})


#: the JAX package's name for the training config
DeepSpeedTPUConfig = TrainingConfig
