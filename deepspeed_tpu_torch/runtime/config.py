"""Training config: the subset of the DeepSpeed-style config the port's
training slice reads.

Counterpart of ``deepspeed_tpu/runtime/config.py`` (``OptimizerParams``
:41, ``BF16Config`` :71, ``ZeroConfig`` :110, ``gradient_clipping``
:597, ``precision_dtype`` :686 as the ``bf16`` flag,
``resolve_batch_sizes`` :652), as plain dataclasses.  A config is a dict
or a JSON path with the keys users already write.  The slice is one
device; bf16 (fp32 masters and fp32 gradient accumulation) or fp32;
AdamW, Lion or LAMB; the five LR schedules; ZeRO stages 0 to 3 and
ZeRO++ quantised weights.  A key that switches on a feature outside the
slice raises ``NotImplementedError`` naming its ROADMAP item; a key the
port does not know raises too, so no setting is silently dropped.

The loader also reads the ``checkpoint``
section (JAX ``CheckpointConfig``: ``async_save``, ``save_retries``,
``save_backoff_s``, ``load_universal``; ``tag_validation``,
``use_node_local_storage`` and ``parallel_write`` are accepted and, as
in JAX, change nothing), ``fault_tolerance`` (self-healing training),
``fault_injection`` and ``telemetry`` (the serving engine's blocks, with
the JAX fields), ``wall_clock_breakdown`` and the monitor sections
``tensorboard``, ``wandb``, ``csv_monitor`` and ``comet``.  A key the
port does not know inside one of them raises like any other.

ZeRO on one device: the partition over one rank is the identity, so
stages 1, 2 and 3 keep masters, gradients and moments whole and give
stage 0's numbers, as the JAX engine does on a one-device mesh.  The
only number a stage changes is ``zero_quantized_weights`` (ZeRO++ qwZ)
at stage 3: every floating leaf of two or more dimensions is snapped to
the blockwise int8 grid once per step before the compute cast.  Below
stage 3 it changes nothing, as in JAX (``engine.py:641``).  The keys in
``ZERO_ONE_RANK_NOOPS`` are accepted and do nothing on one rank.
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
#: the host-side optimizers, which come with offload
OFFLOAD_TYPES = ("cpuadam", "deepspeedcpuadam", "cpulion", "cpuadagrad")

#: zero_optimization keys that do nothing on one rank (buckets,
#: communication overlap, stage-3 prefetch and persistence, MiCS and
#: ZeRO++ knobs at their one-rank values)
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
    "fp16": (_enabled, "11c (fp16 and loss scaling)"),
    "comm_optimization": (_enabled, "11e (quantized collectives)"),
    "compression_training": (bool, "11e (compression)"),
    "pipeline": (lambda s: s.get("stages", 1) > 1,
                 "11h (pipeline, MoE, sequence parallel)"),
    "moe": (_enabled, "11h (pipeline, MoE, sequence parallel)"),
    "sequence_parallel": (_enabled, "11h (pipeline, MoE, sequence parallel)"),
    "tensor_parallel": (_enabled, "11b (ZeRO and model parallelism)"),
}

# read by the slice
_READ = ("train_batch_size", "train_micro_batch_size_per_gpu",
         "gradient_accumulation_steps", "gradient_clipping", "optimizer",
         "scheduler", "bf16", "zero_optimization", "steps_per_print",
         "wall_clock_breakdown", "checkpoint", "fault_tolerance",
         "fault_injection", "telemetry", "tensorboard", "wandb",
         "csv_monitor", "comet")


@dataclasses.dataclass
class OptimizerParams:
    lr: float = 1e-3
    betas: Tuple[float, float] = (0.9, 0.999)
    eps: float = 1e-8
    weight_decay: float = 0.0


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


def _section(cls, name: str, section: Optional[Dict[str, Any]]):
    """``cls(**section)``; a key the dataclass lacks raises."""
    section = dict(section or {})
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = sorted(set(section) - known)
    if unknown:
        raise NotImplementedError(
            f"{name} keys {unknown} are not read by the port's training "
            f"slice (see ROADMAP Queue 1 item 11)")
    return cls(**section)


MONITORS = ("tensorboard", "wandb", "csv_monitor", "comet")


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
    #: JAX default); False computes in fp32
    bf16: bool = True
    zero_stage: int = 0
    #: ZeRO++ qwZ; acts at zero_stage 3 only
    zero_quantized_weights: bool = False
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

    @property
    def quantized_weights(self) -> bool:
        """Whether each step snaps the compute weights to the int8 grid
        (qwZ at stage 3; below it the flag changes nothing, as in JAX)."""
        return self.zero_stage >= 3 and self.zero_quantized_weights

    def resolve_batch_sizes(self) -> None:
        """Enforce train_batch = micro * gas on one device, inferring what
        is missing (gas 1 and micro 1 when nothing else says)."""
        tb, mb, gas = (self.train_batch_size,
                       self.train_micro_batch_size_per_gpu,
                       self.gradient_accumulation_steps)
        if gas is None:
            gas = tb // mb if tb is not None and mb is not None else 1
        if mb is None:
            mb = tb // gas if tb is not None else 1
        if tb is None:
            tb = mb * gas
        if tb != mb * gas or tb < 1:
            raise ValueError(f"train_batch_size {tb} != micro_batch {mb} "
                             f"* gas {gas}")
        self.train_batch_size = tb
        self.train_micro_batch_size_per_gpu = mb
        self.gradient_accumulation_steps = gas


OTHER_OPTIMIZERS = "11d (SGD, Adagrad, adam_w_mode=False, 1-bit, Muon)"


def optimizer_kind(name: str) -> str:
    """"adamw", "lion" or "lamb" for a DeepSpeed optimizer name the
    slice runs; raises ``NotImplementedError`` for any other."""
    key = name.lower().replace("_", "")
    for kind, names in (("adamw", ADAM_TYPES), ("lion", LION_TYPES),
                        ("lamb", LAMB_TYPES)):
        if key in names:
            return kind
    if key in OFFLOAD_TYPES:
        raise outside_slice(f"optimizer {name!r}", "11g (offload)")
    raise outside_slice(f"optimizer {name!r}", OTHER_OPTIMIZERS)


def _optimizer(section: Dict[str, Any]) -> OptimizerConfig:
    name = str(section.get("type", "adamw"))
    optimizer_kind(name)
    params = dict(section.get("params", {}))
    if not params.pop("adam_w_mode", True):
        raise outside_slice("adam_w_mode=False (coupled L2 decay)",
                            OTHER_OPTIMIZERS)
    if not params.pop("bias_correction", True):
        raise outside_slice("bias_correction=False", OTHER_OPTIMIZERS)
    known = {f.name for f in dataclasses.fields(OptimizerParams)}
    unknown = sorted(set(params) - known)
    if unknown:
        raise outside_slice(f"optimizer params {unknown}", OTHER_OPTIMIZERS)
    if "betas" in params:
        params["betas"] = tuple(float(b) for b in params["betas"])
    return OptimizerConfig(type=name, params=OptimizerParams(**params))


def _bf16(section: Dict[str, Any]) -> bool:
    if not section.get("master_weights", True) or \
            not section.get("accumulate_grads_in_fp32", True):
        raise outside_slice("bf16 without fp32 masters or fp32 gradient "
                            "accumulation", "11c (fp16 and loss scaling)")
    return bool(section.get("enabled", True))


def _zero(section: Dict[str, Any]) -> Tuple[int, bool]:
    """(stage, zero_quantized_weights) of a ``zero_optimization``
    section; raises for what needs more than one rank or is not ported."""
    stage = int(section.get("stage", 0))
    if stage not in (0, 1, 2, 3):
        raise ValueError(f"ZeRO stage must be 0, 1, 2 or 3, got {stage}")
    for key in ("offload_optimizer", "offload_param"):
        device = (section.get(key) or {}).get("device", "none")
        if device not in (None, "none"):
            raise outside_slice(f"zero_optimization.{key}", "11g (offload)")
    if section.get("zero_quantized_gradients", False):
        raise outside_slice("zero_optimization.zero_quantized_gradients "
                            "(ZeRO++ qgZ)", "11e (quantized collectives)")
    if section.get("zero_hpz_partition_size", 1) > 1:
        raise outside_slice("zero_optimization.zero_hpz_partition_size > 1 "
                            "(ZeRO++ hpZ)", "11b (ZeRO across GPUs)")
    if section.get("mics_shard_size", -1) > 0:
        raise outside_slice("zero_optimization.mics_shard_size > 0 (MiCS)",
                            "11b (ZeRO across GPUs)")
    known = {"stage", "offload_optimizer", "offload_param",
             "zero_quantized_weights", "zero_quantized_gradients",
             "zero_hpz_partition_size", "mics_shard_size",
             *ZERO_ONE_RANK_NOOPS}
    unknown = sorted(set(section) - known)
    if unknown:
        raise NotImplementedError(
            f"zero_optimization keys {unknown} are not read by the port's "
            f"training slice (see ROADMAP Queue 1 item 11b)")
    return stage, bool(section.get("zero_quantized_weights", False))


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
                f"config key {key!r} is not read by the port's training "
                f"slice (see ROADMAP Queue 1 item 11)")
    stage, qwz = _zero(config.get("zero_optimization", {}))
    sched = config.get("scheduler")
    return TrainingConfig(
        train_batch_size=config.get("train_batch_size"),
        train_micro_batch_size_per_gpu=config.get(
            "train_micro_batch_size_per_gpu"),
        gradient_accumulation_steps=config.get("gradient_accumulation_steps"),
        gradient_clipping=float(config.get("gradient_clipping", 0.0)),
        optimizer=_optimizer(config.get("optimizer", {})),
        scheduler=(SchedulerConfig(type=sched.get("type", "WarmupLR"),
                                   params=dict(sched.get("params", {})))
                   if sched is not None else None),
        bf16=_bf16(config.get("bf16", {})),
        zero_stage=stage, zero_quantized_weights=qwz,
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
        **{m: _section(MonitorConfigItem, m, config.get(m))
           for m in MONITORS})
