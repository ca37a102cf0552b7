"""Training config: the subset of the DeepSpeed-style config the port's
training slice reads.

Counterpart of ``deepspeed_tpu/runtime/config.py`` (``OptimizerParams``
:41, ``BF16Config`` :71, ``gradient_clipping`` :597, ``precision_dtype``
:686 as the ``bf16`` flag, ``resolve_batch_sizes`` :652), as plain
dataclasses.  A config is a dict or a JSON path with the keys users
already write.  The slice is one device, ZeRO stage 0, bf16 (fp32
masters and fp32 gradient accumulation) or fp32, AdamW and the five LR
schedules.  A key that switches on a feature outside the slice raises
``NotImplementedError`` naming its ROADMAP item; a key the port does not
know raises too, so no setting is silently dropped.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Dict, Optional, Tuple, Union

#: optimizer names the slice runs, all as AdamW through the fused kernel
ADAM_TYPES = ("adam", "adamw", "fusedadam")


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
    "checkpoint": (lambda s: True, "11f (checkpointing)"),
    "fault_tolerance": (lambda s: s.get("self_healing", False),
                        "11i (fault tolerance and telemetry)"),
    "fault_injection": (_enabled, "11i (fault tolerance and telemetry)"),
    "telemetry": (_enabled, "11i (fault tolerance and telemetry)"),
}

# read by the slice (steps_per_print is accepted and has no effect: the
# port's engine prints nothing)
_READ = ("train_batch_size", "train_micro_batch_size_per_gpu",
         "gradient_accumulation_steps", "gradient_clipping", "optimizer",
         "scheduler", "bf16", "zero_optimization", "steps_per_print")


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


def _optimizer(section: Dict[str, Any]) -> OptimizerConfig:
    name = str(section.get("type", "adamw"))
    if name.lower().replace("_", "") not in ADAM_TYPES:
        raise outside_slice(f"optimizer {name!r}",
                            "11d (Lion, LAMB and the other optimizers)")
    params = dict(section.get("params", {}))
    if not params.pop("adam_w_mode", True):
        raise outside_slice("adam_w_mode=False (coupled L2 decay)",
                            "11d (Lion, LAMB and the other optimizers)")
    if not params.pop("bias_correction", True):
        raise outside_slice("bias_correction=False",
                            "11d (Lion, LAMB and the other optimizers)")
    known = {f.name for f in dataclasses.fields(OptimizerParams)}
    unknown = sorted(set(params) - known)
    if unknown:
        raise outside_slice(f"optimizer params {unknown}",
                            "11d (Lion, LAMB and the other optimizers)")
    if "betas" in params:
        params["betas"] = tuple(float(b) for b in params["betas"])
    return OptimizerConfig(type=name, params=OptimizerParams(**params))


def _bf16(section: Dict[str, Any]) -> bool:
    if not section.get("master_weights", True) or \
            not section.get("accumulate_grads_in_fp32", True):
        raise outside_slice("bf16 without fp32 masters or fp32 gradient "
                            "accumulation", "11c (fp16 and loss scaling)")
    return bool(section.get("enabled", True))


def _check_zero(section: Dict[str, Any]) -> None:
    if section.get("stage", 0) > 0:
        raise outside_slice(f"ZeRO stage {section['stage']}",
                            "11b (ZeRO and model parallelism)")
    for key in ("offload_optimizer", "offload_param"):
        device = (section.get(key) or {}).get("device", "none")
        if device not in (None, "none"):
            raise outside_slice(f"zero_optimization.{key}", "11g (offload)")


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
    _check_zero(config.get("zero_optimization", {}))
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
        bf16=_bf16(config.get("bf16", {})))
