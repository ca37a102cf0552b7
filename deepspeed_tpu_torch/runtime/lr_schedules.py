"""LR schedules (LRRangeTest, OneCycle, WarmupLR, WarmupDecayLR,
WarmupCosineLR) as pure ``step -> lr`` functions of the update count.

Counterpart of ``deepspeed_tpu/runtime/lr_schedules.py`` (:27-168),
copied as plain Python: the same formulas give the same floats.  The
engine applies ``schedule(k)`` to update k (0-based), so a ``WarmupLR``
with ``warmup_min_lr=0`` applies lr 0 on the first step, as optax's
count does in the JAX engine.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Optional

Schedule = Callable[[int], float]

LR_RANGE_TEST = "LRRangeTest"
ONE_CYCLE = "OneCycle"
WARMUP_LR = "WarmupLR"
WARMUP_DECAY_LR = "WarmupDecayLR"
WARMUP_COSINE_LR = "WarmupCosineLR"

VALID_LR_SCHEDULES = [LR_RANGE_TEST, ONE_CYCLE, WARMUP_LR, WARMUP_DECAY_LR,
                      WARMUP_COSINE_LR]


def lr_range_test(lr_range_test_min_lr: float = 1e-3,
                  lr_range_test_step_size: int = 2000,
                  lr_range_test_step_rate: float = 1.0,
                  lr_range_test_staircase: bool = False, **_) -> Schedule:
    def schedule(step):
        interval = step / lr_range_test_step_size
        if lr_range_test_staircase:
            interval = math.floor(interval)
        return lr_range_test_min_lr * (1.0 + interval
                                       * lr_range_test_step_rate)
    return schedule


def one_cycle(cycle_min_lr: float = 1e-5, cycle_max_lr: float = 1e-3,
              cycle_first_step_size: int = 2000,
              cycle_second_step_size: Optional[int] = None,
              decay_step_size: int = 0, decay_lr_rate: float = 0.0,
              **_) -> Schedule:
    second = cycle_second_step_size or cycle_first_step_size
    total = cycle_first_step_size + second

    def schedule(step):
        if step < cycle_first_step_size:
            frac = step / cycle_first_step_size
            return cycle_min_lr + (cycle_max_lr - cycle_min_lr) * frac
        if step < total:
            frac = (step - cycle_first_step_size) / second
            return cycle_max_lr - (cycle_max_lr - cycle_min_lr) * frac
        if decay_step_size > 0:
            decay_steps = (step - total) / decay_step_size
            return cycle_min_lr / (1.0 + decay_lr_rate * decay_steps)
        return cycle_min_lr
    return schedule


def warmup_lr(warmup_min_lr: float = 0.0, warmup_max_lr: float = 1e-3,
              warmup_num_steps: int = 1000, warmup_type: str = "log",
              **_) -> Schedule:
    warmup_num_steps = max(warmup_num_steps, 2)

    def schedule(step):
        if step >= warmup_num_steps:
            return warmup_max_lr
        if warmup_type == "log":
            frac = math.log(step + 1) / math.log(warmup_num_steps)
        else:
            frac = step / warmup_num_steps
        return warmup_min_lr + (warmup_max_lr - warmup_min_lr) * min(frac,
                                                                     1.0)
    return schedule


def warmup_decay_lr(total_num_steps: int, warmup_min_lr: float = 0.0,
                    warmup_max_lr: float = 1e-3, warmup_num_steps: int = 1000,
                    warmup_type: str = "log", **_) -> Schedule:
    base = warmup_lr(warmup_min_lr, warmup_max_lr, warmup_num_steps,
                     warmup_type)

    def schedule(step):
        if step < warmup_num_steps:
            return base(step)
        frac = max(0.0, (total_num_steps - step)
                   / max(total_num_steps - warmup_num_steps, 1))
        return warmup_max_lr * frac
    return schedule


def warmup_cosine_lr(total_num_steps: int, warmup_min_ratio: float = 0.0,
                     warmup_num_steps: int = 1000, cos_min_ratio: float = 1e-4,
                     warmup_max_lr: float = 1e-3, **_) -> Schedule:
    def schedule(step):
        if step < warmup_num_steps:
            frac = warmup_min_ratio + (1 - warmup_min_ratio) * (
                step / max(warmup_num_steps, 1))
            return warmup_max_lr * frac
        progress = min((step - warmup_num_steps)
                       / max(total_num_steps - warmup_num_steps, 1), 1.0)
        cos = 0.5 * (1 + math.cos(math.pi * progress))
        return warmup_max_lr * (cos_min_ratio + (1 - cos_min_ratio) * cos)
    return schedule


_FACTORY = {
    LR_RANGE_TEST: lr_range_test,
    ONE_CYCLE: one_cycle,
    WARMUP_LR: warmup_lr,
    WARMUP_DECAY_LR: warmup_decay_lr,
    WARMUP_COSINE_LR: warmup_cosine_lr,
}


def get_lr_schedule(sched_type: str, params: Dict[str, Any],
                    base_lr: float) -> Schedule:
    if sched_type not in _FACTORY:
        raise ValueError(f"unknown scheduler {sched_type!r}; valid: "
                         f"{VALID_LR_SCHEDULES}")
    params = dict(params)
    params.setdefault("warmup_max_lr", base_lr)
    return _FACTORY[sched_type](**params)


class LRScheduler:
    """Stateful wrapper with the reference object API (``step()``,
    ``get_last_lr()``, ``state_dict()``)."""

    def __init__(self, schedule: Schedule, last_step: int = 0):
        self.schedule = schedule
        self.last_batch_iteration = last_step

    def step(self, last_batch_iteration: Optional[int] = None):
        if last_batch_iteration is not None:
            self.last_batch_iteration = last_batch_iteration
        else:
            self.last_batch_iteration += 1

    def get_last_lr(self):
        return [self.schedule(self.last_batch_iteration)]

    def state_dict(self):
        return {"last_batch_iteration": self.last_batch_iteration}

    def load_state_dict(self, sd):
        self.last_batch_iteration = sd["last_batch_iteration"]
