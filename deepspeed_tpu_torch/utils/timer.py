"""Wall-clock and throughput timers.

Counterpart of ``deepspeed_tpu/utils/timer.py`` (reference
``deepspeed/utils/timer.py``: ``SynchronizedWallClockTimer``,
``ThroughputTimer``).  Host wall clock around the step, as in the JAX
package.  On the card a timer synchronises the device before reading the
clock only when built with ``synchronize=True`` (the engine does so under
``wall_clock_breakdown``), so the default step takes no extra sync: the
train step already ends in one (the loss read back to the host).
``ThroughputTimer`` feeds ``ds_train_step_time_ms`` and
``ds_train_samples_per_sec``.
"""

from __future__ import annotations

import time
from typing import Dict, List

import torch

from ..telemetry import metrics as tm
from .logging import logger

TRAIN_BATCH_TIMER = "train_batch"


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class _Timer:
    def __init__(self, name: str, synchronize: bool = False):
        self.name = name
        self.synchronize = synchronize
        self.started = False
        self._start = 0.0
        self._elapsed = 0.0
        self.count = 0

    def start(self):
        if self.synchronize:
            _sync()
        self.started = True
        self._start = time.perf_counter()

    def stop(self, reset: bool = False, record: bool = True):
        if not self.started:
            return
        if self.synchronize:
            _sync()
        self.started = False
        elapsed = time.perf_counter() - self._start
        if reset:
            # this interval replaces the accumulator (reference stop(reset))
            self._elapsed = elapsed if record else 0.0
            self.count = 1 if record else 0
        elif record:
            self._elapsed += elapsed
            self.count += 1

    def elapsed(self, reset: bool = True) -> float:
        value = self._elapsed
        if reset:
            self.reset()
        return value

    def reset(self):
        self._elapsed = 0.0
        self.count = 0


class SynchronizedWallClockTimer:
    def __init__(self, synchronize: bool = False):
        self.synchronize = synchronize
        self.timers: Dict[str, _Timer] = {}

    def __call__(self, name: str) -> _Timer:
        if name not in self.timers:
            self.timers[name] = _Timer(name, self.synchronize)
        return self.timers[name]

    def log(self, names: List[str], normalizer: float = 1.0,
            reset: bool = True):
        string = "time (ms)"
        for name in names:
            if name in self.timers:
                elapsed = (self.timers[name].elapsed(reset=reset) * 1000.0
                           / normalizer)
                string += f" | {name}: {elapsed:.2f}"
        logger.info(string)


class ThroughputTimer:
    def __init__(self, batch_size: int, start_step: int = 2,
                 steps_per_output: int = 50):
        self.batch_size = max(batch_size, 1)
        self.start_step = start_step
        self.steps_per_output = steps_per_output
        self.global_step_count = 0
        self.total_elapsed_time = 0.0
        self.step_elapsed_time = 0.0
        self._start = 0.0
        self.started = False

    def start(self):
        self.started = True
        self._start = time.perf_counter()

    def stop(self, global_step: bool = True, report_speed: bool = True):
        if not self.started:
            return
        self.started = False
        duration = time.perf_counter() - self._start
        self.step_elapsed_time += duration
        if global_step:
            self.global_step_count += 1
            if self.global_step_count >= self.start_step:
                # the first steps (kernel builds) stay out of the
                # registry's percentiles, as of total_elapsed_time
                self.total_elapsed_time += self.step_elapsed_time
                tm.TRAIN_STEP_TIME_MS.observe(self.step_elapsed_time * 1e3)
                tm.TRAIN_SAMPLES_PER_SEC.set(self.avg_samples_per_sec())
            if report_speed and \
                    self.global_step_count % self.steps_per_output == 0:
                logger.info("step=%d, throughput=%.2f samples/s",
                            self.global_step_count,
                            self.avg_samples_per_sec())
            self.step_elapsed_time = 0.0

    def avg_samples_per_sec(self) -> float:
        counted = max(self.global_step_count - self.start_step + 1, 1)
        if self.total_elapsed_time <= 0:
            return 0.0
        return self.batch_size * counted / self.total_elapsed_time

    def avg_step_time(self) -> float:
        """Mean wall seconds per counted global step (the flops
        profiler's duration; 0 before the first counted step)."""
        counted = max(self.global_step_count - self.start_step + 1, 1)
        if self.total_elapsed_time <= 0:
            return 0.0
        return self.total_elapsed_time / counted
