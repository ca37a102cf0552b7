"""Curriculum learning scheduler.

Counterpart of ``deepspeed_tpu/runtime/data_pipeline/
curriculum_scheduler.py`` (reference ``curriculum_scheduler.py:11``,
``CurriculumScheduler``): maps global step to the current difficulty
(e.g. sequence length) with the schedule types ``fixed_linear``,
``fixed_root``, ``fixed_discrete`` and ``custom``.  Host-only Python, the
same numbers as the JAX package's.

Difficulty values are rounded to ``difficulty_step`` multiples, so a
sequence-length curriculum keeps a few padded shapes (the reference
rounds to multiples of 8 for the tensor cores).
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional

FIXED_LINEAR = "fixed_linear"
FIXED_ROOT = "fixed_root"
FIXED_DISCRETE = "fixed_discrete"
CUSTOM = "custom"


class CurriculumScheduler:
    """``config`` mirrors the reference's ``curriculum_learning`` block::

        {"curriculum_type": "seqlen", "enabled": true,
         "min_difficulty": 8, "max_difficulty": 1024,
         "schedule_type": "fixed_linear",
         "schedule_config": {"total_curriculum_step": 10000,
                             "difficulty_step": 8}}
    """

    def __init__(self, config: Dict[str, Any]):
        self.state: Dict[str, Any] = {}
        self.min_difficulty = int(config.get("min_difficulty", 1))
        self.max_difficulty = int(config.get("max_difficulty", 1))
        self.schedule_type = config.get("schedule_type", FIXED_LINEAR)
        self.schedule_config = dict(config.get("schedule_config", {}))
        self.current_difficulty = self.min_difficulty
        self._custom_fn: Optional[Callable[[int], int]] = None

        if self.schedule_type in (FIXED_LINEAR, FIXED_ROOT):
            if "total_curriculum_step" not in self.schedule_config:
                raise ValueError(
                    f"{self.schedule_type} schedule requires "
                    f"'total_curriculum_step'")
            self.schedule_config.setdefault("difficulty_step", 1)
            if self.schedule_type == FIXED_ROOT:
                self.schedule_config.setdefault("root_degree", 2)
        elif self.schedule_type == FIXED_DISCRETE:
            need = ("difficulty", "max_step")
            if not all(k in self.schedule_config for k in need):
                raise ValueError(
                    "fixed_discrete schedule requires 'difficulty' and "
                    "'max_step' lists")
            if len(self.schedule_config["max_step"]) != \
                    len(self.schedule_config["difficulty"]) - 1:
                raise ValueError("len(max_step) must be "
                                 "len(difficulty) - 1")
        elif self.schedule_type == CUSTOM:
            pass  # set_custom_get_difficulty must be called
        else:
            raise ValueError(f"unknown schedule_type {self.schedule_type!r}")

    def set_custom_get_difficulty(self, fn: Callable[[int], int]) -> None:
        self._custom_fn = fn

    # ---------------------------------------------------------- schedules
    def _rounded(self, raw: float) -> int:
        step = int(self.schedule_config.get("difficulty_step", 1))
        d = int(raw // step) * step
        return max(self.min_difficulty, min(self.max_difficulty, d))

    def get_difficulty(self, global_steps: int) -> int:
        sc = self.schedule_config
        if self.schedule_type == FIXED_LINEAR:
            frac = min(1.0, global_steps / sc["total_curriculum_step"])
            raw = self.min_difficulty + \
                (self.max_difficulty - self.min_difficulty) * frac
            return self._rounded(raw)
        if self.schedule_type == FIXED_ROOT:
            frac = min(1.0, global_steps / sc["total_curriculum_step"])
            frac = frac ** (1.0 / sc["root_degree"])
            raw = self.min_difficulty + \
                (self.max_difficulty - self.min_difficulty) * frac
            return self._rounded(raw)
        if self.schedule_type == FIXED_DISCRETE:
            for difficulty, bound in zip(sc["difficulty"], sc["max_step"]):
                if global_steps < bound:
                    return int(difficulty)
            return int(sc["difficulty"][-1])
        if self._custom_fn is None:
            raise RuntimeError("custom schedule requires "
                               "set_custom_get_difficulty()")
        return int(self._custom_fn(global_steps))

    def update_difficulty(self, global_steps: int) -> int:
        self.current_difficulty = self.get_difficulty(global_steps)
        return self.current_difficulty

    # ------------------------------------------------------- persistence
    def state_dict(self) -> Dict[str, Any]:
        return {"current_difficulty": self.current_difficulty}

    def load_state_dict(self, sd: Dict[str, Any]) -> None:
        self.current_difficulty = sd["current_difficulty"]
