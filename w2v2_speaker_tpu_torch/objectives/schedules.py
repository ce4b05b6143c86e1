"""Learning-rate schedules: plain functions from the step count to the lr.

Counterpart of ``w2v2_speaker_tpu/objectives/schedules.py::one_cycle``
(:45), which is ``optax.cosine_onecycle_schedule``: a piecewise cosine from
max_lr / div_factor up to max_lr over the first ``int(pct_start * T)``
steps, then down to max_lr / (div_factor * final_div_factor) at step
``int(T)``, constant after. ``torch.optim.lr_scheduler.OneCycleLR`` ends
each phase one step earlier and would give other rates. ``tri_stage``
(:61) is the reference's three-stage schedule: linear warm-up from
initial_lr to base_lr over ``floor(ratio * max_steps)`` steps, constant,
then exponential decay to final_lr, index for index with its linspace and
logspace tables. ``multi_step_decay`` (:115) multiplies the rate by
``gamma`` at each milestone the step count has reached, ``step_decay``
(:107) every ``step_size`` steps. ``constant`` (:103) is StepLR with gamma
1, ``exp_decay`` (:127) the tri-stage schedule with stage ratios 0/0/1, and
``cyclic`` (:131) torch's ``CyclicLR`` in its triangular mode, with
``step_size_down`` defaulting to ``step_size_up``.
``ReduceLROnPlateauController`` (:148) is the host-side controller of the
``reduce_on_plateau`` schedule: the train loop feeds it each validation's
metric and multiplies the base rate by its factor. ``PlateauSchedule`` is
the rate that reaches the optimizer under that schedule: the base rate
times the controller's factor, in float32, as the JAX package injects it
(``runtime/experiment.py::_scale_injected_lr`` :1030); its state is the
controller's, so a checkpoint carries it. ``get_schedule`` (:197) builds a
schedule by name.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Sequence

import numpy as np

__all__ = [
    "PlateauSchedule", "ReduceLROnPlateauController", "constant", "cyclic", "exp_decay", "get_schedule", "multi_step_decay", "one_cycle",
    "step_decay", "tri_stage",
]

Schedule = Callable[[int], float]


def one_cycle(
    max_lr: float,
    total_steps: int,
    pct_start: float = 0.3,
    div_factor: float = 25.0,
    final_div_factor: float = 1e4,
) -> Schedule:
    if total_steps <= 0:
        raise ValueError("one_cycle needs total_steps > 0")
    bounds = (0, int(pct_start * total_steps), int(total_steps))
    values = (max_lr / div_factor, max_lr, max_lr / (div_factor * final_div_factor))

    def schedule(step: int) -> float:
        for i in range(2):
            if bounds[i] <= step < bounds[i + 1]:
                pct = (step - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1.0)
        return values[-1]

    return schedule


def tri_stage(
    max_steps: int,
    warmup_stage_ratio: float,
    constant_stage_ratio: float,
    decay_stage_ratio: float,
    initial_lr: float,
    base_lr: float,
    final_lr: float,
) -> Schedule:
    if abs(warmup_stage_ratio + constant_stage_ratio + decay_stage_ratio - 1.0) >= 1e-9:
        raise ValueError("stage ratios need to add up to 1")
    w = math.floor(max_steps * warmup_stage_ratio)
    c = math.floor(max_steps * constant_stage_ratio)
    d = math.floor(max_steps * decay_stage_ratio)

    def schedule(step: int) -> float:
        if step < w:  # linspace(initial, base, w)[step]
            return initial_lr + (base_lr - initial_lr) * step / max(w - 1, 1)
        if step <= w + c:
            return base_lr
        if step <= max_steps:  # logspace(ln base, ln final, d + 2)[step - (w + c)]
            j = step - (w + c)
            return math.exp(math.log(base_lr) + (math.log(final_lr) - math.log(base_lr)) * j / max(d + 1, 1))
        return final_lr

    return schedule


def multi_step_decay(lr: float, milestones: Sequence[int], gamma: float = 0.1) -> Schedule:
    """lr x gamma^k, k the number of milestones <= step."""
    ms = sorted(milestones)

    def schedule(step: int) -> float:
        return lr * gamma ** sum(step >= m for m in ms)

    return schedule


def constant(lr: float) -> Schedule:
    return lambda step: lr


def step_decay(lr: float, step_size: int, gamma: float = 0.1) -> Schedule:
    """lr x gamma^(step // step_size)."""
    return lambda step: lr * gamma ** (step // step_size)


def exp_decay(max_steps: int, base_lr: float, final_lr: float) -> Schedule:
    return tri_stage(max_steps, 0.0, 0.0, 1.0, base_lr, base_lr, final_lr)


def cyclic(base_lr: float, max_lr: float, step_size_up: int, step_size_down: Optional[int] = None) -> Schedule:
    """Up from base_lr to max_lr over ``step_size_up`` steps, down over
    ``step_size_down``, and again."""
    down = step_size_down if step_size_down is not None else step_size_up
    period = step_size_up + down

    def schedule(step: int) -> float:
        pos = step % period
        frac = pos / step_size_up if pos < step_size_up else (period - pos) / down
        return base_lr + (max_lr - base_lr) * frac

    return schedule


class ReduceLROnPlateauController:
    """torch's ``ReduceLROnPlateau`` on the host: ``update(metric)`` after
    each validation returns the factor (``factor`` to the power of the
    plateaus seen, floored at ``min_factor``) that multiplies the base
    rate. A plateau is more than ``patience`` validations in a row that do
    not beat the best. ``state_dict`` / ``load_state_dict`` carry the best
    metric, the count of validations without improvement and the factor."""

    def __init__(self, factor: float = 0.1, patience: int = 10, mode: str = "min", min_factor: float = 1e-8):
        self.factor, self.patience, self.mode, self.min_factor = factor, patience, mode, min_factor
        self.best: Optional[float] = None
        self.bad_count = 0
        self.factor_value = 1.0

    def update(self, metric: float) -> float:
        if self.best is None or (metric < self.best if self.mode == "min" else metric > self.best):
            self.best, self.bad_count = metric, 0
        else:
            self.bad_count += 1
            if self.bad_count > self.patience:
                self.factor_value = max(self.factor_value * self.factor, self.min_factor)
                self.bad_count = 0
        return self.factor_value

    def state_dict(self) -> Dict:
        return {"best": self.best, "bad_count": self.bad_count, "factor_value": self.factor_value}

    def load_state_dict(self, state: Dict) -> None:
        self.best, self.bad_count, self.factor_value = state["best"], state["bad_count"], state["factor_value"]


class PlateauSchedule:
    """``base_lr`` x ``controller.factor_value`` at every step, rounded to
    float32."""

    def __init__(self, base_lr: float, controller: ReduceLROnPlateauController):
        self.base_lr, self.controller = base_lr, controller

    def __call__(self, step: int) -> float:
        return float(np.float32(self.base_lr * self.controller.factor_value))

    def state_dict(self) -> Dict:
        return self.controller.state_dict()

    def load_state_dict(self, state: Dict) -> None:
        self.controller.load_state_dict(state)


_SCHEDULES = {
    "one_cycle": one_cycle, "tri_stage": tri_stage, "constant": constant, "step": step_decay,
    "multi_step": multi_step_decay, "exp_decay": exp_decay, "cyclic": cyclic,
}


def get_schedule(name: str, **kwargs) -> Schedule:
    if name not in _SCHEDULES:
        raise ValueError(f"unknown schedule '{name}', available: {sorted(_SCHEDULES)}")
    return _SCHEDULES[name](**kwargs)
