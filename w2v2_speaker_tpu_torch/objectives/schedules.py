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
``gamma`` at each milestone the step count has reached. The other
schedules are not ported yet (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

__all__ = ["multi_step_decay", "one_cycle", "tri_stage"]

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
