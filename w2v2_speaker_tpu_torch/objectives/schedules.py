"""Learning-rate schedules: plain functions from the step count to the lr.

Counterpart of ``w2v2_speaker_tpu/objectives/schedules.py::one_cycle``
(:45), which is ``optax.cosine_onecycle_schedule``: a piecewise cosine from
max_lr / div_factor up to max_lr over the first ``int(pct_start * T)``
steps, then down to max_lr / (div_factor * final_div_factor) at step
``int(T)``, constant after. ``torch.optim.lr_scheduler.OneCycleLR`` ends
each phase one step earlier and would give other rates. The other schedules
are not ported yet (ROADMAP Queue 1 item 3).
"""

from __future__ import annotations

import math
from typing import Callable

__all__ = ["one_cycle"]

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
