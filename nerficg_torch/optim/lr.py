"""Learning-rate schedules, ported from nerficg_tpu/optim/lr.py (the parts
training Instant-NGP and 3DGS use). A schedule maps the optimizer's step
count, taken before the update as optax does, to the learning rate."""

from __future__ import annotations

import math
from typing import Callable

__all__ = ['multistep_lr', 'lr_decay_policy', 'exponential_decay']


def lr_decay_policy(lr_init: float, lr_final: float,
                    max_steps: int) -> Callable[[int], float]:
    """Log-linear init -> final over ``max_steps`` (reference:
    Optim/lr_utils.py:9-33; its delayed warm-up, unused by 3DGS, is not
    ported)."""

    def schedule(step: int) -> float:
        t = min(max(step / max(max_steps, 1), 0.0), 1.0)
        return math.exp((1.0 - t) * math.log(lr_init) +
                        t * math.log(lr_final))

    return schedule


def multistep_lr(lr_init: float, milestones: list[int],
                 gamma: float = 0.33) -> Callable[[int], float]:
    """lr_init * gamma^(number of milestones <= step)
    (reference: InstantNGP/Trainer.py:39-43)."""
    milestones = sorted(milestones)

    def schedule(step: int) -> float:
        factor = 1.0
        for m in milestones:
            if step >= m:
                factor *= gamma
        return lr_init * factor

    return schedule


def exponential_decay(lr_init: float, transition_steps: int,
                      decay_rate: float) -> Callable[[int], float]:
    """lr_init * decay_rate^(step / transition_steps), not staircased
    (``optax.exponential_decay`` with its other arguments at their
    defaults)."""

    def schedule(step: int) -> float:
        return lr_init * decay_rate ** (step / transition_steps)

    return schedule
