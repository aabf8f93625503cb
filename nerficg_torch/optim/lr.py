"""Learning-rate schedules, ported from nerficg_tpu/optim/lr.py, plus the
optax form D-NeRF's trainer takes from optax. A schedule maps the
optimizer's step count, taken before the update as optax does, to the
learning rate."""

from __future__ import annotations

import math
from typing import Callable

__all__ = ['multistep_lr', 'lr_decay_policy', 'exponential_decay',
           'optax_exponential_decay']


def lr_decay_policy(lr_init: float, lr_final: float, max_steps: int,
                    lr_delay_steps: int = 0,
                    lr_delay_mult: float = 1.0) -> Callable[[int], float]:
    """Log-linear init -> final over ``max_steps``, with an optional
    cosine-delayed warm-up over ``lr_delay_steps`` that starts at
    ``lr_delay_mult`` times the rate (reference: Optim/lr_utils.py:9-33)."""

    def schedule(step: int) -> float:
        t = min(max(step / max(max_steps, 1), 0.0), 1.0)
        log_lerp = math.exp((1.0 - t) * math.log(lr_init) +
                            t * math.log(lr_final))
        if lr_delay_steps > 0:
            ramp = min(max(step / lr_delay_steps, 0.0), 1.0)
            delay = lr_delay_mult + (1.0 - lr_delay_mult) * math.sin(
                0.5 * math.pi * ramp)
        else:
            delay = 1.0
        return delay * log_lerp

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


def exponential_decay(lr_init: float, lr_final: float,
                      max_steps: int) -> Callable[[int], float]:
    """lr_init * (lr_final / lr_init)^t with t = step / max_steps clamped to
    [0, 1]: log-linear from init to final, then held."""

    def schedule(step: int) -> float:
        t = min(max(step / max(max_steps, 1), 0.0), 1.0)
        return lr_init * (lr_final / lr_init) ** t

    return schedule


def optax_exponential_decay(lr_init: float, transition_steps: int,
                            decay_rate: float) -> Callable[[int], float]:
    """lr_init * decay_rate^(step / transition_steps), not staircased and
    not clamped (``optax.exponential_decay`` with its other arguments at
    their defaults)."""

    def schedule(step: int) -> float:
        return lr_init * decay_rate ** (step / transition_steps)

    return schedule
