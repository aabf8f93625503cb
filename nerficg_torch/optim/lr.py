"""Learning-rate schedules, ported from nerficg_tpu/optim/lr.py (the part
training Instant-NGP uses). A schedule maps the optimizer's step count, taken
before the update as optax does, to the learning rate."""

from __future__ import annotations

from typing import Callable

__all__ = ['multistep_lr']


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
