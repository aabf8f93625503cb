"""Training callback engine: decorators, scheduling and timing.

Port of nerficg_tpu/methods/base/callbacks.py (reference:
src/Methods/Base/utils.py:12-92 and the gating in
src/Methods/Base/Trainer.py:261-291). Callbacks decide on the host when work
runs; ``CallbackTimer`` waits for the card with ``torch.cuda.synchronize``.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

__all__ = ['pre_training_callback', 'training_callback',
           'post_training_callback', 'CallbackTimer', 'gather_callbacks',
           'CallbackMeta', 'PRE', 'MAIN', 'POST']

PRE, MAIN, POST = -1, 0, 1


@dataclass
class CallbackMeta:
    callback_type: int
    active: Any = True                  # bool or config-key string
    priority: int = 50
    start_iteration: Any = 0            # int or config-key string
    end_iteration: Any = None
    iteration_stride: Any = 1

    def resolve(self, trainer) -> 'CallbackMeta':
        """Resolve string-valued fields against the trainer's attributes and
        config; a missing or None value disables or neutralizes the field
        (reference: Trainer.py:261-285)."""
        def _res(value):
            return _lookup_attr(trainer, value) if isinstance(value, str) \
                else value
        end = None if self.end_iteration is None else _res(self.end_iteration)
        return CallbackMeta(
            callback_type=self.callback_type,
            active=bool(_res(self.active)),
            priority=int(_res(self.priority)),
            start_iteration=int(_res(self.start_iteration) or 0),
            end_iteration=None if end is None else int(end),
            iteration_stride=max(int(_res(self.iteration_stride) or 1), 1))

    def is_due(self, iteration: int) -> bool:
        if not self.active or iteration < self.start_iteration:
            return False
        if self.end_iteration is not None and iteration > self.end_iteration:
            return False
        return (iteration - self.start_iteration) % self.iteration_stride == 0


def _lookup_attr(trainer, dotted: str):
    node = trainer
    for part in dotted.split('.'):
        node = node.get(part) if isinstance(node, dict) \
            else getattr(node, part, None)
        if node is None:
            return None
    return node


def _make_decorator(callback_type: int):
    def factory(active: Any = True, priority: int = 50,
                start_iteration: Any = 0, end_iteration: Any = None,
                iteration_stride: Any = 1):
        def decorator(fn: Callable) -> Callable:
            fn.__callback_meta__ = CallbackMeta(
                callback_type=callback_type, active=active, priority=priority,
                start_iteration=start_iteration, end_iteration=end_iteration,
                iteration_stride=iteration_stride)
            return fn
        return decorator
    return factory


pre_training_callback = _make_decorator(PRE)
training_callback = _make_decorator(MAIN)
post_training_callback = _make_decorator(POST)


def gather_callbacks(trainer, callback_type: int
                     ) -> list[tuple[CallbackMeta, Callable]]:
    """Active callbacks of one type by class-member reflection, by
    priority, highest first (reference: Trainer.py:287-291)."""
    found = []
    for name in dir(type(trainer)):
        member = getattr(type(trainer), name, None)
        meta: Optional[CallbackMeta] = getattr(member, '__callback_meta__',
                                               None)
        if meta is not None and meta.callback_type == callback_type:
            resolved = meta.resolve(trainer)
            if resolved.active:
                found.append((resolved, getattr(trainer, name)))
    found.sort(key=lambda pair: -pair[0].priority)
    return found


class CallbackTimer:
    """Accumulating wall-time timer (reference: Methods/Base/utils.py:12-33).

    On every ``sample_every``-th exit it waits for the card, so the totals
    include the device work the timed calls queued; the calls in between
    are timed at enqueue and the sampled waits absorb their device time."""

    def __init__(self, name: str = '', sample_every: int = 1,
                 device: torch.device | str = 'cpu'):
        self.name = name
        self.total = 0.0
        self.count = 0
        self._start = 0.0
        self._sample_every = max(int(sample_every), 1)
        self._device = torch.device(device)

    def __enter__(self):
        self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._device.type == 'cuda' and \
                self.count % self._sample_every == 0:
            torch.cuda.synchronize(self._device)
        self.total += time.perf_counter() - self._start
        self.count += 1
        return False

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)

    def summary(self) -> str:
        return (f'{self.name}: total {self.total:.3f}s over {self.count} '
                f'calls (mean {self.mean * 1e3:.3f}ms)')
