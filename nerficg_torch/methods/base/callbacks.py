"""Training callback engine: decorators, scheduling and timing.

Port of nerficg_tpu/methods/base/callbacks.py (reference:
src/Methods/Base/utils.py:12-92 and the gating in
src/Methods/Base/Trainer.py:261-291). Callbacks decide on the host when work
runs; ``CallbackTimer`` times each call on the card with CUDA events and
never waits for it inside the loop.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Optional

import torch

from nerficg_torch.core.tracing import span

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
    """Accumulating timer of one callback (reference:
    Methods/Base/utils.py:12-33), and its ``trainer/<name>`` span.

    On the card each call records a pair of CUDA events, and nothing
    waits: a pair whose end has completed is added at the next call, the
    rest when ``total`` is read (after the run's last synchronise, that
    waits for nothing). A pair spans the call's work on the card's clock,
    from where the stream reached its start to the end of what it queued;
    a callback whose host work overlaps work queued before it reads only
    what it holds the stream for. Added pairs are recorded again, as
    making and freeing events costs the host more than recording them.
    Elsewhere the host's clock around the call."""

    def __init__(self, name: str = '', device: torch.device | str = 'cpu'):
        self.name = name
        self.count = 0
        self._span_name = 'trainer/' + name
        self._total = 0.0
        self._device = torch.device(device)
        self._cuda = self._device.type == 'cuda'
        self._pending: deque = deque()
        self._free: list = []
        self._start = self._span = self._stream = None

    def __enter__(self):
        self._span = span(self._span_name)
        self._span.__enter__()
        if self._cuda:
            self._collect(wait=False)
            self._stream = torch.cuda.current_stream(self._device)
            self._start = self._event()
            self._start.record(self._stream)
        else:
            self._start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._cuda:
            end = self._event()
            end.record(self._stream)
            self._pending.append((self._start, end))
        else:
            self._total += time.perf_counter() - self._start
        self.count += 1
        self._span.__exit__(*exc)
        return False

    def _event(self):
        return self._free.pop() if self._free else \
            torch.cuda.Event(enable_timing=True)

    def _collect(self, wait: bool) -> None:
        while self._pending and (wait or self._pending[0][1].query()):
            start, end = self._pending.popleft()
            end.synchronize()
            self._total += start.elapsed_time(end) / 1e3
            self._free += (start, end)

    @property
    def total(self) -> float:
        """Seconds over every call; waits for calls still on the card."""
        self._collect(wait=True)
        return self._total

    @property
    def mean(self) -> float:
        return self.total / max(self.count, 1)

    def summary(self) -> str:
        return (f'{self.name}: total {self.total:.3f}s over {self.count} '
                f'calls (mean {self.mean * 1e3:.3f}ms)')
