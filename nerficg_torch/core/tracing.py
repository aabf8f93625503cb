"""The program's layer spans and counters, on while a profiler records.

Tracing is on exactly while a ``torch.profiler`` records in this process:
the benchmark's ``--trace 1`` window and the trainer's
``TRAINING.TIMING.PROFILE`` window. No config key or environment variable
turns it on.

* ``span(name)`` (``with``) and ``traced(name)`` (a decorator) open a
  ``record_function`` range named ``nerficg/<name>``. Its start, end and
  nesting land in the profiler's own event list, on the clock the
  profiler puts the card's kernels on, so the span store is the
  profiler's trace. With tracing off a span is one flag check and a
  shared no-op context: an unguarded ``record_function`` with no profiler
  costs ~6.5 us on the CPU, the check ~0.1 us.
* ``count(name, value)`` keeps an int or a device tensor whose elements
  add to the counter ``name``, while tracing is on: no kernel is launched
  and nothing waits for the card. Whoever opened the profiler sums them
  with ``counters()`` (one wait) and clears them with ``reset_counters()``,
  outside the hot loop. A caller that would have to reduce a tensor of
  the model's size to count it checks ``enabled()`` first, so that no
  reduction runs with tracing off.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.profiler import record_function

__all__ = ['PREFIX', 'enabled', 'span', 'traced', 'count', 'counters',
           'reset_counters']

PREFIX = 'nerficg/'

# Whether a profiler records in this process, and so tracing is on.
enabled = torch._C._autograd._profiler_enabled

_OFF = contextlib.nullcontext()
_counters: dict[str, list] = {}


def span(name: str):
    """A context: the range ``nerficg/<name>`` while tracing is on, else
    a shared no-op."""
    return record_function(PREFIX + name) if enabled() else _OFF


def traced(name: str):
    """Decorator form of ``span``: each call runs inside the range."""
    label = PREFIX + name

    def decorate(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            if not enabled():
                return fn(*args, **kwargs)
            with record_function(label):
                return fn(*args, **kwargs)
        return wrapper
    return decorate


def count(name: str, value) -> None:
    """Add ``value``, an int or an integer tensor (the sum of its
    elements), to the counter ``name`` while tracing is on. A tensor is
    kept as it is, on its device, until ``counters()``."""
    if enabled():
        _counters.setdefault(name, []).append(value)


def counters() -> dict[str, int]:
    """Every counter's total; the device's sums read at once."""
    out, sums = {}, {}
    for name, values in _counters.items():
        out[name] = sum(int(v) for v in values
                        if not isinstance(v, torch.Tensor))
        tensors = [v.reshape(-1) for v in values
                   if isinstance(v, torch.Tensor)]
        if tensors:
            device = tensors[0].device
            sums[name] = torch.cat([t.to(device, torch.int64)
                                    for t in tensors]).sum()
    if sums:
        device = next(iter(sums.values())).device
        read = torch.stack([v.to(device) for v in sums.values()]).tolist()
        for name, total in zip(sums, read):
            out[name] += total
    return out


def reset_counters() -> None:
    _counters.clear()
