"""One traced window of a cell, read by the program's own spans.

    python3 -m nerfbench.program_spans --workload NAME --seed N --seconds S

From the root of a checkout, on the card. It runs the cell as
``nerfbench.run --trace 1`` does, keeps the window's raw profiler events,
and reads them again by the program's ``nerficg/`` ranges
(``nerficg_torch/core/tracing.py``) instead of the benchmark's
``nerfbench/`` wrappers (``spans.py``): each device operation takes the
innermost program span around its launch, by the rules of
``trace.from_kineto`` (the launch's own id; a backward kernel its forward
node's creator). The last line of standard output is one JSON object:

* ``device_ms_per_unit_by_span``: device milliseconds per step or frame by
  span (``''`` for operations launched outside every span); they sum to
  ``device_ms_per_unit``.
* ``host_ms_per_unit_by_span``: each span's host self time on the
  window's thread (its duration less its child spans').
* ``idle_ms_per_unit_by_span``: each idle gap of the window put down to
  the span of the launch that ends it (``''`` outside every span, and the
  tail after the last operation); they sum to ``idle_ms_per_unit``.
  ``loop_idle_pct`` is the share of the window put down to the loop:
  outside every span, or in a ``trainer/`` or ``render_image`` span with
  no layer span inside.
* ``counters_per_unit``: the program's counters over the window.
* ``idle_gaps``: the window's idle time by the host operation running
  when each gap began, with the program's ranges left out as the parent
  of this reader had them; ``metrics``, ``correct``: the run's own.

Not a metric: a tool for finding where a cell's time goes, whose readings
the per-layer metrics that read the wrappers can be held against.
"""

from __future__ import annotations

import argparse
import json
import sys

from nerfbench import run, trace
from nerfbench.reads import idle_by_layer

__all__ = ['PROGRAM_PREFIX', 'LOOP_SPANS', 'by_program_spans',
           'host_self_ns', 'span_report']

PROGRAM_PREFIX = 'nerficg/'
# Spans that hold a whole step or frame: a gap ended inside one of them and
# no layer's span is the loop's.
LOOP_SPANS = ('trainer/', 'render_image')


class _Renamed:
    """A profiler event under another name."""

    def __init__(self, event, name: str):
        self._event, self._name = event, name

    def name(self) -> str:
        return self._name

    def __getattr__(self, attr):
        return getattr(self._event, attr)


def by_program_spans(events) -> trace.Trace:
    """The ``Trace`` of ``events`` with each device operation's ``layer``
    the innermost program span around its launch: the benchmark's own
    ranges (but its window) are left out, and the program's are read as
    the benchmark's would be."""
    kept = []
    for e in events:
        name = e.name()
        if name.startswith(PROGRAM_PREFIX):
            kept.append(_Renamed(e, trace.SPAN_PREFIX +
                                 name[len(PROGRAM_PREFIX):]))
        elif name == trace.WINDOW_SPAN or \
                not name.startswith(trace.SPAN_PREFIX):
            kept.append(e)
    return trace.from_kineto(kept)


def host_self_ns(events) -> dict[str, int]:
    """Each program span's host self time within the window on the
    window's thread, in nanoseconds."""
    window = next(e for e in events if e.name() == trace.WINDOW_SPAN
                  and not trace._is_device(e))
    t0 = window.start_ns()
    t1 = t0 + window.duration_ns()
    ranges = sorted(
        ((max(e.start_ns(), t0), min(e.start_ns() + e.duration_ns(), t1),
          e.name()[len(PROGRAM_PREFIX):]) for e in events
         if e.name().startswith(PROGRAM_PREFIX) and not trace._is_device(e)
         and e.start_thread_id() == window.start_thread_id()
         and e.start_ns() + e.duration_ns() > t0 and e.start_ns() < t1),
        key=lambda r: (r[0], -r[1]))
    out: dict[str, int] = {}
    stack: list = []
    for start, end, name in ranges:
        while stack and stack[-1][1] <= start:
            stack.pop()
        out[name] = out.get(name, 0) + end - start
        if stack:
            out[stack[-1][2]] -= end - start
        stack.append((start, end, name))
    return out


def _keeping_events(cell, seed: int, seconds: float, device: str):
    """``run.run_cell`` traced, and the window's raw profiler events."""
    kept = {}
    capture = trace.capture

    def keep(fn):
        result, events = capture(fn)
        kept['events'] = events
        return result, events
    trace.capture = keep
    try:
        result = run.run_cell(cell, seed, seconds, True, device=device)
    finally:
        trace.capture = capture
    return result, kept['events']


def span_report(cell, seed: int, seconds: float, device='cuda') -> dict:
    """One traced run of ``cell`` read by the program's spans (see the
    module's docstring)."""
    from nerficg_torch.core.tracing import counters, reset_counters
    reset_counters()
    result, events = _keeping_events(cell, seed, seconds, device)
    parsed = by_program_spans(events)
    units = max(result['attempted'], 1)

    def per_unit(ns: dict) -> dict:
        return {k: v / 1e6 / units for k, v in sorted(ns.items())}
    device_ns = {k: v * 1e9 for k, v in parsed.layers_s().items()}
    idle = idle_by_layer(parsed)
    loop = sum(v for k, v in idle.items()
               if not k or k.startswith(LOOP_SPANS))
    window_ns = parsed.window[1] - parsed.window[0]
    return {
        'correct': result['correct'], 'units': result['attempted'],
        'window_s': parsed.window_s,
        'metrics': {k: v['value'] for k, v in result['metrics'].items()},
        'device_ms_per_unit': sum(device_ns.values()) / 1e6 / units,
        'device_ms_per_unit_by_span': per_unit(device_ns),
        'host_ms_per_unit_by_span': per_unit(host_self_ns(events)),
        'idle_ms_per_unit': sum(idle.values()) / 1e6 / units,
        'idle_ms_per_unit_by_span': per_unit(idle),
        'loop_idle_pct': 100.0 * loop / window_ns,
        'counters_per_unit': {k: v / units
                              for k, v in sorted(counters().items())},
        'idle_gaps': parsed.idle_gaps(10),
        'device': result['device']}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    args = parser.parse_args(argv)
    run._cache_dirs()
    print(json.dumps(span_report(args.workload, args.seed, args.seconds)),
          flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
