"""The device trace of a ``--trace 1`` run and the arithmetic over it.

``capture`` runs the measured window under ``torch.profiler`` (CPU and CUDA
activity) and ``from_kineto`` reduces the profiler's raw events to a
``Trace``: every device operation (kernel, memcpy, memset) with its
interval and the layer it belongs to, the window's interval, and the host
operations of the window's thread.

A device operation's layer is the innermost ``nerfbench/<layer>`` range
(``spans.py``) around the runtime call that launched it (matched by the
launch's own id; a kernel launched through ``ctypes`` in a custom
backward names no operation). A backward
kernel is launched by the autograd engine outside those ranges; it takes
the layer of the forward operation that recorded its autograd node (the
profiler's sequence number), so a layer's time holds its forward and its
backward.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Optional

__all__ = ['DeviceOp', 'Trace', 'innermost', 'union_ns', 'capture',
           'from_kineto', 'SPAN_PREFIX', 'WINDOW_SPAN']

SPAN_PREFIX = 'nerfbench/'
WINDOW_SPAN = SPAN_PREFIX + 'window'
_BACKWARD = 'autograd::engine::evaluate_function: '
_RUNTIME = ('cuda', 'cu')          # CUDA runtime and driver calls


@dataclass
class DeviceOp:
    name: str
    start_ns: int
    end_ns: int
    layer: Optional[str] = None


@dataclass
class Trace:
    """Device operations and the window, in one nanosecond clock.
    ``host`` holds the window thread's host operations as (start, end,
    name), for the idle gaps' breakdown."""
    ops: list[DeviceOp]
    window: tuple[int, int]
    host: list[tuple[int, int, str]] = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def in_window(self) -> list[DeviceOp]:
        t0, t1 = self.window
        return [op for op in self.ops if op.end_ns > t0 and op.start_ns < t1]

    def busy_s(self) -> float:
        """Seconds in which some device operation ran: the union of their
        intervals within the window (not the sum of their durations,
        which counts overlapping operations twice)."""
        t0, t1 = self.window
        return union_ns([(max(op.start_ns, t0), min(op.end_ns, t1))
                         for op in self.in_window()]) / 1e9

    def layer_s(self, layer: str) -> Optional[float]:
        """Summed device seconds of the layer's operations in the window;
        None where the layer launched nothing."""
        t0, t1 = self.window
        ops = [op for op in self.in_window() if op.layer == layer]
        if not ops:
            return None
        return sum(min(op.end_ns, t1) - max(op.start_ns, t0)
                   for op in ops) / 1e9

    def layers_s(self) -> dict:
        """Device seconds in the window by layer ('' for operations
        launched outside every range)."""
        t0, t1 = self.window
        out: dict[str, float] = {}
        for op in self.in_window():
            key = op.layer or ''
            out[key] = out.get(key, 0.0) + \
                (min(op.end_ns, t1) - max(op.start_ns, t0)) / 1e9
        return out

    def count(self) -> int:
        return len(self.in_window())

    def top_ops(self, n: int = 10) -> list[list]:
        """The device operations that took most time, by name."""
        by_name: dict[str, float] = {}
        t0, t1 = self.window
        for op in self.in_window():
            by_name[op.name] = by_name.get(op.name, 0.0) + \
                (min(op.end_ns, t1) - max(op.start_ns, t0)) / 1e9
        return [[k, v] for k, v in sorted(by_name.items(),
                                          key=lambda kv: -kv[1])[:n]]

    def idle_gaps(self, n: int = 10) -> list[list]:
        """The device's idle time in the window, by the innermost host
        operation of the window's thread that was running when each gap
        began; the ``n`` largest totals."""
        t0, t1 = self.window
        spans = sorted((max(op.start_ns, t0), min(op.end_ns, t1))
                       for op in self.in_window())
        gaps, cursor = [], t0
        for start, end in spans:
            if start > cursor:
                gaps.append((cursor, start))
            cursor = max(cursor, end)
        if cursor < t1:
            gaps.append((cursor, t1))
        names = innermost([(s, e, name) for s, e, name in self.host],
                          [g[0] for g in gaps])
        totals: dict[str, float] = {}
        for (start, end), name in zip(gaps, names):
            key = name or 'no host operation'
            totals[key] = totals.get(key, 0.0) + (end - start) / 1e9
        return [[k, v] for k, v in sorted(totals.items(),
                                          key=lambda kv: -kv[1])[:n]]


def union_ns(intervals) -> int:
    """Length of the union of (start, end) intervals."""
    total, cur_s, cur_e = 0, None, None
    for s, e in sorted(intervals):
        if e <= s:
            continue
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def innermost(ranges, points) -> list:
    """For each point, the payload of the innermost of the properly nested
    (start, end, payload) ``ranges`` that holds it, or None."""
    ranges = sorted(ranges, key=lambda r: (r[0], -r[1]))
    order = sorted(range(len(points)), key=lambda i: points[i])
    out: list = [None] * len(points)
    stack: list = []
    j = 0
    for i in order:
        t = points[i]
        while j < len(ranges) and ranges[j][0] <= t:
            while stack and stack[-1][1] < ranges[j][0]:
                stack.pop()
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out[i] = stack[-1][2] if stack else None
    return out


def capture(fn: Callable[[], object]):
    """(fn's result, the raw profiler events) of ``fn`` run under
    ``torch.profiler`` with CPU and CUDA activity. ``fn`` opens the
    ``WINDOW_SPAN`` range around what it measures."""
    from torch.profiler import ProfilerActivity, profile, \
        supported_activities
    prof = profile(activities=[a for a in (ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA)
                               if a in supported_activities()])
    prof.start()
    try:
        result = fn()
    finally:
        prof.stop()
    return result, prof.profiler.kineto_results.events()


def _is_device(event) -> bool:
    return 'CUDA' in str(event.device_type())


def from_kineto(events) -> Trace:
    """A ``Trace`` from the profiler's raw events (see the module's
    docstring for how each device operation finds its layer)."""
    host, device = [], []
    for e in events:
        if _is_device(e):
            annotation = getattr(e, 'is_user_annotation', lambda: False)()
            if not annotation and not e.name().startswith(SPAN_PREFIX):
                device.append(e)
        else:
            host.append(e)
    window = [e for e in host if e.name() == WINDOW_SPAN]
    if not window:
        raise RuntimeError(f'the trace holds no {WINDOW_SPAN} range')
    w = window[0]
    main_thread = w.start_thread_id()
    by_corr, runtime = {}, {}
    spans: dict[int, list] = {}
    backward: dict[int, list] = {}
    forward_start: dict[tuple, tuple] = {}
    main_ops = []
    for e in host:
        start, end = e.start_ns(), e.start_ns() + e.duration_ns()
        thread, name = e.start_thread_id(), e.name()
        if name.startswith(_RUNTIME):
            runtime.setdefault(e.correlation_id(), e)
        elif e.linked_correlation_id() == 0:
            # Operations and ranges; a runtime call (cudaLaunchKernel)
            # carries the launch's own id, a number of another series.
            by_corr.setdefault(e.correlation_id(), e)
        if name.startswith(SPAN_PREFIX) and name != WINDOW_SPAN:
            spans.setdefault(thread, []).append(
                (start, end, name[len(SPAN_PREFIX):]))
        if name.startswith(_BACKWARD):
            if e.sequence_nr() >= 0:
                backward.setdefault(thread, []).append(
                    (start, end, (e.fwd_thread_id(), e.sequence_nr())))
        elif e.sequence_nr() >= 0 and e.fwd_thread_id() == 0:
            # Every operation records the number the next autograd node
            # will take; the node's creator is the last of them.
            key = (thread, e.sequence_nr())
            if start >= forward_start.get(key, (thread, -1))[1]:
                forward_start[key] = (thread, start)
        if thread == main_thread and not name.startswith(SPAN_PREFIX):
            main_ops.append((start, end, name))

    # Each device operation's launch on the host: (thread, time) of the
    # runtime call with its own id, else of the operation it names.
    launch = []
    for d in device:
        call = runtime.get(d.correlation_id())
        op = call if call is not None else \
            by_corr.get(d.linked_correlation_id()) \
            if d.linked_correlation_id() else None
        launch.append(None if op is None else
                      (op.start_thread_id(), op.start_ns()))
    # Launches inside a backward node take its forward operation's time.
    queries: dict[int, list] = {}
    for i, at in enumerate(launch):
        if at is not None:
            queries.setdefault(at[0], []).append(i)
    for thread, idx in queries.items():
        nodes = innermost(backward.get(thread, []),
                          [launch[i][1] for i in idx])
        for i, node in zip(idx, nodes):
            if node is not None:
                launch[i] = forward_start.get(node)
    labels: list = [None] * len(device)
    queries = {}
    for i, at in enumerate(launch):
        if at is not None:
            queries.setdefault(at[0], []).append(i)
    for thread, idx in queries.items():
        found = innermost(spans.get(thread, []),
                          [launch[i][1] for i in idx])
        for i, layer in zip(idx, found):
            labels[i] = layer
    ops = [DeviceOp(d.name(), d.start_ns(), d.start_ns() + d.duration_ns(),
                    labels[i]) for i, d in enumerate(device)]
    return Trace(ops, (w.start_ns(), w.start_ns() + w.duration_ns()),
                 main_ops)
