"""Arithmetic that more than one per-layer metric reads: the program's
own counters after a traced window, and the idle time the loop leaves
between the layers.

The program (``nerficg_torch/core/tracing.py``) adds to its counters only
while a profiler records, and the ``--trace 1`` window is the only time
one records in a run, so their totals are the window's. A program without
the counters (an older checkout) reads as nothing, and so does a counter
it never added to.
"""

from __future__ import annotations

__all__ = ['program_counters', 'entries_past_k_pct', 'idle_by_layer',
           'loop_idle_pct']


def program_counters() -> dict | None:
    try:
        from nerficg_torch.core.tracing import counters
    except ImportError:
        return None
    return counters()


def entries_past_k_pct() -> float | None:
    """100 x ``gs/entries_past_k`` / ``gs/entries``: the share of the
    tile entries that the rasterizer sorts and gathers and then drops past
    a tile's budget k."""
    found = program_counters() or {}
    entries = found.get('gs/entries')
    if not entries or 'gs/entries_past_k' not in found:
        return None
    return 100.0 * found['gs/entries_past_k'] / entries


def idle_by_layer(trace) -> dict[str, int]:
    """The window's idle nanoseconds, each gap put down to the ``layer``
    of the device operation that ends it (``''`` for an operation launched
    outside every layer's range, and for the window's tail)."""
    t0, t1 = trace.window
    out: dict[str, int] = {}
    cursor = t0
    for op in sorted(trace.in_window(), key=lambda o: (o.start_ns,
                                                        o.end_ns)):
        start = max(op.start_ns, t0)
        if start > cursor:
            key = op.layer or ''
            out[key] = out.get(key, 0) + start - cursor
        cursor = max(cursor, min(op.end_ns, t1))
    if cursor < t1:
        out[''] = out.get('', 0) + t1 - cursor
    return out


def loop_idle_pct(trace) -> float | None:
    """Share of the window in which the card idles on a gap that no layer
    closes: the device operation that ends the gap was launched outside
    every layer's range, or none ends it (the window's tail). A gap that a
    layer's launch ends is that layer's lateness; these are the loop's
    (callbacks, copies, Python glue)."""
    t0, t1 = trace.window
    if not trace.in_window() or t1 <= t0:
        return None
    return 100.0 * idle_by_layer(trace).get('', 0) / (t1 - t0)
