"""The trace arithmetic: idle share from overlapping kernels, innermost
ranges, and each device operation's layer, forward and backward."""

import pytest

from nerfbench import spec, trace


def test_idle_is_one_minus_the_union_of_overlapping_operations():
    ops = [trace.DeviceOp('a', 0, 40), trace.DeviceOp('b', 20, 60),
           trace.DeviceOp('c', 30, 50), trace.DeviceOp('d', 80, 90),
           trace.DeviceOp('e', 95, 130)]
    t = trace.Trace(ops, (10, 110))
    # busy: [10, 60] + [80, 90] + [95, 110] = 50 + 10 + 15 = 75 of 100 ns
    assert t.busy_s() == pytest.approx(75e-9)
    assert sum(o.end_ns - o.start_ns for o in ops) > 100   # a sum would
    idle = spec.metric_module('device_idle_pct.train')

    class Ctx:
        pass
    ctx = Ctx()
    ctx.trace, ctx.units = t, [0, 1]
    assert idle.read(ctx) == pytest.approx(25.0)


def test_innermost_range():
    ranges = [(0, 100, 'outer'), (10, 20, 'a'), (30, 60, 'b'),
              (40, 50, 'c')]
    assert trace.innermost(ranges, [5, 15, 35, 45, 55, 70, 150]) == \
        ['outer', 'a', 'b', 'c', 'b', 'outer', None]


class _Event:
    def __init__(self, name, start, dur, thread=1, corr=0, linked=0,
                 seq=-1, fwd=0, device=False):
        self._v = (name, start, dur, thread, corr, linked, seq, fwd, device)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def start_thread_id(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def sequence_nr(self):
        return self._v[6]

    def fwd_thread_id(self):
        return self._v[7]

    def device_type(self):
        return 'DeviceType.CUDA' if self._v[8] else 'DeviceType.CPU'

    def is_user_annotation(self):
        return False


def test_layers_of_forward_and_backward_kernels():
    events = [
        _Event('nerfbench/window', 0, 1000, corr=1),
        _Event('nerfbench/rasterizer', 10, 200, corr=2),
        _Event('aten::sort', 20, 10, corr=3, seq=7),
        # an operation that creates no node records the number the next
        # node takes (8): the node's creator is the last one
        _Event('aten::to', 60, 5, corr=10, seq=8),
        _Event('nerfbench/composite', 100, 50, corr=4),
        _Event('_CompositeSorted', 110, 20, corr=5, seq=8),
        _Event('aten::item', 400, 100, corr=6),
        # backward, on the autograd thread, after the forward
        _Event('autograd::engine::evaluate_function: SortBackward0', 600, 50,
               thread=2, corr=7, seq=7, fwd=1),
        _Event('aten::index_put_', 610, 10, thread=2, corr=8),
        _Event('autograd::engine::evaluate_function: _CompositeSortedBackward',
               700, 50, thread=2, corr=9, seq=8, fwd=1),
        _Event('sort_kernel', 30, 40, linked=3, device=True),
        _Event('gs_fwd_kernel', 120, 30, linked=5, device=True),
        _Event('scatter_kernel', 620, 30, linked=8, device=True),
        # launched through ctypes in a custom backward: no operation named,
        # only the runtime call with the launch's own id (77)
        _Event('cudaLaunchKernel', 705, 2, thread=2, corr=77),
        _Event('gs_bwd_kernel', 710, 60, corr=77, device=True),
        _Event('memcpy', 450, 5, linked=6, device=True),
    ]
    # A runtime call whose own id is an operation's number (3), listed
    # first: it launched aten::item's memcpy, not aten::sort's kernel.
    events.insert(0, _Event('cudaMemcpyAsync', 401, 2, corr=3, linked=6))
    t = trace.from_kineto(events)
    layers = {op.name: op.layer for op in t.ops}
    assert layers == {'sort_kernel': 'rasterizer', 'gs_fwd_kernel':
                      'composite', 'scatter_kernel': 'rasterizer',
                      'gs_bwd_kernel': 'composite', 'memcpy': None}
    assert t.layer_s('rasterizer') == pytest.approx(70e-9)
    assert t.layer_s('composite') == pytest.approx(90e-9)
    assert t.layer_s('field') is None
    assert t.count() == 5
    assert t.layers_s() == pytest.approx({'rasterizer': 70e-9,
                                          'composite': 90e-9, '': 5e-9})
    gaps = dict(t.idle_gaps())
    assert gaps['aten::item'] == pytest.approx(165e-9)   # 455 -> 620
