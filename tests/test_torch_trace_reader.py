"""The benchmark's readers against the program's spans and counters, on
the CPU.

* Every per-layer metric read from the device trace, the twelve the
  benchmark had and the four added beside the program's spans, reads the
  same value from one synthetic trace (the pattern of
  ``nerfbench/tests/test_nerfbench_trace.py``) with and without the
  program's ``nerficg/`` host ranges and their ranges on the card's
  timeline (user annotations) added.
* ``frontend_ms.*`` and ``loop_idle_pct.train`` / ``viewer_idle_pct.render``
  read hand-computed values from that trace, and nothing from a trace
  without the layer or without device operations.
* ``entries_past_k_pct.train`` and ``.render`` read 100 x
  ``gs/entries_past_k`` / ``gs/entries`` from the program's counters, and
  nothing where a counter, or the program's tracing module, is absent.
* A tiny traced run of each cell on the CPU (in a child process: the
  benchmark refuses a process with JAX loaded) reports the share past k
  in the 3DGS cells, as the reference's geometry gives it, and not in
  NeRF's.
* ``nerfbench/program_spans.py`` reads the same trace by the program's
  spans: each device operation takes its span forward and backward, the
  spans' device time sums to the window's, each idle gap goes to the span
  that ends it and they sum to the window's idle time, host self times by
  hand, and the idle gaps' breakdown names no program span. A tiny run of
  it on the CPU reports the program's spans and counters.
"""

import json
import subprocess
import sys

import pytest
import torch
from torch.profiler import profile

from nerfbench import program_spans, reads, spec, trace
from nerficg_torch.core import tracing

EXISTING = ['device_idle_pct.train', 'device_idle_pct.render',
            'launches_per_step.train', 'launches_per_frame.render',
            'rasterizer_ms.train', 'rasterizer_ms.render',
            'gs_composite_roofline.train', 'gs_composite_roofline.render',
            'field_ms.train', 'adam_ms.train', 'mfu_pct.train',
            'mfu_pct.render']
TRACED = ['frontend_ms.train', 'frontend_ms.render', 'loop_idle_pct.train',
          'viewer_idle_pct.render']
NEW = ['entries_past_k_pct.train', 'entries_past_k_pct.render']


class _Event:
    def __init__(self, name, start, dur, thread=1, corr=0, linked=0,
                 seq=-1, fwd=0, device=False, annotation=False):
        self._v = (name, start, dur, thread, corr, linked, seq, fwd, device,
                   annotation)

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
        return self._v[9]


def _events(program: bool) -> list:
    """One traced training step: the benchmark's ``nerfbench/`` ranges
    around its layers' functions, forward operations and their kernels,
    backward nodes on the autograd thread, a ctypes launch, a copy and an
    idle tail; with ``program`` also the program's spans and their
    annotations on the card's timeline."""
    events = [
        _Event('nerfbench/window', 0, 10000, corr=1),
        _Event('nerfbench/frontend', 100, 300, corr=2),
        _Event('aten::bmm', 120, 50, corr=3, seq=1),
        _Event('nerfbench/field', 400, 100, corr=4),
        _Event('aten::mm', 410, 20, corr=5, seq=2),
        _Event('nerfbench/rasterizer', 600, 600, corr=6),
        _Event('aten::sort', 620, 10, corr=7, seq=3),
        _Event('nerfbench/composite', 800, 100, corr=8),
        _Event('_CompositeSorted', 810, 20, corr=9, seq=4),
        _Event('nerfbench/loss', 1300, 100, corr=10),
        _Event('aten::mean', 1310, 10, corr=11, seq=5),
        _Event('aten::item', 1500, 100, corr=12),
        _Event('autograd::engine::evaluate_function: SortBackward0', 2000,
               100, thread=2, corr=13, seq=3, fwd=1),
        _Event('aten::index_put_', 2010, 10, thread=2, corr=14),
        _Event('autograd::engine::evaluate_function: '
               '_CompositeSortedBackward', 2300, 100, thread=2, corr=15,
               seq=4, fwd=1),
        _Event('cudaLaunchKernel', 2305, 2, thread=2, corr=77),
        _Event('autograd::engine::evaluate_function: MmBackward0', 2500,
               100, thread=2, corr=16, seq=2, fwd=1),
        _Event('aten::mm', 2510, 10, thread=2, corr=17),
        _Event('nerfbench/optimizer', 3000, 500, corr=18),
        _Event('aten::_foreach_add_', 3010, 10, corr=19),
        # the card
        _Event('gemm_kernel', 150, 150, linked=3, device=True),
        _Event('mm_kernel', 450, 70, linked=5, device=True),
        _Event('sort_kernel', 640, 60, linked=7, device=True),
        _Event('gs_fwd_kernel', 830, 50, linked=9, device=True),
        _Event('mean_kernel', 1320, 30, linked=11, device=True),
        _Event('memcpy', 1550, 10, linked=12, device=True),
        _Event('scatter_kernel', 2050, 150, linked=14, device=True),
        _Event('gs_bwd_kernel', 2310, 90, corr=77, device=True),
        _Event('mm_bwd_kernel', 2530, 70, linked=17, device=True),
        _Event('adam_kernel', 3050, 150, linked=19, device=True),
        _Event('nerfbench/frontend', 150, 150, device=True, annotation=True),
    ]
    if program:
        step = 'nerficg/trainer/training_iteration'
        events += [
            _Event(step, 50, 3550, corr=101),
            _Event('nerficg/frontend', 105, 285, corr=102),
            _Event('nerficg/field', 405, 90, corr=103),
            _Event('nerficg/rasterizer', 605, 585, corr=104),
            _Event('nerficg/composite', 795, 110, corr=105),
            _Event('nerficg/loss', 1295, 110, corr=106),
            _Event('nerficg/optimizer', 3005, 490, corr=107),
            _Event(step, 150, 3050, device=True, annotation=True),
            _Event('nerficg/frontend', 150, 150, device=True,
                   annotation=True),
            _Event('nerficg/rasterizer', 640, 240, device=True,
                   annotation=True),
            _Event('nerficg/composite', 830, 50, device=True,
                   annotation=True),
            _Event('nerficg/optimizer', 3050, 150, device=True,
                   annotation=True)]
    return events


class _Ctx:
    def __init__(self, events):
        self.trace = trace.from_kineto(events)
        self.units = [0, 1]
        self.peak_flops = 67e12

    def work(self):
        return [{'entries': 5000, 'passing': 40000, 'num_tiles': 80,
                 'live_chunks': 200, 'stream_entries': 9000,
                 'gaussians': 4000, 'pixels': 20000, 'flops': 1e9}] * 2


def _read(names, ctx) -> dict:
    return {name: spec.metric_module(name).read(ctx) for name in names}


def test_device_metrics_read_the_same_with_the_program_spans():
    before = _read(EXISTING + TRACED, _Ctx(_events(program=False)))
    after = _read(EXISTING + TRACED, _Ctx(_events(program=True)))
    assert after == before
    assert None not in before.values()
    assert before['launches_per_step.train'] == 10 / 2
    assert before['rasterizer_ms.train'] == pytest.approx(1e3 * 210e-9 / 2)


def test_frontend_and_loop_idle_by_hand():
    """The frontend: the 150 ns GEMM over 2 steps. Idle: 150 of the
    window's 10,000 ns before the first kernel, then gaps each ended by a
    layer's launch but two: the copy aten::item launched outside every
    range (200 ns) and the tail after Adam (6,800 ns)."""
    values = _read(TRACED + ['device_idle_pct.train'],
                   _Ctx(_events(program=False)))
    assert values['frontend_ms.train'] == pytest.approx(1e3 * 150e-9 / 2)
    assert values['frontend_ms.render'] == values['frontend_ms.train']
    assert values['loop_idle_pct.train'] == pytest.approx(70.0)
    assert values['viewer_idle_pct.render'] == values['loop_idle_pct.train']
    busy = 150 + 70 + 60 + 50 + 30 + 10 + 150 + 90 + 70 + 150
    assert values['device_idle_pct.train'] == pytest.approx(
        100.0 * (10000 - busy) / 10000)


def test_frontend_and_loop_idle_read_nothing_where_absent():
    no_frontend = [e for e in _events(program=False)
                   if e.name() != 'nerfbench/frontend']
    ctx = _Ctx(no_frontend)
    assert ctx.trace.layer_s('frontend') is None
    assert _read(['frontend_ms.train', 'frontend_ms.render'], ctx) == \
        {'frontend_ms.train': None, 'frontend_ms.render': None}
    host_only = _Ctx([e for e in _events(program=True)
                      if e.device_type() == 'DeviceType.CPU'])
    assert set(_read(TRACED, host_only).values()) == {None}


def test_the_benchmark_lists_the_new_metrics():
    listed = {m['name']: m for m in spec.benchmark()['per_layer']}
    assert set(EXISTING + TRACED + NEW) <= set(listed)
    assert listed['entries_past_k_pct.train']['workloads'] == ['gs360_train']
    assert listed['entries_past_k_pct.render']['workloads'] == \
        ['gs360_render_1080p']
    assert listed['loop_idle_pct.train']['workloads'] == \
        ['gs360_train', 'nerf_train']
    assert all(listed[n]['source'] == 'program_counter' for n in NEW)
    assert {listed[n]['layer'] for n in TRACED} == \
        {'frontend', 'trainer loop and dispatch', 'renderer'}


@pytest.fixture
def fresh_counters():
    tracing.reset_counters()
    yield
    tracing.reset_counters()


@pytest.mark.parametrize('name', NEW)
def test_entries_past_k_reads_the_program_counters(name, fresh_counters):
    reader = spec.metric_module(name)
    with profile():
        for entries, past in ((600, 550), (400, 356)):
            tracing.count('gs/entries', torch.tensor(entries))
            tracing.count('gs/entries_past_k', torch.tensor(past))
    assert reader.read(None) == pytest.approx(90.6)


@pytest.mark.parametrize('name', NEW)
def test_entries_past_k_reads_nothing_without_its_counters(
        name, fresh_counters, monkeypatch):
    reader = spec.metric_module(name)
    assert reader.read(None) is None
    with profile():
        tracing.count('gs/entries', 100)
    assert reader.read(None) is None          # no gs/entries_past_k
    with profile():
        tracing.count('gs/entries_past_k', 7)
    assert reader.read(None) == pytest.approx(7.0)
    # a program with no tracing module (an older checkout)
    monkeypatch.setitem(sys.modules, 'nerficg_torch.core.tracing', None)
    assert reader.read(None) is None


_TINY_RUNS = '''
import json, sys
sys.path.insert(0, 'nerfbench/tests')
import torch
torch.set_num_threads(1)
from tiny import tiny_cell
from nerfbench.run import run_cell
from nerficg_torch.core.tracing import reset_counters
out = {}
for name in ('gs360_train', 'gs360_render_1080p', 'nerf_train'):
    reset_counters()     # a cell's run is a process of its own
    r = run_cell(tiny_cell(name), 3, 0.2, True, device='cpu', start=0.0)
    out[name] = [r['correct'], r['metrics'],
                 r['numbers'].get('truncation', {})]
print(json.dumps(out))
'''


def test_tiny_traced_runs_report_the_program_share():
    """The share past k the program counted over each traced window is
    the reference's over the same frames (the rasterizer and the reference
    cull alike), and within the benchmark's 1 point of it over the same
    steps: the reference counts each step's view with the parameters the
    capture starts with, the program with the ones the step trains. NeRF
    reports no share."""
    run = subprocess.run([sys.executable, '-c', _TINY_RUNS],
                         cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.splitlines()[-1])
    for name, metric, within in (
            ('gs360_train', 'entries_past_k_pct.train', 1.0),
            ('gs360_render_1080p', 'entries_past_k_pct.render', 1e-6)):
        correct, metrics, truncation = out[name]
        assert correct
        assert metrics[metric]['unit'] == '%'
        assert 0.0 < metrics[metric]['value'] < 100.0
        assert metrics[metric]['value'] == pytest.approx(
            100.0 * truncation['entries_past_k'], abs=within)
    correct, metrics, _ = out['nerf_train']
    assert correct and not set(NEW) & set(metrics)


def test_device_operations_take_their_program_span():
    """Forward kernels by the span around their launch, backward kernels
    by their forward node's creator; the copy aten::item launched in the
    step's span alone."""
    parsed = program_spans.by_program_spans(_events(program=True))
    labels = {op.name: op.layer for op in parsed.ops}
    assert labels == {
        'gemm_kernel': 'frontend', 'mm_kernel': 'field',
        'sort_kernel': 'rasterizer', 'gs_fwd_kernel': 'composite',
        'mean_kernel': 'loss', 'memcpy': 'trainer/training_iteration',
        'scatter_kernel': 'rasterizer', 'gs_bwd_kernel': 'composite',
        'mm_bwd_kernel': 'field', 'adam_kernel': 'optimizer'}
    assert parsed.layers_s() == pytest.approx({
        'frontend': 150e-9, 'field': 140e-9, 'rasterizer': 210e-9,
        'composite': 140e-9, 'loss': 30e-9, 'optimizer': 150e-9,
        'trainer/training_iteration': 10e-9})
    plain = trace.from_kineto(_events(program=False))
    assert sum(parsed.layers_s().values()) == pytest.approx(
        sum(plain.layers_s().values()))
    assert parsed.idle_gaps() == plain.idle_gaps()


def test_idle_by_span_sums_to_the_idle_time():
    parsed = program_spans.by_program_spans(_events(program=True))
    idle = reads.idle_by_layer(parsed)
    assert idle == {'frontend': 150, 'field': 150 + 130,
                    'rasterizer': 120 + 490, 'composite': 130 + 110,
                    'loss': 440, 'trainer/training_iteration': 200,
                    'optimizer': 450, '': 6800}
    window = parsed.window[1] - parsed.window[0]
    assert sum(idle.values()) == window - 1e9 * parsed.busy_s()


def test_host_self_time_of_the_program_spans():
    assert program_spans.host_self_ns(_events(program=True)) == {
        'trainer/training_iteration': 3550 - 285 - 90 - 585 - 110 - 490,
        'frontend': 285, 'field': 90, 'rasterizer': 585 - 110,
        'composite': 110, 'loss': 110, 'optimizer': 490}


_TINY_REPORT = '''
import json, sys
sys.path.insert(0, 'nerfbench/tests')
import torch
torch.set_num_threads(1)
from tiny import tiny_cell
from nerfbench.program_spans import span_report
print(json.dumps(span_report(tiny_cell('gs360_train'), 3, 0.2, device='cpu')))
'''


def test_tiny_span_report():
    """On the CPU the trace holds no device operation: the whole window is
    idle and the loop's, and the report still holds the program's spans'
    host time and its counters."""
    run = subprocess.run([sys.executable, '-c', _TINY_REPORT],
                         cwd=spec.ROOT, capture_output=True, text=True,
                         timeout=600)
    assert run.returncode == 0, run.stderr[-3000:]
    out = json.loads(run.stdout.splitlines()[-1])
    assert out['correct'] and out['units'] > 0
    assert {'trainer/training_iteration', 'frontend', 'rasterizer',
            'composite', 'loss', 'optimizer'} <= \
        set(out['host_ms_per_unit_by_span'])
    assert out['device_ms_per_unit'] == 0.0
    assert out['loop_idle_pct'] == pytest.approx(100.0)
    counted = out['counters_per_unit']
    assert set(counted) == {'gs/entries', 'gs/entries_past_k',
                            'gs/gaussians_past_d'}
    assert 0 <= counted['gs/entries_past_k'] < counted['gs/entries']
    assert 'entries_past_k_pct.train' in out['metrics']
