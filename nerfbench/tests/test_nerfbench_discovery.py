"""The harness finds configurations, traffic mixes, limits and per-layer
metrics by name, and BENCHMARK.json keeps to the benchmark's contract."""

import hashlib
import json
import re
import shutil
from pathlib import Path

import pytest

from nerfbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
CELLS = [w['name'] for w in BENCH['workloads']]


def _digest(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes())
            .hexdigest() for p in sorted(root.rglob('*')) if p.is_file()}


@pytest.mark.parametrize('name', CELLS)
def test_every_cell_resolves(name):
    cell = spec.Cell(name)
    assert cell.config['method'] and cell.traffic['entry']
    assert cell.limits, 'a cell without limits could never be correct'
    assert hasattr(cell.driver, cell.traffic['entry'].capitalize())
    assert cell.method.__name__.endswith(cell.config['method'])
    names = [m['name'] for m in cell.end_to_end]
    assert 'setup_s' in names and len(names) >= 2
    assert cell.per_layer
    for metric in cell.per_layer:
        assert metric['moves'] in names
        assert callable(spec.metric_module(metric['name']).read)


@pytest.mark.parametrize('entry', BENCH['per_layer'],
                         ids=[m['name'] for m in BENCH['per_layer']])
def test_metric_module_agrees_with_benchmark(entry):
    module = spec.metric_module(entry['name'])
    assert module.LAYER == entry['layer']
    assert module.UNIT == entry['unit']
    assert module.MOVES == entry['moves']
    assert module.SOURCE == entry['source']
    assert module.BETTER == entry['better']
    assert sorted(module.WORKLOADS) == sorted(entry['workloads'])


def test_benchmark_keeps_to_the_contract():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert 1 <= BENCH['run_seconds'] <= 51
    assert all(not w.startswith('/') and '..' not in w
               for w in BENCH['command'])
    names = [x['name'] for key in ('configs', 'workloads', 'end_to_end',
                                   'per_layer') for x in BENCH[key]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in BENCH['configs']:
        assert set(c) == {'name', 'source', 'file', 'reduced', 'why'}
        assert c['file'].startswith(BENCH['paths'][0] + '/')
        assert json.loads((spec.ROOT / c['file']).read_text())['reduced'] \
            == c['reduced']
        assert all(NAME.match(k) and not k.endswith(('_dim', '_rank'))
                   and 'WIDTH' not in k for k in c['reduced'])
    used = {w['config'] for w in BENCH['workloads']}
    assert used == {c['name'] for c in BENCH['configs']}
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))
    for w in BENCH['workloads']:
        assert set(w) == {'name', 'config', 'traffic', 'chips', 'why'}
        assert w['chips'] == 1 and len(w['why']) <= 200
    for m in BENCH['end_to_end']:
        assert set(m) - {'workloads'} == {'name', 'unit', 'better', 'bound',
                                          'source'}
        assert m['source'] in ('host_clock', 'device_trace')
        assert 0.01 <= m['bound'] <= 0.25 and UNIT.match(m['unit'])
    assert any(m['name'] == 'setup_s' for m in BENCH['end_to_end'])
    layers = {}
    for m in BENCH['per_layer']:
        assert set(m) == {'name', 'unit', 'better', 'source', 'layer',
                          'moves', 'workloads'}
        assert UNIT.match(m['unit']) and '\n' not in m['layer']
        layers.setdefault(m['name'].split('.')[0], set()).add(m['layer'])
        if 'roofline' in m['name'] or 'mfu' in m['name']:
            assert m['unit'] == '%'
    assert all(len(v) == 1 for v in layers.values())
    assert len(json.dumps(BENCH).encode()) <= 64 * 1024


def test_added_files_are_found_and_no_file_is_edited(tmp_path):
    """A new configuration, traffic mix, limits and per-layer metric are
    new files and new entries; the harness finds each by name."""
    here = tmp_path / 'nerfbench'
    for sub in ('configs', 'traffic', 'limits', 'metrics'):
        shutil.copytree(spec.HERE / sub, here / sub)
    bench = json.loads(json.dumps(BENCH))
    before = _digest(here)
    repo_before = _digest(spec.HERE / 'metrics')
    config = json.loads((spec.ROOT / BENCH['configs'][0]['file'])
                        .read_text())
    config['scene']['count'] = 65536
    (here / 'configs' / 'gs_small.json').write_text(json.dumps(config))
    (here / 'traffic' / 'steady_late.json').write_text(json.dumps(
        {'entry': 'train', 'start_iteration': 20000, 'warmup_steps': 5}))
    (here / 'limits' / 'gs_small.late.json').write_text(json.dumps(
        {'limits': {'loss_rel_gap': 1.0}}))
    (here / 'metrics' / 'step_count.train.py').write_text(
        "LAYER = 'trainer loop and dispatch'\nUNIT = 'steps'\n"
        "def read(ctx):\n    return float(len(ctx.units))\n")
    bench['configs'].append({'name': 'gs_small', 'source': 'x',
                             'file': 'nerfbench/configs/gs_small.json',
                             'reduced': [], 'why': 'x'})
    bench['workloads'].append({'name': 'gs_small.late', 'config': 'gs_small',
                               'traffic': 'steady_late', 'chips': 1,
                               'why': 'x'})
    bench['per_layer'].append({'name': 'step_count.train', 'unit': 'steps',
                               'better': 'higher', 'source': 'host_clock',
                               'layer': 'trainer loop and dispatch',
                               'moves': 'train_it_per_s',
                               'workloads': ['gs_small.late']})
    bench['end_to_end'][0]['workloads'].append('gs_small.late')
    cell = spec.Cell('gs_small.late', bench, root=tmp_path, here=here)
    assert cell.config['scene']['count'] == 65536
    assert cell.traffic['start_iteration'] == 20000
    assert cell.limits == {'loss_rel_gap': 1.0}
    assert [m['name'] for m in cell.per_layer] == ['step_count.train']
    reader = spec.metric_module('step_count.train', here)

    class Ctx:
        units = [0, 1, 2]
    assert reader.read(Ctx()) == 3.0
    after = _digest(here)
    assert all(after[k] == v for k, v in before.items())
    assert _digest(spec.HERE / 'metrics') == repo_before
