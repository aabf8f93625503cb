"""Where the harness finds everything by name.

``BENCHMARK.json`` (at the checkout's root) names the cells, their
configuration and traffic, and the metrics. A configuration is the file it
names; a traffic mix is ``nerfbench/traffic/<traffic>.json``; a cell's
limits for ``correct`` are ``nerfbench/limits/<cell>.json``; a per-layer
metric is ``nerfbench/metrics/<metric>.py``; a method's adapter is
``nerfbench/methods/<method>.py`` and an entry's driver
``nerfbench/drivers/<entry>.py``. Adding a cell or a metric adds files and
entries; it edits no file.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path

__all__ = ['ROOT', 'HERE', 'Cell', 'benchmark', 'metric_module']

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def benchmark(root: Path = ROOT) -> dict:
    return json.loads((root / 'BENCHMARK.json').read_text())


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def metric_module(name: str, here: Path = HERE):
    """The reader of one per-layer metric, loaded from its file."""
    path = here / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f'nerfbench.metrics.{name.replace(".", "_")}', path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One workload of BENCHMARK.json with everything it names."""

    def __init__(self, name: str, bench: dict | None = None,
                 root: Path = ROOT, here: Path = HERE):
        bench = benchmark(root) if bench is None else bench
        entries = {w['name']: w for w in bench['workloads']}
        if name not in entries:
            raise KeyError(f'no workload {name!r} in BENCHMARK.json '
                           f'(have {sorted(entries)})')
        self.name = name
        self.here = here
        self.entry = entries[name]
        self.chips = int(self.entry['chips'])
        configs = {c['name']: c for c in bench['configs']}
        self.config = _json(root / configs[self.entry['config']]['file'])
        self.traffic = _json(here / 'traffic' / f'{self.entry["traffic"]}.json')
        limits = here / 'limits' / f'{name}.json'
        self.limits = _json(limits)['limits'] if limits.is_file() else {}
        self.end_to_end = [m for m in bench['end_to_end']
                           if name in m.get('workloads', [name])]
        reported = {m['name'] for m in self.end_to_end}
        self.per_layer = [m for m in bench['per_layer']
                          if (name in m['workloads'] if 'workloads' in m
                              else m['moves'] in reported)]

    @property
    def method(self):
        return importlib.import_module(
            f'nerfbench.methods.{self.config["method"]}')

    @property
    def driver(self):
        return importlib.import_module(
            f'nerfbench.drivers.{self.traffic["entry"]}')
