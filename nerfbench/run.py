"""Run one cell of the benchmark once and print its result line.

    python3 -m nerfbench.run --workload NAME --seed N --seconds S --trace 0|1

From the root of a checkout. Set-up (imports, the inputs and the program's
objects made on the card from the seed, the warm-up) is timed as
``setup_s``; the window then runs for ``--seconds``; with ``--trace 1``
under ``torch.profiler``, whose trace the per-layer metrics read. After
the window the program's state is freed and the plain reference judges
what the window's path produced. The last line of standard output is one
JSON object; the numbers compared and their limits are also the last lines
of standard error. Without a card, or with fewer cards than the cell asks
for, it prints no result and exits with 2; where a module of JAX or the
JAX package is loaded once the window has closed (checked after the
window and again before the result is printed), it prints no result and
exits with another code than 0.
"""

from __future__ import annotations

import time

_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

__all__ = ['main', 'run_cell', 'emit', 'FORBIDDEN']

FORBIDDEN = ('jax', 'jaxlib', 'flax', 'nerficg_tpu')
_CACHE = Path(__file__).resolve().parent / '.cache'


def _cache_dirs() -> None:
    """Kernel and build caches at fixed paths inside the checkout (the
    program's own CUDA library builds into ``build/`` beside it)."""
    for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions'),
                     ('TORCHINDUCTOR_CACHE_DIR', 'inductor')):
        os.environ[var] = str(_CACHE / sub)


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split('.')[0] for m in sys.modules} & set(FORBIDDEN))


def _card() -> dict:
    import torch
    out = {'name': torch.cuda.get_device_name(0)}
    try:
        line = subprocess.run(
            ['nvidia-smi', '--query-gpu=power.limit',
             '--format=csv,noheader,nounits'], capture_output=True,
            text=True, timeout=30).stdout.strip().splitlines()
        out['power_limit_w'] = float(line[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        out['power_limit_w'] = None
    return out


class Context:
    """What a per-layer metric reads: the trace, the window's steps or
    frames (``units``), their work by the reference's geometry (each a
    dict with its ``flops`` among the counts), and the peak the
    configuration states."""

    def __init__(self, cell, trace, units, work_fn):
        from nerfbench import roofline
        self.trace, self.units = trace, units
        self._work_fn, self._work = work_fn, None
        self.peak_flops = roofline.PEAKS[cell.config['flops_peak']]

    def work(self) -> list[dict]:
        if self._work is None:
            self._work = self._work_fn()
        return self._work


def run_cell(cell, seed: int, seconds: float, trace: bool, device='cuda',
             start: float | None = None) -> dict:
    """One run of ``cell`` (a ``spec.Cell`` or a workload's name): the
    result object, not printed."""
    import torch

    from nerfbench import check, spans
    from nerfbench import trace as tracing
    from nerfbench.spec import Cell, metric_module

    start = _START if start is None else start
    cell = Cell(cell) if isinstance(cell, str) else cell
    cfg, traffic = cell.config, cell.traffic
    on_card = torch.device(device).type == 'cuda'
    entry = getattr(cell.driver, traffic['entry'].capitalize())
    run = entry(cell.method, cfg, traffic, seed, device)
    if on_card:
        torch.cuda.synchronize(device)
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - start

    restore = spans.install(cfg['method']) if trace else None
    try:
        if trace:
            window, events = tracing.capture(lambda: run.window(seconds))
        else:
            window = run.window(seconds)
    finally:
        if restore is not None:
            restore()
    metrics = dict(window['metrics'])
    peak = 0
    if on_card:
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
        metrics['peak_mem_gib'] = peak / 2 ** 30
        peak = max(peak, setup_peak)
    metrics['setup_s'] = setup_s
    leaked = forbidden_modules()
    if leaked:
        raise RuntimeError(f'modules of JAX or the JAX package were loaded: '
                           f'{leaked}')

    records = run.records()
    run.close()
    del run
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    numbers = check.compare(cell, seed, records, device)
    correct, shown = check.judge(numbers, cell.limits)

    result = {'correct': bool(correct), 'attempted': len(window['units']),
              'failed': 0 if correct else len(window['units'])}
    units = {m['name']: m['unit'] for m in cell.end_to_end + cell.per_layer}
    breakdown = None
    if trace:
        parsed = tracing.from_kineto(events)
        del events
        ctx = Context(cell, parsed, window['units'], lambda: _work(
            cell, seed, records, window['units'], device))
        values = {}
        for m in cell.per_layer:
            value = metric_module(m['name'], cell.here).read(ctx)
            if value is not None:
                values[m['name']] = value
        breakdown = {'device_ops': parsed.top_ops(10),
                     'idle_gaps': parsed.idle_gaps(10)}
        truncation = _truncation(ctx.work())
        layer_ms = {k or 'outside every range': 1e3 * v / len(window['units'])
                    for k, v in parsed.layers_s().items()}
        busy, window_s = parsed.busy_s(), parsed.window_s
    else:
        values = {m['name']: metrics[m['name']] for m in cell.end_to_end
                  if m['name'] in metrics}
    result['metrics'] = {k: {'value': v, 'unit': units[k]}
                         for k, v in values.items()}
    result['device'] = {'platform': 'gpu' if on_card else 'cpu',
                        'count': cell.chips, 'memory_peak_bytes': int(peak)}
    if on_card:
        card = _card()
        result['device'].update(kind=card['name'],
                                power_limit_w=card['power_limit_w'])
    if trace:
        result['device'].update(busy_s=busy, window_s=window_s)
        result['breakdown'] = breakdown
    result['numbers'] = _as_text_where_not_finite(
        {k: v for k, v in numbers.items() if k not in shown})
    if trace:
        result['numbers']['device_ms_per_unit_by_layer'] = layer_ms
        if truncation:
            result['numbers']['truncation'] = truncation
    result['check'] = shown
    return result


def _as_text_where_not_finite(value):
    """``value`` with every float that is not finite as text (JSON has no
    inf or nan)."""
    if isinstance(value, dict):
        return {k: _as_text_where_not_finite(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_as_text_where_not_finite(v) for v in value]
    if isinstance(value, float) and not math.isfinite(value):
        return str(value)
    return value


def _truncation(work: list[dict]) -> dict:
    """The rasterizer's truncation over the window's frames or steps, by
    the reference's geometry: the share of visible entries past a tile's
    budget k, and of Gaussians whose rect spans more than D tiles."""
    if not work or 'overflow_entries' not in work[0]:
        return {}
    return {'entries_past_k': sum(w['overflow_entries'] for w in work) /
            max(sum(w['valid_entries'] for w in work), 1),
            'gaussians_past_d': sum(w['overflow_gaussians'] for w in work) /
            max(sum(w['gaussians'] for w in work), 1),
            'entries_per_frame': sum(w['valid_entries'] for w in work) /
            len(work)}


def _work(cell, seed, records, units, device) -> list[dict]:
    import torch
    method = cell.method
    if cell.traffic['entry'] == 'render':
        return method.render_work(cell.config, cell.traffic, seed, units,
                                  device)
    work = method.train_work(cell.config, cell.traffic, seed, records,
                             units, device)
    if torch.device(device).type == 'cuda':
        torch.cuda.empty_cache()
    return work


def cuda_cards() -> int:
    import torch
    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument('--workload', required=True)
    parser.add_argument('--seed', type=int, required=True)
    parser.add_argument('--seconds', type=float, required=True)
    parser.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    _cache_dirs()
    from nerfbench.spec import Cell
    chips, cards = Cell(args.workload).chips, cuda_cards()
    if cards < chips:
        print(f'nerfbench: the cell needs {chips} CUDA card(s); {cards} '
              f'available', file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace))
    return emit(result)


def emit(result: dict) -> int:
    """Print a run's result: the numbers compared beside their limits as
    the last lines of standard error, then the result's line. Where a
    module of JAX or the JAX package is loaded by then (the reference, a
    metric's reader), no result is printed and the exit code is 3."""
    leaked = forbidden_modules()
    if leaked:
        print(f'nerfbench: modules of JAX or the JAX package were loaded '
              f'after the window: {leaked}; no result', file=sys.stderr)
        return 3
    for name, entry in result['check'].items():
        print(f'check {name}: {entry["value"]!r} limit {entry["limit"]!r}',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
