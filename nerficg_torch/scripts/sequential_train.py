#!/usr/bin/env python3
"""Train several configs one after another, each in a child process, and
summarise their test metrics.

Port of scripts/sequential_train.py (reference: scripts/
sequential_train.py:23-118): one ``python -m nerficg_torch.scripts.train``
process per config, so that each run starts on a clean device; the last
line of each run's ``test/metrics_8bit.txt`` (the newest run directory
under ``output/``) goes into the summary file as ``CONFIG: LINE``.

  python -m nerficg_torch.scripts.sequential_train CFG.yaml [CFG.yaml ...] \\
      [-o output/summary.txt] [--continue-on-error] [--device cpu]
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
from pathlib import Path

from nerficg_torch.core.logging import Logger

__all__ = ['train_command', 'child_env', 'latest_run_dir',
           'parse_metrics_line', 'main']

# The directory that holds the nerficg_torch package.
_PACKAGE_ROOT = Path(__file__).resolve().parents[2]


def train_command(config: str | Path, device: str,
                  overrides=()) -> list[str]:
    return [sys.executable, '-m', 'nerficg_torch.scripts.train', '-c',
            str(config), '--device', device, *overrides]


def child_env() -> dict:
    """This process's environment with the package importable from any
    working directory."""
    env = dict(os.environ)
    env['PYTHONPATH'] = os.pathsep.join(
        [str(_PACKAGE_ROOT)] + [p for p in [env.get('PYTHONPATH')] if p])
    return env


def latest_run_dir(output_root: Path) -> Path | None:
    runs = sorted(output_root.glob('*/*/'), key=lambda p: p.stat().st_mtime)
    return runs[-1] if runs else None


def parse_metrics_line(run_dir: Path) -> str:
    metrics = run_dir / 'test' / 'metrics_8bit.txt'
    if metrics.is_file():
        return metrics.read_text().strip().splitlines()[-1]
    return 'no metrics'


def main(argv: list[str] | None = None) -> list[tuple[str, str]]:
    """Returns the summary's (config, line) pairs."""
    parser = argparse.ArgumentParser(
        description='train multiple configs sequentially')
    parser.add_argument('configs', nargs='+', help='config yaml paths')
    parser.add_argument('-o', '--output', default='output/summary.txt')
    parser.add_argument('--continue-on-error', action='store_true')
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help='cuda (default: the first card) or cpu')
    args = parser.parse_args(argv)

    results: list[tuple[str, str]] = []
    for config in args.configs:
        Logger.info(f'=== training {config} ===')
        proc = subprocess.run(train_command(config, args.device),
                              env=child_env())
        if proc.returncode != 0:
            results.append((config, f'FAILED (exit {proc.returncode})'))
            if not args.continue_on_error:
                break
            continue
        run_dir = latest_run_dir(Path('output'))
        results.append((config,
                        parse_metrics_line(run_dir) if run_dir else 'unknown'))

    summary_path = Path(args.output)
    summary_path.parent.mkdir(parents=True, exist_ok=True)
    with open(summary_path, 'w') as f:
        for config, line in results:
            f.write(f'{config}: {line}\n')
            Logger.info(f'{config}: {line}')
    Logger.info(f'summary written to {summary_path}')
    return results


if __name__ == '__main__':
    main()
