#!/usr/bin/env python3
"""Dataset sweep: train one method on every scene of a dataset, each in a
child process, and tabulate the runs' metrics, time and memory.

Port of scripts/benchmark.py (reference: scripts/benchmark.py:68-239).
Not the speed benchmark: this trains and scores scenes. For each scene
directory under -p, a config from the method's and the dataset's defaults
(``create_config.build_config``, run name = the scene, the scene's
``SCENE_OVERRIDES``) is written to OUTPUT/<scene>.yaml and trained with
``python -m nerficg_torch.scripts.train``; the newest ``output/*/<scene>_*``
run's ``test/metrics_8bit.txt`` (last line), ``timings.txt`` (its
``total:``) and ``vram_stats.txt`` (first line) go into OUTPUT/summary.txt
and OUTPUT/latex_tables.txt.

  python -m nerficg_torch.scripts.benchmark_sweep -m InstantNGP -d NeRF \\
      -p DATASET_ROOT [-o output/benchmark] [--scenes A B] [--device cpu] \\
      [KEY.SUBKEY=value ...]
"""

from __future__ import annotations

import argparse
import subprocess
from pathlib import Path

from nerficg_torch.core.config import save_config
from nerficg_torch.core.logging import Logger
from nerficg_torch.scripts.create_config import build_config
from nerficg_torch.scripts.sequential_train import child_env, train_command

__all__ = ['SCENE_OVERRIDES', 'parse_run_files', 'main']

# Per-scene settings (reference: benchmark.py:36-50): Mip-NeRF 360's
# outdoor scenes at images_4, its indoor ones at images_2.
SCENE_OVERRIDES = {
    'MipNeRF360': {
        **{scene: {'DATASET.DOWNSAMPLE': 4} for scene in
           ('bicycle', 'garden', 'stump', 'flowers', 'treehill')},
        **{scene: {'DATASET.DOWNSAMPLE': 2} for scene in
           ('room', 'counter', 'kitchen', 'bonsai')},
    },
}


def parse_run_files(run_dir: Path) -> dict:
    out = {'metrics': 'n/a', 'time': 'n/a', 'memory': 'n/a'}
    metrics = run_dir / 'test' / 'metrics_8bit.txt'
    if metrics.is_file():
        out['metrics'] = metrics.read_text().strip().splitlines()[-1]
    timings = run_dir / 'timings.txt'
    if timings.is_file():
        for line in timings.read_text().splitlines():
            if line.startswith('total:'):
                out['time'] = line.split(':', 1)[1].strip()
    mem = run_dir / 'vram_stats.txt'
    if mem.is_file():
        out['memory'] = mem.read_text().strip().splitlines()[0]
    return out


def main(argv: list[str] | None = None) -> list[tuple[str, dict]]:
    """Returns the rows: (scene, {'metrics', 'time', 'memory'})."""
    parser = argparse.ArgumentParser(description='benchmark a dataset sweep')
    parser.add_argument('-m', '--method', required=True)
    parser.add_argument('-d', '--dataset', required=True)
    parser.add_argument('-p', '--path', required=True,
                        help='root dir containing one subdir per scene')
    parser.add_argument('-o', '--output', default='output/benchmark')
    parser.add_argument('--scenes', nargs='*', default=None)
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help='cuda (default: the first card) or cpu')
    parser.add_argument('overrides', nargs='*', default=[])
    args = parser.parse_args(argv)

    root = Path(args.path)
    scenes = (args.scenes if args.scenes else
              sorted(p.name for p in root.iterdir() if p.is_dir()))
    out_root = Path(args.output)
    out_root.mkdir(parents=True, exist_ok=True)

    rows = []
    for scene in scenes:
        config = build_config(args.method, args.dataset, str(root / scene))
        config.TRAINING.MODEL_NAME = scene
        for key, value in SCENE_OVERRIDES.get(args.dataset, {}).get(
                scene, {}).items():
            config.set_path(key, value)
        cfg_path = out_root / f'{scene}.yaml'
        save_config(config, cfg_path)
        Logger.info(f'=== {args.method} / {scene} ===')
        proc = subprocess.run(
            train_command(cfg_path, args.device, args.overrides),
            env=child_env())
        if proc.returncode != 0:
            rows.append((scene, {'metrics': f'FAILED ({proc.returncode})',
                                 'time': '-', 'memory': '-'}))
            continue
        runs = sorted(Path('output').glob(f'*/{scene}_*/'),
                      key=lambda p: p.stat().st_mtime)
        rows.append((scene, parse_run_files(runs[-1]) if runs
                     else {'metrics': 'missing', 'time': '-', 'memory': '-'}))

    summary = out_root / 'summary.txt'
    latex = out_root / 'latex_tables.txt'
    with open(summary, 'w') as f, open(latex, 'w') as g:
        g.write('\\begin{tabular}{lccc}\nscene & metrics & time & memory \\\\\n')
        for scene, info in rows:
            line = (f'{scene}: {info["metrics"]} | time {info["time"]} | '
                    f'{info["memory"]}')
            f.write(line + '\n')
            Logger.info(line)
            g.write(f'{scene} & {info["metrics"]} & {info["time"]} & '
                    f'{info["memory"]} \\\\\n')
        g.write('\\end{tabular}\n')
    Logger.info(f'summary: {summary}')
    return rows


if __name__ == '__main__':
    main()
