#!/usr/bin/env python3
"""Render subsets and camera trajectories from a trained output dir;
metrics; FPS benchmark.

Port of scripts/inference.py (reference: scripts/inference.py:20-103):
render the named subsets (with -m, 8-bit PSNR/SSIM against the ground
truth) and camera trajectories (120 frames each, ``visual/trajectories``),
each into RUN_DIR/<name>/, and with -b run the online FPS benchmark (a
warm-up render, then repeated test-set renders timed to the last device
sync) into ``performance_<iters>.txt``.

  python -m nerficg_torch.scripts.inference -d RUN_DIR -s test ellipse_path \
      -m -b --repeats N [--device cpu]

It runs on the first CUDA card and refuses to start without one, unless
``--device cpu`` asks for the CPU (the kernels' plain versions).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

import torch

from nerficg_torch.core.logging import Logger
from nerficg_torch.core.registry import Datasets, Methods
from nerficg_torch.core.setup import setup, teardown
from nerficg_torch.visual.trajectories import CameraTrajectory

__all__ = ['benchmark_fps', 'main']


def _sync(device: torch.device) -> None:
    if device.type == 'cuda':
        torch.cuda.synchronize(device)


def benchmark_fps(renderer, dataset, subset: str = 'test', repeats: int = 100,
                  output_dir: Path | None = None, iterations: int = 0) -> float:
    """Online FPS benchmark (reference: inference.py:62-97)."""
    views = dataset.subsets[subset] or dataset.subsets['train']
    device = renderer.model.device
    renderer.render_image(views[0])          # warm-up
    _sync(device)
    start = time.perf_counter()
    count = 0
    for _ in range(repeats):
        for view in views:
            renderer.render_image(view)
            count += 1
    _sync(device)
    elapsed = time.perf_counter() - start
    fps = count / elapsed
    Logger.info(f'benchmark: {count} renders in {elapsed:.2f}s -> {fps:.2f} FPS')
    if output_dir is not None:
        with open(output_dir / f'performance_{iterations}.txt', 'w') as f:
            f.write(f'{count} renders in {elapsed:.4f}s\nFPS: {fps:.4f}\n')
    return fps


def main(argv: list[str] | None = None) -> dict:
    """Returns {'metrics': {subset: {...}}, 'fps': float or None}; a
    trajectory's entry is empty (no ground truth)."""
    parser = argparse.ArgumentParser(description='render from a trained model')
    parser.add_argument('-d', '--run-dir', required=True,
                        help='training output dir (contains training_config.yaml)')
    parser.add_argument('-s', '--subsets', nargs='*', default=['test'],
                        help='subsets (train, test, val) and/or camera '
                             'trajectories to render: ' +
                             ', '.join(CameraTrajectory.list_options()))
    parser.add_argument('-m', '--metrics', action='store_true')
    parser.add_argument('-b', '--benchmark', action='store_true')
    parser.add_argument('--repeats', type=int, default=100)
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help='cuda (default: the first card) or cpu')
    parser.add_argument('overrides', nargs='*', default=[])
    args = parser.parse_args(argv)

    run_dir = Path(args.run_dir)
    ctx = setup(run_dir / 'training_config.yaml', args.overrides,
                device=args.device)
    dataset = Datasets.get_dataset(ctx.config)
    ckpt = run_dir / 'checkpoints' / 'final.ckpt'
    model = Methods.get_model(ctx.config, checkpoint=str(ckpt),
                              device=ctx.device)
    renderer = Methods.get_renderer(ctx.config, model)

    result: dict = {'metrics': {}, 'fps': None}
    for name in args.subsets:
        if name not in dataset.subsets and \
                name in CameraTrajectory.list_options():
            CameraTrajectory.get(name).add_to_dataset(dataset)
        if name in dataset.subsets:
            result['metrics'][name] = renderer.render_subset(
                dataset, name, output_dir=run_dir / name,
                compute_metrics=args.metrics)
        else:
            Logger.warning(f'unknown subset/trajectory {name!r}; skipped')
    if args.benchmark:
        result['fps'] = benchmark_fps(renderer, dataset, repeats=args.repeats,
                                      output_dir=run_dir,
                                      iterations=model.num_iterations_trained)
    teardown(ctx)
    return result


if __name__ == '__main__':
    main()
