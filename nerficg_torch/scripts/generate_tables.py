#!/usr/bin/env python3
"""Metric tables over rendered image trees laid out as root/scene/method.

Port of scripts/generate_tables.py (reference: scripts/generate_tables.py:
1-219): for each scene directory holding a ground-truth directory, each
other directory is a method whose images are scored against the
ground-truth images of the same name (PSNR, SSIM, LPIPS; with -m, also
mPSNR, mSSIM and mLPIPS under the scene's mask images), averaged per
method, logged one row each and written with -o as text and a LaTeX
tabular. (The JAX script's -o stops with a TypeError after the rows: its
'% LaTeX' line is a %-format directive there. The port writes the
tabular.)

  python -m nerficg_torch.scripts.generate_tables -r ROOT [-g gt] \\
      [-m MASK_DIR_NAME] [-o tables.txt] [--device cpu]

The metrics run on the first CUDA card and it refuses to start without
one, unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import torch

from nerficg_torch.core.logging import Logger
from nerficg_torch.core.setup import resolve_device
from nerficg_torch.data.io import load_image
from nerficg_torch.optim.masked_metrics import compute_masked_metrics
from nerficg_torch.optim.metrics import compute_all_metrics

__all__ = ['evaluate_dir', 'collect_rows', 'main']


def evaluate_dir(pred_dir: Path, gt_dir: Path, mask_dir: Path | None = None,
                 device: torch.device | str = 'cpu') -> dict[str, float]:
    """The mean of each metric over ``pred_dir``'s images that have a
    ground-truth image of the same name (NaN entries skipped)."""
    preds = sorted(pred_dir.glob('*.png')) + sorted(pred_dir.glob('*.jpg'))
    per_image = []
    for pred_path in preds:
        gt_path = gt_dir / pred_path.name
        if not gt_path.is_file():
            continue
        pred = load_image(pred_path)[..., :3]
        gt = load_image(gt_path)[..., :3]
        metrics = compute_all_metrics(pred, gt, device=device)
        if mask_dir is not None:
            mask_path = mask_dir / pred_path.name
            if mask_path.is_file():
                mask = load_image(mask_path)[..., 0]
                metrics.update(compute_masked_metrics(pred, gt, mask,
                                                      device=device))
        per_image.append(metrics)
    if not per_image:
        return {}
    return {k: float(np.nanmean([m[k] for m in per_image]))
            for k in per_image[0]}


def collect_rows(root: Path, gt_name: str = 'gt',
                 mask_name: str | None = None,
                 device: torch.device | str = 'cpu') -> list[tuple]:
    """(scene, method, metrics) for every method directory of every scene
    that has a ``gt_name`` directory, in name order."""
    rows = []
    for scene_dir in sorted(p for p in root.iterdir() if p.is_dir()):
        gt_dir = scene_dir / gt_name
        if not gt_dir.is_dir():
            continue
        mask_dir = scene_dir / mask_name if mask_name else None
        for method_dir in sorted(p for p in scene_dir.iterdir()
                                 if p.is_dir() and p.name != gt_name
                                 and (mask_dir is None or p != mask_dir)):
            metrics = evaluate_dir(method_dir, gt_dir, mask_dir, device)
            if metrics:
                rows.append((scene_dir.name, method_dir.name, metrics))
    return rows


def main(argv: list[str] | None = None) -> list[tuple]:
    """Returns the rows: (scene, method, {metric: mean})."""
    parser = argparse.ArgumentParser(
        description='offline metric tables over root/scene/method image trees')
    parser.add_argument('-r', '--root', required=True)
    parser.add_argument('-g', '--gt-name', default='gt',
                        help='name of the GT directory inside each scene')
    parser.add_argument('-m', '--mask-name', default=None)
    parser.add_argument('-o', '--output', default=None)
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help='cuda (default: the first card) or cpu')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    rows = collect_rows(Path(args.root), args.gt_name, args.mask_name, device)
    lines = [f'{scene:20s} {method:20s} ' +
             ' '.join(f'{k}={v:.4f}' for k, v in metrics.items())
             for scene, method, metrics in rows]
    for line in lines:
        Logger.info(line)
    if args.output:
        out = Path(args.output)
        out.parent.mkdir(parents=True, exist_ok=True)
        columns = 'c' * (len(rows[0][2]) if rows else 0)
        with open(out, 'w') as f:
            f.write('\n'.join(lines) + '\n')
            f.write(f'\n% LaTeX\n\\begin{{tabular}}{{ll{columns}}}\n')
            for scene, method, metrics in rows:
                f.write(f'{scene} & {method} & ' +
                        ' & '.join(f'{v:.3f}' for v in metrics.values()) +
                        ' \\\\\n')
            f.write('\\end{tabular}\n')
        Logger.info(f'wrote {out}')
    return rows


if __name__ == '__main__':
    main()
