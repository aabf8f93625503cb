#!/usr/bin/env python3
"""Per-frame segmentation masks for the loaders' LOAD_MASKS path.

Port of scripts/cutie.py (reference: scripts/cutie.py:27-223, which drives
the Cutie video-object-segmentation tool). Two backends:
  * ``--backend median`` (the default): a segmenter without dependencies
    for static-camera captures; each pixel's temporal median over the
    frames is the background, a pixel deviating from it by more than
    ``--threshold`` in any channel is foreground, dilated ``--dilate``
    times by one pixel (the image wraps at its borders).
  * ``--backend cutie``: runs an installed Cutie command line, which needs
    its own pretrained weights; refuses when the command is not on PATH.
Masks are single-channel PNGs named like the images, in SCENE/masks.

  python -m nerficg_torch.scripts.cutie -p SCENE [--backend median] \\
      [--image-dir images] [--output-dir masks] [--threshold 0.08]
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np

from nerficg_torch.core.logging import Logger
from nerficg_torch.data.io import load_image, save_image

__all__ = ['median_masks', 'main']

IMAGE_SUFFIXES = ('.png', '.jpg', '.jpeg')


def median_masks(image_dir: Path, out_dir: Path, threshold: float,
                 dilate: int) -> int:
    """Temporal-median background subtraction; returns the masks written."""
    paths = sorted(p for p in image_dir.iterdir()
                   if p.suffix.lower() in IMAGE_SUFFIXES)
    if not paths:
        Logger.error(f'no images found in {image_dir}')
        return 0
    frames = np.stack([load_image(p)[..., :3] for p in
                       Logger.progress(paths, desc='loading frames')])
    background = np.median(frames, axis=0)
    out_dir.mkdir(parents=True, exist_ok=True)
    for path, frame in zip(paths, frames):
        dev = np.abs(frame - background).max(axis=-1)
        mask = (dev > threshold).astype(np.float32)
        for _ in range(max(dilate, 0)):
            grown = mask
            for axis in (0, 1):
                grown = np.maximum(grown, np.roll(mask, 1, axis))
                grown = np.maximum(grown, np.roll(mask, -1, axis))
            mask = grown
        save_image(mask[..., None], out_dir / (path.stem + '.png'))
    return len(paths)


def main(argv: list[str] | None = None) -> int:
    """Returns the number of masks written (the cutie backend exits with
    its command's code)."""
    parser = argparse.ArgumentParser(description='video segmentation masks')
    parser.add_argument('-p', '--path', required=True)
    parser.add_argument('--image-dir', default='images')
    parser.add_argument('--output-dir', default='masks')
    parser.add_argument('--backend', choices=('median', 'cutie'),
                        default='median')
    parser.add_argument('--threshold', type=float, default=0.08,
                        help='median-backend deviation threshold in [0,1]')
    parser.add_argument('--dilate', type=int, default=2)
    parser.add_argument('--cutie-cmd', default='cutie')
    args = parser.parse_args(argv)

    scene = Path(args.path)
    image_dir = scene / args.image_dir
    out_dir = scene / args.output_dir
    if args.backend == 'cutie':
        if shutil.which(args.cutie_cmd) is None:
            Logger.error(
                f'`{args.cutie_cmd}` not found on PATH. Install Cutie '
                '(github.com/hkchengrex/Cutie) or use --backend median.')
            sys.exit(1)
        sys.exit(subprocess.call([args.cutie_cmd, '--video', str(image_dir),
                                  '--output', str(out_dir)]))
    n = median_masks(image_dir, out_dir, args.threshold, args.dilate)
    Logger.info(f'wrote {n} masks to {out_dir}')
    return n


if __name__ == '__main__':
    main()
