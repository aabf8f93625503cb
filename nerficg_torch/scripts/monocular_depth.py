#!/usr/bin/env python3
"""Monocular depth annotation with MiDaS (small) from torch hub.

Port of scripts/monocular_depth.py (reference: scripts/monocular_depth.py:
24-180): each image's relative depth saved as .npy beside a TURBO preview
PNG, into SCENE/depth, the layout of the Colmap loader's LOAD_DEPTH.
Refuses when MiDaS cannot be loaded from torch hub's cache: its
repository (``intel-isl_MiDaS_master``) and its weights
(``checkpoints/midas_v21_small_256.pt``) must be there, since nothing is
downloaded.

  python -m nerficg_torch.scripts.monocular_depth -p SCENE \\
      [--image-dir images] [--output-dir depth] [--device cpu]

The model runs on the first CUDA card and it refuses to start without
one, unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import numpy as np
import torch

from nerficg_torch.core.logging import Logger
from nerficg_torch.core.setup import resolve_device
from nerficg_torch.data.io import load_image, save_image
from nerficg_torch.visual.colormaps import apply_color_map

__all__ = ['load_midas', 'main']

MIDAS_REPO = 'intel-isl_MiDaS_master'
MIDAS_WEIGHTS = 'midas_v21_small_256.pt'


def load_midas():
    """MiDaS_small and its transform from torch hub's cache; raises
    FileNotFoundError when either piece is not there."""
    hub = Path(torch.hub.get_dir())
    repo = hub / MIDAS_REPO
    for needed in (repo / 'hubconf.py', hub / 'checkpoints' / MIDAS_WEIGHTS):
        if not needed.is_file():
            raise FileNotFoundError(f'{needed} is missing')
    model = torch.hub.load(str(repo), 'MiDaS_small', source='local')
    transforms = torch.hub.load(str(repo), 'transforms',
                                source='local').small_transform
    return model.eval(), transforms


def main(argv: list[str] | None = None) -> int:
    """Returns the number of depth maps written."""
    parser = argparse.ArgumentParser(description='monocular depth annotation')
    parser.add_argument('-p', '--path', required=True,
                        help='scene dir with an images/ folder')
    parser.add_argument('--model', choices=['midas'], default='midas')
    parser.add_argument('--image-dir', default='images')
    parser.add_argument('--output-dir', default='depth')
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help='cuda (default: the first card) or cpu')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)
    try:
        model, transform = load_midas()
    except Exception as exc:
        Logger.error(f'could not load MiDaS from the torch hub cache '
                     f'{torch.hub.get_dir()} (this script downloads '
                     f'nothing): {exc}')
        sys.exit(1)
    model = model.to(device)

    scene = Path(args.path)
    out_dir = scene / args.output_dir
    out_dir.mkdir(exist_ok=True)
    written = 0
    for img_path in sorted((scene / args.image_dir).glob('*')):
        if img_path.suffix.lower() not in ('.png', '.jpg', '.jpeg'):
            continue
        img = (load_image(img_path)[..., :3] * 255).astype(np.uint8)
        with torch.no_grad():
            pred = model(transform(img).to(device))
            pred = torch.nn.functional.interpolate(
                pred.unsqueeze(1), size=img.shape[:2], mode='bicubic',
                align_corners=False).squeeze()
        np.save(out_dir / f'{img_path.stem}.npy',
                pred.cpu().numpy().astype(np.float32))
        save_image(apply_color_map(pred.float().cpu(), 'TURBO').numpy(),
                   out_dir / f'{img_path.stem}_viz.png')
        Logger.info(f'{img_path.name}: depth saved')
        written += 1
    return written


if __name__ == '__main__':
    main()
