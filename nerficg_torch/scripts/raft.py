#!/usr/bin/env python3
"""Optical-flow annotation with RAFT for dynamic-scene datasets.

Port of scripts/raft.py (reference: scripts/raft.py:20-119): torchvision's
RAFT (small) between consecutive frames, forward and backward, written as
Middlebury .flo files beside a colour visualisation, into SCENE/flow.
Refuses when torchvision is missing or its RAFT weights are not in torch
hub's checkpoint cache (nothing is downloaded).

  python -m nerficg_torch.scripts.raft -p SCENE [--image-dir images] \\
      [--output-dir flow] [--device cpu]

The model runs on the first CUDA card and it refuses to start without
one, unless ``--device cpu`` asks for the CPU.
"""

from __future__ import annotations

import argparse
import sys
from pathlib import Path

import torch

from nerficg_torch.core.logging import Logger
from nerficg_torch.core.setup import resolve_device
from nerficg_torch.data.io import (flow_to_color, load_image, save_image,
                                  write_flow)

__all__ = ['cached_weights', 'main']


def cached_weights(url: str) -> Path:
    """Where torch hub keeps the checkpoint downloaded from ``url``."""
    return Path(torch.hub.get_dir()) / 'checkpoints' / url.rsplit('/', 1)[-1]


def main(argv: list[str] | None = None) -> int:
    """Returns the number of flow fields written."""
    parser = argparse.ArgumentParser(description='RAFT optical-flow '
                                                 'annotation')
    parser.add_argument('-p', '--path', required=True)
    parser.add_argument('--image-dir', default='images')
    parser.add_argument('--output-dir', default='flow')
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help='cuda (default: the first card) or cpu')
    args = parser.parse_args(argv)
    device = resolve_device(args.device)

    try:
        from torchvision.models.optical_flow import (Raft_Small_Weights,
                                                     raft_small)
    except ImportError:
        Logger.error('torchvision (with RAFT weights) is required for flow '
                     'annotation; it is not installed in this environment')
        sys.exit(1)
    weights = Raft_Small_Weights.DEFAULT
    if not cached_weights(weights.url).is_file():
        Logger.error(f'RAFT weights not found at '
                     f'{cached_weights(weights.url)}; copy them there from '
                     f'{weights.url} (this script downloads nothing)')
        sys.exit(1)
    model = raft_small(weights=weights).eval().to(device)
    transform = weights.transforms()

    scene = Path(args.path)
    out_dir = scene / args.output_dir
    out_dir.mkdir(exist_ok=True)
    images = sorted(p for p in (scene / args.image_dir).glob('*')
                    if p.suffix.lower() in ('.png', '.jpg', '.jpeg'))

    def to_tensor(path):
        img = load_image(path)[..., :3]
        return torch.from_numpy(img).permute(2, 0, 1)[None].to(device)

    pairs = [(i, i + 1, 'fwd') for i in range(len(images) - 1)] + \
            [(i, i - 1, 'bwd') for i in range(1, len(images))]
    for a, b, tag in pairs:
        t1, t2 = transform(to_tensor(images[a]), to_tensor(images[b]))
        with torch.no_grad():
            flow = model(t1, t2)[-1][0].permute(1, 2, 0).cpu().numpy()
        stem = images[a].stem
        write_flow(flow, out_dir / f'{stem}_{tag}.flo')
        save_image(flow_to_color(flow), out_dir / f'{stem}_{tag}.png')
        Logger.info(f'{stem} {tag} flow saved')
    return len(pairs)


if __name__ == '__main__':
    main()
