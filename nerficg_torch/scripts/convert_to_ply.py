#!/usr/bin/env python3
"""Export a trained model's point representation to PLY.

Port of scripts/convert_to_ply.py (reference: scripts/convert_to_ply.py:
18-44): the final checkpoint's ``get_ply_dict()`` through the port's PLY
writer, binary little-endian float32, the JAX package's bytes.

  python -m nerficg_torch.scripts.convert_to_ply -d RUN_DIR [-o out.ply] \\
      [--checkpoint final.ckpt] [--device cpu]

The model loads on the first CUDA card unless ``--device cpu`` asks for
the CPU.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from nerficg_torch.core.errors import ModelError
from nerficg_torch.core.logging import Logger
from nerficg_torch.core.registry import Methods
from nerficg_torch.core.setup import setup, teardown
from nerficg_torch.data.ply import write_ply_vertices

__all__ = ['main']


def main(argv: list[str] | None = None) -> Path:
    """Returns the path of the PLY written."""
    parser = argparse.ArgumentParser(description='export model to .ply')
    parser.add_argument('-d', '--run-dir', required=True)
    parser.add_argument('-o', '--output', default=None,
                        help='default: RUN_DIR/export.ply')
    parser.add_argument('--checkpoint', default='final.ckpt')
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help='cuda (default: the first card) or cpu')
    args = parser.parse_args(argv)

    run_dir = Path(args.run_dir)
    ctx = setup(run_dir / 'training_config.yaml', device=args.device)
    model = Methods.get_model(
        ctx.config, checkpoint=str(run_dir / 'checkpoints' / args.checkpoint),
        device=ctx.device)
    ply = model.get_ply_dict()
    if not ply:
        raise ModelError(f'{type(model).__name__} does not support PLY '
                         'export')
    output = Path(args.output) if args.output else run_dir / 'export.ply'
    write_ply_vertices(ply, output)
    Logger.info(f'wrote {output} ({len(ply["x"])} vertices)')
    teardown(ctx)
    return output


if __name__ == '__main__':
    main()
