#!/usr/bin/env python3
"""Register a custom image sequence with the COLMAP command line.

Port of scripts/colmap.py (reference: scripts/colmap.py:40-180): feature
extraction, exhaustive, sequential or vocabulary-tree matching, mapping,
orientation alignment, the PLY of the points and, with --undistort,
undistortion, giving a scene the Colmap loader reads. Refuses when the
``colmap`` binary is not on PATH or SCENE/images is missing.

  python -m nerficg_torch.scripts.colmap -p SCENE [--matcher exhaustive] \\
      [--camera-model OPENCV] [--undistort] [--gpu]
"""

from __future__ import annotations

import argparse
import shutil
import subprocess
import sys
from pathlib import Path

from nerficg_torch.core.logging import Logger

__all__ = ['run', 'main']


def run(cmd: list[str]) -> None:
    Logger.info('$ ' + ' '.join(cmd))
    result = subprocess.run(cmd)
    if result.returncode != 0:
        raise RuntimeError(f'command failed ({result.returncode}): {cmd[0]}')


def main(argv: list[str] | None = None) -> Path:
    """Returns the scene directory."""
    parser = argparse.ArgumentParser(description='COLMAP scene ingestion')
    parser.add_argument('-p', '--path', required=True,
                        help='scene dir containing an images/ folder')
    parser.add_argument('--matcher', choices=['exhaustive', 'sequential',
                                              'vocab_tree'],
                        default='exhaustive')
    parser.add_argument('--camera-model', default='OPENCV')
    parser.add_argument('--single-camera', action='store_true', default=True)
    parser.add_argument('--undistort', action='store_true')
    parser.add_argument('--gpu', action='store_true',
                        help='COLMAP\'s own GPU SIFT (needs a CUDA build of '
                             'COLMAP)')
    args = parser.parse_args(argv)

    if shutil.which('colmap') is None:
        Logger.error('the `colmap` binary is not installed / not on PATH')
        sys.exit(1)
    scene = Path(args.path)
    images = scene / 'images'
    if not images.is_dir():
        Logger.error(f'no images/ directory in {scene}')
        sys.exit(1)
    db = scene / 'database.db'
    sparse = scene / 'sparse'
    sparse.mkdir(exist_ok=True)
    use_gpu = '1' if args.gpu else '0'

    run(['colmap', 'feature_extractor', '--database_path', str(db),
         '--image_path', str(images),
         '--ImageReader.camera_model', args.camera_model,
         '--ImageReader.single_camera', '1' if args.single_camera else '0',
         '--SiftExtraction.use_gpu', use_gpu])
    run(['colmap', f'{args.matcher}_matcher', '--database_path', str(db),
         '--SiftMatching.use_gpu', use_gpu])
    run(['colmap', 'mapper', '--database_path', str(db),
         '--image_path', str(images), '--output_path', str(sparse)])
    model = sparse / '0'
    aligned = scene / 'sparse_aligned'
    aligned.mkdir(exist_ok=True)
    run(['colmap', 'model_orientation_aligner', '--image_path', str(images),
         '--input_path', str(model), '--output_path', str(aligned)])
    run(['colmap', 'model_converter', '--input_path', str(aligned),
         '--output_path', str(scene / 'points3d.ply'),
         '--output_type', 'PLY'])
    if args.undistort:
        run(['colmap', 'image_undistorter', '--image_path', str(images),
             '--input_path', str(aligned),
             '--output_path', str(scene / 'undistorted')])
    Logger.info(f'scene ready: load with DATASET_TYPE=Colmap PATH={scene}')
    return scene


if __name__ == '__main__':
    main()
