#!/usr/bin/env python3
"""Compose a default config YAML from a method's and a dataset's defaults.

Port of scripts/create_config.py (reference: scripts/create_config.py:19-59):
the global defaults and the MODEL, RENDERER, TRAINING and DATASET defaults
of the named plugins, the same file the JAX package writes.

  python -m nerficg_torch.scripts.create_config -m GaussianSplatting \\
      -d MipNeRF360 -o CFG.yaml [-p SCENE] [-a]

With -a, one config per scene subdirectory of SCENE, written to
CFG/<scene>.yaml.
"""

from __future__ import annotations

import argparse
from pathlib import Path

from nerficg_torch.core.config import (ConfigNode, default_global_config,
                                       save_config)
from nerficg_torch.core.logging import Logger
from nerficg_torch.core.registry import Datasets, Methods

__all__ = ['build_config', 'main']


def build_config(method: str, dataset: str,
                 path: str | None = None) -> ConfigNode:
    entry = Methods.get_entry(method)
    config = ConfigNode({
        'GLOBAL': default_global_config(),
        'MODEL': entry.model_cls.default_parameters(),
        'RENDERER': entry.renderer_cls.default_parameters(),
        'TRAINING': entry.trainer_cls.default_parameters(),
        'DATASET': Datasets.get_class(dataset).default_parameters(),
    })
    config.GLOBAL.METHOD_TYPE = method
    config.GLOBAL.DATASET_TYPE = dataset
    if path is not None:
        config.DATASET.PATH = path
    return config


def main(argv: list[str] | None = None) -> list[Path]:
    """Returns the paths written."""
    parser = argparse.ArgumentParser(description='generate a default config')
    parser.add_argument('-m', '--method', required=True,
                        choices=Methods.options())
    parser.add_argument('-d', '--dataset', required=True,
                        choices=Datasets.options())
    parser.add_argument('-o', '--output', required=True)
    parser.add_argument('-p', '--path', default=None, help='dataset path')
    parser.add_argument('-a', '--all-scenes', action='store_true',
                        help='emit one config per scene subdirectory of '
                             '--path')
    args = parser.parse_args(argv)

    if args.all_scenes and args.path:
        scenes = sorted(p for p in Path(args.path).iterdir() if p.is_dir())
        jobs = [(str(scene), Path(args.output).with_suffix('') /
                 f'{scene.name}.yaml') for scene in scenes]
    else:
        jobs = [(args.path, Path(args.output))]
    for path, out in jobs:
        save_config(build_config(args.method, args.dataset, path), out)
        Logger.info(f'wrote {out}')
    return [out for _, out in jobs]


if __name__ == '__main__':
    main()
