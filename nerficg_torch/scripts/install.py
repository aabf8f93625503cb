#!/usr/bin/env python3
"""Environment doctor for the port.

Port of scripts/install.py (reference: scripts/install.py:42-87, which
builds each method's CUDA extensions by importing it). The port's kernels
are one library that ``ops/_kernels.py`` builds with ``nvcc`` at first
use, so the doctor reports torch and its CUDA, the card (``nvidia-smi``'s
name and power limit), builds or loads the kernel library, imports every
registered method and dataset, and names each missing optional piece with
how to get it. It exits 1 on a problem, and without a card unless
``--device cpu`` asks for a check of the CPU alone.

  python -m nerficg_torch.scripts.install [-m METHOD] [--device cpu]
"""

from __future__ import annotations

import argparse
import importlib
import subprocess
import sys
import time

import torch

from nerficg_torch.core.logging import Logger

__all__ = ['OPTIONAL', 'check_device', 'check_methods', 'check_optional',
           'main']

# Optional integrations: (module, what needs it, how to get it).
OPTIONAL = [
    ('wandb', 'experiment tracking (TRAINING.WANDB, core/wandb_utils.py)',
     'pip install wandb'),
    ('plyfile', 'cross-checks of the PLY export (scripts/convert_to_ply.py '
     'writes PLY itself)', 'pip install plyfile'),
    ('lpips', 'the LPIPS fallback without a weights file '
     '(optim/metrics.py)', 'pip install lpips'),
]


def check_device(device: str) -> bool:
    """torch, the card and the kernel library; False on a problem."""
    Logger.info(f'torch {torch.__version__}, CUDA {torch.version.cuda}, '
                f'{torch.cuda.device_count()} card(s) visible')
    if device == 'cpu':
        ok = float(torch.ones(8).sum()) == 8.0
        Logger.info('device cpu: the kernels\' plain PyTorch versions; '
                    'kernel library not checked')
        return ok
    if not torch.cuda.is_available():
        Logger.error('no CUDA card is available; pass --device cpu to check '
                     'the CPU alone')
        return False
    try:
        smi = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                              '--format=csv,noheader'], capture_output=True,
                             text=True, timeout=60, check=True)
        Logger.info(f'card: {smi.stdout.strip().splitlines()[0]}')
    except (OSError, subprocess.SubprocessError) as exc:
        Logger.warning(f'nvidia-smi unavailable ({exc}); card: '
                       f'{torch.cuda.get_device_name(0)}')
    ok = float(torch.ones(8, device='cuda').sum()) == 8.0
    if not ok:
        Logger.error('device smoke test produced a wrong result')
    from nerficg_torch.ops import _kernels
    try:
        start = time.perf_counter()
        path, compile_s = _kernels.build_library()
        _kernels.load_library()
        Logger.info(f'kernel library {path.name}: '
                    + (f'built in {compile_s:.1f} s' if compile_s
                       else 'loaded (already built)')
                    + f', bound in {time.perf_counter() - start:.1f} s')
    except Exception as exc:
        Logger.error(f'kernel library failed to build or load: {exc}')
        ok = False
    return ok


def check_methods(only: str | None) -> bool:
    from nerficg_torch.core.registry import Datasets, Methods
    ok = True
    for name in [only] if only else Methods.options():
        try:
            entry = Methods.get_entry(name)
            Logger.info(f'method {name}: model={entry.model_cls.__name__}, '
                        f'renderer={entry.renderer_cls.__name__}, trainer='
                        f'{getattr(entry.trainer_cls, "__name__", None)}')
        except Exception as exc:
            Logger.error(f'method {name} failed to import: {exc}')
            ok = False
    if only is None:
        for name in Datasets.options():
            try:
                Datasets.get_class(name)
            except Exception as exc:
                Logger.error(f'dataset {name} failed to import: {exc}')
                ok = False
        Logger.info(f'{len(Datasets.options())} dataset loaders importable')
    return ok


def check_optional() -> None:
    from nerficg_torch.optim.lpips import ENV_KEY, weights_path
    path = weights_path()
    if path.is_file():
        Logger.info(f'optional LPIPS weights: {path}')
    else:
        Logger.warning(f'optional LPIPS weights: MISSING at {path} — LPIPS '
                       f'is NaN; write the npz with optim/lpips.py '
                       f'save_weights_npz where the lpips package is, and '
                       f'point {ENV_KEY} at it')
    for module, why, cmd in OPTIONAL:
        try:
            importlib.import_module(module)
            Logger.info(f'optional {module}: available ({why})')
        except ImportError:
            Logger.warning(f'optional {module}: MISSING — {why}; '
                           f'install with: {cmd}')


def main(argv: list[str] | None = None) -> int:
    """Returns 0, or exits 1 on a problem."""
    parser = argparse.ArgumentParser(description='check the environment')
    parser.add_argument('-m', '--method', default=None,
                        help='check a single method only')
    parser.add_argument('--device', choices=('cuda', 'cpu'), default='cuda',
                        help='cuda (default: the first card) or cpu')
    args = parser.parse_args(argv)
    ok = check_device(args.device)
    ok = check_methods(args.method) and ok
    check_optional()
    if not ok:
        Logger.error('environment has problems (see above)')
        sys.exit(1)
    Logger.info('environment OK')
    return 0


if __name__ == '__main__':
    main()
