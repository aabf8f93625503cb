"""Framework setup / teardown.

Port of nerficg_tpu/core/setup.py (reference: ``Framework.setup``,
src/Framework.py:120-160): joins the process group of a data-parallel run,
seeds the python, numpy and torch generators, chooses the device, pins the
float32 matmul precision and configures logging.
"""

from __future__ import annotations

import datetime
import os
import random
import warnings
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from nerficg_torch.core.config import ConfigNode, load_config
from nerficg_torch.core.errors import ConfigError, KernelError
from nerficg_torch.core.logging import Logger

__all__ = ['FrameworkContext', 'setup', 'teardown', 'Directories',
           'resolve_device']


class Directories:
    """Output directory layout (reference: Framework.py:111, Model.py:25):
    ``<base>/<method>/<run name>_<timestamp>``."""

    base: Path = Path('output')

    @classmethod
    def output_dir(cls, method: str, run_name: str,
                   timestamp: bool = True) -> Path:
        if timestamp:
            stamp = datetime.datetime.now().strftime('%Y-%m-%d_%H-%M-%S')
            run_name = f'{run_name}_{stamp}'
        path = Path(cls.base) / method / run_name
        path.mkdir(parents=True, exist_ok=True)
        return path


def resolve_device(device: torch.device | str,
                   cpu_hint: str = '--device cpu') -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises
    rather than fall back to the CPU, which runs the kernels' plain
    versions and must be asked for (``cpu_hint`` says how)."""
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise KernelError(f'no CUDA card is available; pass {cpu_hint} to '
                          f'run on the CPU with the plain PyTorch versions')
    return device


@dataclass
class FrameworkContext:
    """Everything ``setup`` provides: explicit, no globals. ``rank`` and
    ``world_size`` are this process's place in the process group (0 and 1
    in one process)."""

    config: ConfigNode
    generator: torch.Generator
    device: torch.device
    rank: int = 0
    world_size: int = 1


def setup(config_path: str | None = None, overrides=(), *,
          config: ConfigNode | None = None,
          device: torch.device | str = 'cuda') -> FrameworkContext:
    """Initialize the framework (reference: Framework.setup, Framework.py:120-160).

    ``device`` defaults to the first CUDA card. Without one, setup raises
    rather than carry on on the CPU: the CPU runs the kernels' plain
    versions and must be asked for (``--device cpu``).

    Under ``GLOBAL.DISTRIBUTED`` (with ``COORDINATOR_ADDRESS``,
    ``NUM_PROCESSES`` and ``PROCESS_ID``, as the JAX package's setup takes
    them) or in a process that torchrun started with a world size above 1,
    the process joins the group first (``parallel.initialize_distributed``)
    and a rank of it computes on card ``LOCAL_RANK % device_count``."""
    # parallel/ imports core/, so it is imported here, not with this module.
    from nerficg_torch.parallel.mesh import (initialize_distributed,
                                             process_count, process_index)
    device = resolve_device(device)
    if config is None:
        config = load_config(config_path, overrides)
    g = config.GLOBAL
    Logger.set_level(g.get('LOG_LEVEL', 'NORMAL'))
    if g.get('DISTRIBUTED', False) or int(os.environ.get('WORLD_SIZE',
                                                         1)) > 1:
        world = initialize_distributed(
            coordinator_address=g.get('COORDINATOR_ADDRESS'),
            num_processes=g.get('NUM_PROCESSES'),
            process_id=g.get('PROCESS_ID'), device_type=device.type)
        if world > 1 and device.type == 'cuda':
            local = int(os.environ.get('LOCAL_RANK', process_index()))
            device = torch.device('cuda', local % torch.cuda.device_count())
        Logger.info(f'distributed: rank {process_index()} of {world}')
    if g.get('FILTER_WARNINGS', True):
        warnings.filterwarnings('ignore', category=UserWarning)
    # The JAX package multiplies in bf16 with f32 accumulation and never in
    # TF32; the port keeps float32 products in full float32.
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if g.get('ANOMALY_DETECTION', False):
        raise ConfigError('GLOBAL.ANOMALY_DETECTION is not ported')

    seed = int(g.get('RANDOM_SEED', 42))
    random.seed(seed)
    np.random.seed(seed)
    torch.manual_seed(seed)
    generator = torch.Generator().manual_seed(seed)
    name = torch.cuda.get_device_name(device) if device.type == 'cuda' else 'cpu'
    Logger.info(f'framework setup: device {device} [{name}], seed={seed}')
    return FrameworkContext(config=config, generator=generator, device=device,
                            rank=process_index(), world_size=process_count())


def teardown(ctx: FrameworkContext | None = None) -> None:
    """Wait for pending device work (reference: Framework.teardown,
    :311-320) and leave the process group, if the process joined one."""
    if ctx is not None and ctx.device.type == 'cuda':
        torch.cuda.synchronize(ctx.device)
    if torch.distributed.is_initialized():
        torch.distributed.barrier()
        torch.distributed.destroy_process_group()
