"""Multi-resolution hash-grid configuration and table layout (Instant-NGP).

Port of nerficg_tpu/ops/hashgrid.py: ``HashGridConfig`` and the
``(L, F, T/128, 128)`` table layout of ``init_hash_grid_mxu`` that the
windowed encode (ops/hash_window.py) and the checkpoints use.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Optional

import torch

__all__ = ['HashGridConfig', 'init_hash_grid_mxu']


@dataclass(frozen=True)
class HashGridConfig:
    num_levels: int = 16
    features_per_level: int = 2
    log2_table_size: int = 19
    base_resolution: int = 16
    target_resolution: int = 2048
    # Samples per morton-sorted expansion block of the marcher's stream: the
    # windowed encode takes its per-sub-block table windows over one anchor
    # per block (see nerficg_tpu/ops/hashgrid.py). 1 = per-sample min/max.
    anchor_stride: int = 1

    @property
    def table_size(self) -> int:
        return 1 << self.log2_table_size

    @property
    def output_dim(self) -> int:
        return self.num_levels * self.features_per_level

    @property
    def growth_factor(self) -> float:
        if self.num_levels <= 1:
            return 1.0
        return math.exp(math.log(self.target_resolution / self.base_resolution)
                        / (self.num_levels - 1))

    def level_resolutions(self) -> tuple[int, ...]:
        g = self.growth_factor
        return tuple(int(math.floor(self.base_resolution * (g ** l)))
                     for l in range(self.num_levels))


def init_hash_grid_mxu(config: HashGridConfig,
                       generator: Optional[torch.Generator] = None,
                       device: torch.device | str = 'cpu') -> torch.Tensor:
    """(L, F, T/128, 128) table, uniform in [-1e-4, 1e-4] (tcnn convention)."""
    if config.table_size % 128 != 0:
        raise ValueError('table size must be a multiple of 128')
    shape = (config.num_levels, config.features_per_level,
             config.table_size // 128, 128)
    table = torch.rand(shape, generator=generator, dtype=torch.float32)
    return (table * 2e-4 - 1e-4).to(device)
