"""Tanks & Temples dataset loader (COLMAP-format scenes), a port of
nerficg_tpu/data/loaders/tanks_and_temples.py (reference:
src/Datasets/TanksAndTemples.py:16): PCA alignment, unit-cube normalization,
every-8th test split.
"""

from __future__ import annotations

from nerficg_torch.core.config import Configurable
from nerficg_torch.core.registry import register_dataset
from nerficg_torch.data.loaders.colmap import ColmapDataset

__all__ = ['TanksAndTemplesDataset']


@register_dataset('TanksAndTemples')
@Configurable.configure(
    TEST_STEP=8,
    NORMALIZE_PCA=True,
    NORMALIZE_CUBE=True,
)
class TanksAndTemplesDataset(ColmapDataset):
    pass
