"""Tanks & Temples (3DGS evaluation protocol) dataset loader, a port of
nerficg_tpu/data/loaders/tanks_and_temples_3dgs.py (reference:
src/Datasets/TanksAndTemples_3DGS.py:21): the 3DGS paper's T&T subset
(truck/train), half-resolution images whose COLMAP intrinsics are stored at
full resolution (hence INTRINSICS_SCALE 0.5), no scene normalization.
"""

from __future__ import annotations

from nerficg_torch.core.config import Configurable
from nerficg_torch.core.registry import register_dataset
from nerficg_torch.data.loaders.colmap import ColmapDataset

__all__ = ['TanksAndTemples3DGSDataset']


@register_dataset('TanksAndTemples_3DGS')
@Configurable.configure(
    TEST_STEP=8,
    NORMALIZE_PCA=False,
    INTRINSICS_SCALE=0.5,     # images are half the COLMAP model resolution
)
class TanksAndTemples3DGSDataset(ColmapDataset):

    def load(self) -> None:
        base = self.IMAGE_SCALE_FACTOR or 1.0
        self.IMAGE_SCALE_FACTOR = base * float(self.INTRINSICS_SCALE)
        super().load()
        # The images on disk are already at the target resolution; only the
        # intrinsics needed scaling (reference: TanksAndTemples_3DGS.py:21).
        for view in self.all_views():
            for slot in view.IMAGE_SLOTS:
                data = getattr(view, f'{slot}_data')
                data.scale_factor = None if base == 1.0 else base
