"""Mip-NeRF 360 dataset loader, a port of
nerficg_tpu/data/loaders/mipnerf360.py (reference:
src/Datasets/MipNeRF360.py:18-132): COLMAP scenes with pre-downscaled
images_{2,4,8} directories, PCA alignment, every-8th test split. The
intrinsics shrink by 1/DOWNSAMPLE; the images on disk are not resized again.
"""

from __future__ import annotations

from nerficg_torch.core.config import Configurable
from nerficg_torch.core.registry import register_dataset
from nerficg_torch.data.loaders.colmap import ColmapDataset

__all__ = ['MipNeRF360Dataset']


@register_dataset('MipNeRF360')
@Configurable.configure(
    TEST_STEP=8,
    DOWNSAMPLE=4,           # use images_{DOWNSAMPLE} (reference scene config)
    NORMALIZE_PCA=True,
)
class MipNeRF360Dataset(ColmapDataset):

    def load(self) -> None:
        down = int(self.DOWNSAMPLE)
        image_dir = f'images_{down}' if down > 1 else 'images'
        if (self.path / image_dir).is_dir():
            # Pre-downscaled images: intrinsics shrink by the same factor.
            self.IMAGE_DIR = image_dir
            self.IMAGE_SCALE_FACTOR = (self.IMAGE_SCALE_FACTOR or 1.0) / down
            super().load()
            # The scale factor applied to intrinsics already matches the
            # pre-downscaled files; images themselves must not be resized
            # again, so clear per-image scale factors.
            for view in self.all_views():
                for slot in view.IMAGE_SLOTS:
                    getattr(view, f'{slot}_data').scale_factor = None
        else:
            super().load()
