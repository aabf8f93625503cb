"""OmniBlender 360-degree panorama dataset loader, ported from
nerficg_tpu/data/loaders/omni_blender.py (reference:
src/Datasets/OmniBlender.py:18): Blender-rendered equirectangular panoramas
with transforms_{split}.json in the NeRF-synthetic frame layout, without
camera_angle_x; one EquirectangularCamera per image size."""

from __future__ import annotations

import json

import numpy as np
from PIL import Image

from nerficg_torch.cameras.equirectangular import EquirectangularCamera
from nerficg_torch.core.config import Configurable
from nerficg_torch.core.errors import DatasetError
from nerficg_torch.core.registry import register_dataset
from nerficg_torch.data.base import BaseDataset
from nerficg_torch.data.loaders.nerf import opengl_to_colmap
from nerficg_torch.data.types import ImageData, View

__all__ = ['OmniBlenderDataset']


@register_dataset('OmniBlender')
@Configurable.configure(
    NEAR_PLANE=0.05,
    FAR_PLANE=20.0,
    BACKGROUND_COLOR=[0.0, 0.0, 0.0],
)
class OmniBlenderDataset(BaseDataset):

    SPLIT_FILES = {'train': 'transforms_train.json',
                   'test': 'transforms_test.json',
                   'val': 'transforms_val.json'}

    def load(self) -> None:
        if not self.path.is_dir():
            raise DatasetError(f'dataset path not found: {self.path}')
        cameras: dict[tuple, EquirectangularCamera] = {}
        for subset, filename in self.SPLIT_FILES.items():
            meta_path = self.path / filename
            if not meta_path.is_file():
                continue
            with open(meta_path) as f:
                meta = json.load(f)
            for frame_idx, frame in enumerate(meta['frames']):
                img_path = self.path / frame['file_path'].lstrip('./')
                if not img_path.suffix:
                    img_path = img_path.with_suffix('.png')
                if not img_path.is_file():
                    continue
                with Image.open(img_path) as img:
                    width, height = img.size
                scale = self.IMAGE_SCALE_FACTOR
                if scale:
                    width = max(int(round(width * scale)), 1)
                    height = max(int(round(height * scale)), 1)
                key = (width, height)
                if key not in cameras:
                    cameras[key] = EquirectangularCamera(
                        width=width, height=height,
                        settings=self.camera_settings)
                self.subsets[subset].append(View(
                    camera=cameras[key],
                    c2w=opengl_to_colmap(np.asarray(frame['transform_matrix'])),
                    frame_idx=frame_idx,
                    timestamp=float(frame.get('time', 0.0)),
                    rgb=ImageData(path=img_path, channels=slice(0, 3),
                                  scale_factor=scale)))
        if not any(self.subsets.values()):
            raise DatasetError(f'no views found in {self.path}')
