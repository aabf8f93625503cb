"""NeRF-synthetic (Blender) dataset loader, ported from
nerficg_tpu/data/loaders/nerf.py (reference: src/Datasets/NeRF.py:42-107):
transforms_{split}.json with camera_angle_x and per-frame OpenGL
camera-to-world matrices; RGBA images split into rgb + alpha; OpenGL ->
COLMAP axis conversion. Test-set depth maps are not ported yet."""

from __future__ import annotations

import json

import numpy as np
from PIL import Image

from nerficg_torch.cameras.perspective import PerspectiveCamera
from nerficg_torch.cameras.pose import fov_to_focal
from nerficg_torch.core.config import Configurable
from nerficg_torch.core.errors import DatasetError
from nerficg_torch.core.registry import register_dataset
from nerficg_torch.data.base import BaseDataset
from nerficg_torch.data.types import ImageData, View

__all__ = ['NeRFDataset', 'opengl_to_colmap']

OPENGL_TO_COLMAP = np.diag(np.array([1.0, -1.0, -1.0, 1.0]))

# Blender -> COLMAP world rotation (reference: Datasets/NeRF.py:50-56).
BLENDER_TO_COLMAP_WORLD = np.array([
    [1.0, 0.0, 0.0, 0.0],
    [0.0, 0.0, -1.0, 0.0],
    [0.0, 1.0, 0.0, 0.0],
    [0.0, 0.0, 0.0, 1.0],
])


def opengl_to_colmap(c2w: np.ndarray) -> np.ndarray:
    """Blender/OpenGL camera-to-world -> COLMAP: flip the camera y/z axes and
    apply the Blender->COLMAP world rotation (reference: NeRF.py:50-56,66)."""
    return BLENDER_TO_COLMAP_WORLD @ np.asarray(c2w, np.float64) @ \
        OPENGL_TO_COLMAP


@register_dataset('NeRF')
@Configurable.configure(
    NEAR_PLANE=2.0,
    FAR_PLANE=6.0,
    BACKGROUND_COLOR=[1.0, 1.0, 1.0],
    LOAD_TEST_DEPTH=False,
)
class NeRFDataset(BaseDataset):

    SPLIT_FILES = {'train': 'transforms_train.json',
                   'test': 'transforms_test.json',
                   'val': 'transforms_val.json'}

    def load(self) -> None:
        if self.LOAD_TEST_DEPTH:
            raise DatasetError('LOAD_TEST_DEPTH is not ported yet')
        if not self.path.is_dir():
            raise DatasetError(f'NeRF dataset path not found: {self.path}')
        cameras: dict[tuple, PerspectiveCamera] = {}
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
                focal = fov_to_focal(float(meta['camera_angle_x']), width)
                key = (width, height, focal)
                if key not in cameras:
                    cameras[key] = PerspectiveCamera(
                        width=width, height=height, focal_x=focal,
                        focal_y=focal, settings=self.camera_settings)
                self.subsets[subset].append(View(
                    camera=cameras[key],
                    c2w=opengl_to_colmap(np.asarray(frame['transform_matrix'])),
                    camera_index=0, frame_idx=frame_idx,
                    rgb=ImageData(path=img_path, channels=slice(0, 3),
                                  scale_factor=scale),
                    alpha=ImageData(path=img_path, channels=slice(3, 4),
                                    scale_factor=scale)))
        if not any(self.subsets.values()):
            raise DatasetError(f'no views found in {self.path}')
