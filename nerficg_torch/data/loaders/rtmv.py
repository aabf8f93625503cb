"""RTMV (ray-traced multi-view) dataset loader, ported from
nerficg_tpu/data/loaders/rtmv.py (reference: src/Datasets/RTMV.py:36): a
json per frame beside its image (``camera_data`` with the intrinsics and a
transposed ``cam2world``), one camera per (width, height, fx), every
TEST_STEP-th frame (the first included) a test view."""

from __future__ import annotations

import json

import numpy as np

from nerficg_torch.cameras.perspective import PerspectiveCamera
from nerficg_torch.core.config import Configurable
from nerficg_torch.core.errors import DatasetError
from nerficg_torch.core.registry import register_dataset
from nerficg_torch.data.base import BaseDataset
from nerficg_torch.data.loaders.nerf import opengl_to_colmap
from nerficg_torch.data.types import ImageData, View

__all__ = ['RTMVDataset']


@register_dataset('RTMV')
@Configurable.configure(
    NEAR_PLANE=0.1,
    FAR_PLANE=10.0,
    BACKGROUND_COLOR=[1.0, 1.0, 1.0],
    TEST_STEP=10,
)
class RTMVDataset(BaseDataset):

    def load(self) -> None:
        if not self.path.is_dir():
            raise DatasetError(f'RTMV dataset path not found: {self.path}')
        metas = sorted(self.path.glob('*.json'))
        if not metas:
            raise DatasetError(f'no per-frame json files in {self.path}')
        scale = self.IMAGE_SCALE_FACTOR
        s = scale or 1.0
        cameras: dict[tuple, PerspectiveCamera] = {}
        step = int(self.TEST_STEP)
        idx = 0
        for meta_path in metas:
            img_path = next((meta_path.with_suffix(suffix)
                             for suffix in ('.png', '.jpg', '.exr')
                             if meta_path.with_suffix(suffix).is_file()), None)
            if img_path is None:
                continue
            with open(meta_path) as f:
                meta = json.load(f)
            cam_data = meta.get('camera_data', meta)
            width = int(cam_data.get('width', 0))
            height = int(cam_data.get('height', 0))
            intr = cam_data.get('intrinsics', {})
            key = (width, height, float(intr.get('fx', 0.0)))
            if key not in cameras:
                cameras[key] = PerspectiveCamera(
                    width=max(int(round(width * s)), 1),
                    height=max(int(round(height * s)), 1),
                    focal_x=float(intr.get('fx', width)) * s,
                    focal_y=float(intr.get('fy', intr.get('fx', width))) * s,
                    center_x=float(intr.get('cx', width / 2)) * s,
                    center_y=float(intr.get('cy', height / 2)) * s,
                    settings=self.camera_settings)
            c2w = opengl_to_colmap(
                np.asarray(cam_data['cam2world'], np.float64).T)
            subset = 'test' if step > 0 and idx % step == 0 else 'train'
            self.subsets[subset].append(View(
                camera=cameras[key], c2w=c2w, frame_idx=idx,
                rgb=ImageData(path=img_path, channels=slice(0, 3),
                              scale_factor=scale)))
            idx += 1
        if not any(self.subsets.values()):
            raise DatasetError(f'no frames loaded from {self.path}')
