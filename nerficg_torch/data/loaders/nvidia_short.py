"""Nvidia dynamic-scenes ("Nvidia short") dataset loader, ported from
nerficg_tpu/data/loaders/nvidia_short.py (reference:
src/Datasets/NvidiaShort.py:16): a 12-camera rig monocularised by taking
camera (t mod 12) at time t; poses and depth bounds from ``poses_bounds.npy``
in LLFF's convention; timestamps idx / (n - 1); one camera per (focal,
width, height)."""

from __future__ import annotations

import numpy as np

from nerficg_torch.cameras.perspective import PerspectiveCamera
from nerficg_torch.core.config import Configurable
from nerficg_torch.core.errors import DatasetError
from nerficg_torch.core.registry import register_dataset
from nerficg_torch.data.base import BaseDataset
from nerficg_torch.data.types import ImageData, View

__all__ = ['NvidiaShortDataset', 'llff_pose_to_colmap']


def llff_pose_to_colmap(pose_3x5: np.ndarray) -> tuple[np.ndarray, float, int, int]:
    """LLFF [down right back | hwf] rows -> COLMAP c2w + (focal, h, w)."""
    m = pose_3x5[:, :4]
    h, w, focal = pose_3x5[:, 4]
    c2w = np.eye(4)
    c2w[:3, 0] = m[:, 1]          # right
    c2w[:3, 1] = m[:, 0]          # down
    c2w[:3, 2] = -m[:, 2]         # forward
    c2w[:3, 3] = m[:, 3]
    return c2w, float(focal), int(h), int(w)


@register_dataset('NvidiaShort')
@Configurable.configure(
    IMAGE_DIR='images',
    NEAR_PLANE=0.1,
    FAR_PLANE=100.0,
    TEST_HOLD_CAMERA=0,
)
class NvidiaShortDataset(BaseDataset):
    """Every frame goes to the training split, as in the JAX package
    (TEST_HOLD_CAMERA is read by neither); near and far come from the
    bounds, x 0.9 and x 1.1."""

    def load(self) -> None:
        poses_path = self.path / 'poses_bounds.npy'
        if not poses_path.is_file():
            raise DatasetError(f'poses_bounds.npy not found in {self.path}')
        poses_bounds = np.load(poses_path)          # (N, 17)
        poses = poses_bounds[:, :15].reshape(-1, 3, 5)
        bounds = poses_bounds[:, 15:]
        image_dir = self.path / str(self.IMAGE_DIR)
        images = sorted(p for p in image_dir.iterdir()
                        if p.suffix.lower() in ('.png', '.jpg', '.jpeg'))
        if len(images) != len(poses):
            raise DatasetError(
                f'{len(images)} images vs {len(poses)} poses in {self.path}')
        self.camera_settings.near = float(bounds[:, 0].min()) * 0.9
        self.camera_settings.far = float(bounds[:, 1].max()) * 1.1

        scale = self.IMAGE_SCALE_FACTOR
        s = scale or 1.0
        n = len(images)
        cameras: dict[tuple, PerspectiveCamera] = {}
        for idx, (img_path, pose) in enumerate(zip(images, poses)):
            c2w, focal, h, w = llff_pose_to_colmap(pose)
            key = (round(focal * s, 3), int(w * s), int(h * s))
            if key not in cameras:
                cameras[key] = PerspectiveCamera(
                    width=max(int(round(w * s)), 1),
                    height=max(int(round(h * s)), 1),
                    focal_x=focal * s, focal_y=focal * s,
                    settings=self.camera_settings)
            self.subsets['train'].append(View(
                camera=cameras[key], c2w=c2w, frame_idx=idx,
                timestamp=idx / max(n - 1, 1),
                rgb=ImageData(path=img_path, channels=slice(0, 3),
                              scale_factor=scale)))
