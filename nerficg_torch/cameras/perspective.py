"""Pinhole perspective camera with optional radial/tangential distortion,
ported from nerficg_tpu/cameras/perspective.py (reference:
src/Cameras/Perspective.py:16-147)."""

from __future__ import annotations

import math

import numpy as np
import torch

from nerficg_torch.cameras.base import (BaseCamera, SharedCameraSettings,
                                        array_module)
from nerficg_torch.cameras.distortion import RadialTangentialDistortion
from nerficg_torch.cameras.pose import fov_to_focal

__all__ = ['PerspectiveCamera']


def _cat(xp, arrays):
    return torch.cat(arrays, dim=-1) if xp is torch else \
        np.concatenate(arrays, axis=-1)


class PerspectiveCamera(BaseCamera):

    def __init__(self, width: int, height: int,
                 focal_x: float | None = None, focal_y: float | None = None,
                 center_x: float | None = None, center_y: float | None = None,
                 distortion: RadialTangentialDistortion | None = None,
                 settings: SharedCameraSettings | None = None):
        super().__init__(width, height, settings)
        # Default 45 degree vertical FOV (reference: Perspective.py:24-37).
        default_focal = fov_to_focal(math.radians(45.0), height)
        self.focal_x = float(focal_x if focal_x is not None else default_focal)
        self.focal_y = float(focal_y if focal_y is not None else self.focal_x)
        self.center_x = float(center_x if center_x is not None else width / 2.0)
        self.center_y = float(center_y if center_y is not None else height / 2.0)
        self.distortion = distortion

    def _lens(self) -> RadialTangentialDistortion | None:
        d = self.distortion
        return None if d is None or d.is_identity() else d

    def _intrinsics_key(self) -> tuple:
        d = self.distortion
        dist_key = () if d is None else \
            (d.k1, d.k2, d.k3, d.k4, d.k5, d.k6, d.p1, d.p2)
        return (self.focal_x, self.focal_y, self.center_x,
                self.center_y) + dist_key

    def cam_to_screen(self, points_cam):
        """(..., 3) camera space -> (..., 3) = (px, py, depth)."""
        xp = array_module(points_cam)
        z = points_cam[..., 2:3]
        xy = points_cam[..., :2] / xp.where(xp.abs(z) < 1e-12, 1e-12, z)
        lens = self._lens()
        if lens is not None:
            xy = lens.distort(xy)
        px = xy[..., 0:1] * self.focal_x + self.center_x
        py = xy[..., 1:2] * self.focal_y + self.center_y
        return _cat(xp, [px, py, z])

    def screen_to_cam(self, pixels, depth):
        """(..., 2) pixels + (...,) depth -> (..., 3) camera space."""
        xp = array_module(pixels, depth)
        x = (pixels[..., 0] - self.center_x) / self.focal_x
        y = (pixels[..., 1] - self.center_y) / self.focal_y
        xy = xp.stack([x, y], -1)
        lens = self._lens()
        if lens is not None:
            xy = lens.undistort(xy)
        depth = depth[..., None]
        return _cat(xp, [xy * depth, depth])
