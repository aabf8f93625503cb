"""360-degree equirectangular (panorama) camera, ported from
nerficg_tpu/cameras/equirectangular.py (reference:
src/Cameras/Equirectangular.py:13-65): direction <-> azimuth/elevation,
used by the OmniBlender, Ricoh360 and RaRPano loaders. The math works on
numpy arrays and on torch tensors, picked from the inputs."""

from __future__ import annotations

import math

from nerficg_torch.cameras.base import BaseCamera, array_module

__all__ = ['EquirectangularCamera']


class EquirectangularCamera(BaseCamera):
    """Pixel (x, y) maps to azimuth/elevation over the full sphere, in
    COLMAP axes (x right, y down, z forward):
      azimuth   theta in [-pi, pi]     from pixel x, 0 at the image centre (+z)
      elevation phi   in [-pi/2, pi/2] from pixel y, +pi/2 at the top (-y)
    """

    def _intrinsics_key(self) -> tuple:
        return ()

    def scaled(self, factor: float) -> 'EquirectangularCamera':
        return EquirectangularCamera(
            width=max(int(round(self.width * factor)), 1),
            height=max(int(round(self.height * factor)), 1),
            settings=self.settings)

    def pixel_to_angles(self, pixels):
        """(..., 2) pixels -> (theta, phi) (reference: Cameras/utils.py:237-253)."""
        theta = (pixels[..., 0] / self.width - 0.5) * (2.0 * math.pi)
        phi = (0.5 - pixels[..., 1] / self.height) * math.pi
        return theta, phi

    def angles_to_pixel(self, theta, phi):
        xp = array_module(theta, phi)
        x = (theta / (2.0 * math.pi) + 0.5) * self.width
        y = (0.5 - phi / math.pi) * self.height
        return xp.stack([x, y], axis=-1)

    def cam_to_screen(self, points_cam):
        """(..., 3) -> (px, py, range) (reference: Equirectangular.py:16-40).
        A point on the seam (x = -0.0, z < 0) maps to azimuth -pi by
        atan2's sign of zero; a point at the centre has range 0."""
        xp = array_module(points_cam)
        x, y, z = points_cam[..., 0], points_cam[..., 1], points_cam[..., 2]
        r = xp.sqrt(x * x + y * y + z * z)
        theta = xp.arctan2(x, z)
        phi = xp.arcsin(xp.clip(-y / xp.clip(r, 1e-12, None), -1.0, 1.0))
        pix = self.angles_to_pixel(theta, phi)
        return xp.concatenate([pix, r[..., None]], axis=-1)

    def screen_to_cam(self, pixels, depth):
        """(..., 2) pixels at ranges (...,) -> (..., 3) camera space
        (reference: Equirectangular.py:42-65)."""
        xp = array_module(pixels, depth)
        theta, phi = self.pixel_to_angles(pixels)
        cos_phi = xp.cos(phi)
        direction = xp.stack([
            cos_phi * xp.sin(theta),    # x right
            -xp.sin(phi),               # y down
            cos_phi * xp.cos(theta),    # z forward
        ], axis=-1)
        return direction * depth[..., None]
