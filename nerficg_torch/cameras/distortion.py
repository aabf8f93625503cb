"""Radial/tangential lens distortion (OpenCV k1..k6, p1, p2 model).

Port of nerficg_tpu/cameras/distortion.py (reference:
``RadialTangentialDistortion``, src/Cameras/utils.py:88-127): analytic
distort, fixed-point undistort (10 iterations). Elementwise, on numpy
arrays (host geometry) and torch tensors (ray directions on a device).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

__all__ = ['RadialTangentialDistortion']


def _stack(x, y):
    if isinstance(x, torch.Tensor):
        return torch.stack([x, y], dim=-1)
    return np.stack([x, y], axis=-1)


@dataclass(frozen=True)
class RadialTangentialDistortion:
    k1: float = 0.0
    k2: float = 0.0
    k3: float = 0.0
    k4: float = 0.0
    k5: float = 0.0
    k6: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    undistort_iterations: int = 10

    def is_identity(self) -> bool:
        return all(abs(v) < 1e-12 for v in
                   (self.k1, self.k2, self.k3, self.k4, self.k5, self.k6,
                    self.p1, self.p2))

    def distort(self, xy):
        """Distort normalized camera-plane coordinates (..., 2)
        (reference: Cameras/utils.py:107-127)."""
        x, y = xy[..., 0], xy[..., 1]
        r2 = x * x + y * y
        radial_num = 1.0 + r2 * (self.k1 + r2 * (self.k2 + r2 * self.k3))
        radial_den = 1.0 + r2 * (self.k4 + r2 * (self.k5 + r2 * self.k6))
        radial = radial_num / radial_den
        xy_prod = x * y
        x_out = x * radial + 2.0 * self.p1 * xy_prod + self.p2 * (r2 + 2.0 * x * x)
        y_out = y * radial + self.p1 * (r2 + 2.0 * y * y) + 2.0 * self.p2 * xy_prod
        return _stack(x_out, y_out)

    def undistort(self, xy):
        """Fixed-point inverse of ``distort`` (reference:
        Cameras/utils.py:88-105)."""
        if self.is_identity():
            return xy
        result = xy
        for _ in range(self.undistort_iterations):
            result = result + (xy - self.distort(result))
        return result

    @staticmethod
    def from_colmap(params: dict) -> 'RadialTangentialDistortion':
        return RadialTangentialDistortion(
            k1=float(params.get('k1', 0.0)), k2=float(params.get('k2', 0.0)),
            k3=float(params.get('k3', 0.0)), k4=float(params.get('k4', 0.0)),
            k5=float(params.get('k5', 0.0)), k6=float(params.get('k6', 0.0)),
            p1=float(params.get('p1', 0.0)), p2=float(params.get('p2', 0.0)))
