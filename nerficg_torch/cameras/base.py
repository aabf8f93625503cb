"""Abstract camera model, ported from nerficg_tpu/cameras/base.py
(reference: src/Cameras/Base.py:13-78, src/Cameras/utils.py:162-177).

Cameras are host-side metadata objects. Their per-pixel math works on numpy
arrays (host geometry) and on torch tensors (ray generation on a device),
picked from the inputs; local ray-direction grids are cached per camera.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from nerficg_torch.core.errors import CameraError

__all__ = ['SharedCameraSettings', 'BaseCamera', 'generate_rays',
           'array_module']


def array_module(*arrays):
    """torch for tensor inputs, numpy otherwise: the camera math's backend."""
    return torch if any(isinstance(a, torch.Tensor) for a in arrays) else np


@dataclass
class SharedCameraSettings:
    """Background color + near/far shared by all cameras of a dataset."""

    background_color: np.ndarray = field(
        default_factory=lambda: np.zeros(3, dtype=np.float32))
    near: float = 0.01
    far: float = 100.0

    def __post_init__(self):
        self.background_color = np.asarray(self.background_color, dtype=np.float32)
        if self.near <= 0 or self.far <= self.near:
            raise CameraError(f'invalid near/far planes: {self.near}/{self.far}')


class BaseCamera:
    """Abstract camera (reference: Cameras/Base.py:13-78)."""

    def __init__(self, width: int, height: int,
                 settings: SharedCameraSettings | None = None):
        if width <= 0 or height <= 0:
            raise CameraError(f'invalid image size {width}x{height}')
        self.width = int(width)
        self.height = int(height)
        self.settings = settings if settings is not None else SharedCameraSettings()
        self._ray_direction_cache: dict = {}

    @property
    def near(self) -> float:
        return self.settings.near

    @property
    def far(self) -> float:
        return self.settings.far

    @property
    def background_color(self) -> np.ndarray:
        return self.settings.background_color

    def _intrinsics_key(self) -> tuple:
        raise NotImplementedError

    def cam_to_screen(self, points_cam):
        """Project camera-space points (..., 3) -> pixel coords + depth (..., 3)."""
        raise NotImplementedError

    def screen_to_cam(self, pixels, depth):
        """Unproject pixel coords (..., 2) at given depth -> camera space (..., 3)."""
        raise NotImplementedError

    def local_ray_directions(self, device: torch.device | str = 'cpu'
                             ) -> torch.Tensor:
        """Cached (H*W, 3) float32 camera-space ray directions, row-major."""
        key = (self.width, self.height, str(device)) + self._intrinsics_key()
        if key not in self._ray_direction_cache:
            pixels = self.pixel_grid(device)
            self._ray_direction_cache[key] = self.screen_to_cam(
                pixels, torch.ones(pixels.shape[0], device=device))
        return self._ray_direction_cache[key]

    def local_ray_radii(self, device: torch.device | str = 'cpu'
                        ) -> torch.Tensor:
        """(H*W,) float32 base radii of the pixels' cones, row-major
        (Mip-NeRF 360): 2/sqrt(12) times the mean distance from each
        pixel's unit direction to those of its neighbours one pixel right
        and one pixel down, unprojected as the pixel itself is. Rotations
        keep distances, so the camera-space value is the world's."""
        pixels = self.pixel_grid(device)
        depth = torch.ones(pixels.shape[0], device=device)

        def unit(p):
            d = self.screen_to_cam(p, depth)
            return d / torch.linalg.norm(d, dim=-1, keepdim=True)

        here = unit(pixels)
        step = torch.eye(2, dtype=torch.float32, device=device)
        dx = torch.linalg.norm(unit(pixels + step[0]) - here, dim=-1)
        dy = torch.linalg.norm(unit(pixels + step[1]) - here, dim=-1)
        return 0.5 * (dx + dy) * (2.0 / 12.0 ** 0.5)

    def pixel_grid(self, device: torch.device | str = 'cpu') -> torch.Tensor:
        """(H*W, 2) float32 pixel-center coordinates (x, y), row-major."""
        x = torch.arange(self.width, dtype=torch.float32, device=device) + 0.5
        y = torch.arange(self.height, dtype=torch.float32, device=device) + 0.5
        yy, xx = torch.meshgrid(y, x, indexing='ij')
        return torch.stack([xx.reshape(-1), yy.reshape(-1)], dim=-1)


def generate_rays(c2w: torch.Tensor, local_directions: torch.Tensor,
                  normalize: bool = True) -> tuple[torch.Tensor, torch.Tensor]:
    """Rotate camera-space directions into the world and emit origins.

    c2w: (4, 4) or (3, 4); local_directions: (N, 3). Returns world-space
    (origins (N, 3), directions (N, 3))."""
    rot = c2w[:3, :3]
    t = c2w[:3, 3]
    directions = local_directions @ rot.T
    if normalize:
        directions = directions / torch.linalg.norm(directions, dim=-1,
                                                    keepdim=True)
    origins = t.expand(directions.shape)
    return origins, directions
