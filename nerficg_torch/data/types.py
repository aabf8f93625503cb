"""Core data model: lazy images, views, ray batches.

Port of nerficg_tpu/data/types.py (the part the serving path uses;
reference: src/Datasets/utils.py ImageData :693-763, View :766-1086,
RayBatch :536-670). Images stay numpy HWC on the host until a step
consumes them; rays are generated on the requested device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

from nerficg_torch.cameras.base import BaseCamera, generate_rays
from nerficg_torch.core.errors import DatasetError
from nerficg_torch.data.io import load_image, resize_image

__all__ = ['ImageData', 'View', 'RayBatch', 'RayCollection']


@dataclass
class ImageData:
    """Lazy image handle: path + channel slice + scale factor; decoded on
    access (reference: Datasets/utils.py:693-763)."""

    path: Optional[Path] = None
    channels: Optional[slice] = None
    scale_factor: Optional[float] = None
    load_fn: Optional[Callable] = None
    data: Optional[np.ndarray] = None       # eager data (HWC float32)

    def exists(self) -> bool:
        return self.data is not None or (self.path is not None and Path(self.path).is_file())

    def prefetch(self) -> 'ImageData':
        """Decode now and keep the decoded image (reference:
        ImageData.prefetch)."""
        if self.data is None and self.path is not None:
            self.data = self._decode()
        return self

    def _decode(self) -> np.ndarray:
        fn = self.load_fn if self.load_fn is not None else load_image
        out = fn(self.path, None)
        if self.scale_factor is not None and self.scale_factor != 1.0:
            out = resize_image(out, self.scale_factor)
        return out

    def load(self) -> Optional[np.ndarray]:
        """Decode (or return eager) image -> HWC float32."""
        if self.data is not None:
            out = self.data
        else:
            if self.path is None:
                return None
            out = self._decode()
        if self.channels is not None:
            out = out[..., self.channels]
        return out


_RAY_FIELDS = ('origins', 'directions', 'view_directions', 'rgb', 'alpha',
               'depth', 'timestamps', 'pixel_ids', 'view_ids')


@dataclass(frozen=True)
class RayBatch:
    """Structure-of-arrays ray batch: every field an (N, C) tensor or None
    (reference: Datasets/utils.py:536-670)."""

    origins: torch.Tensor
    directions: torch.Tensor
    view_directions: Optional[torch.Tensor] = None
    rgb: Optional[torch.Tensor] = None
    alpha: Optional[torch.Tensor] = None
    depth: Optional[torch.Tensor] = None
    timestamps: Optional[torch.Tensor] = None
    pixel_ids: Optional[torch.Tensor] = None
    view_ids: Optional[torch.Tensor] = None

    def __post_init__(self):
        n = self.origins.shape[0]
        for name in _RAY_FIELDS:
            value = getattr(self, name)
            if value is not None and value.shape[0] != n:
                raise DatasetError(
                    f'RayBatch field {name} has {value.shape[0]} rays, expected {n}')

    def __len__(self) -> int:
        return int(self.origins.shape[0])

    def _map(self, fn) -> 'RayBatch':
        return RayBatch(**{name: None if getattr(self, name) is None
                           else fn(getattr(self, name))
                           for name in _RAY_FIELDS})

    def __getitem__(self, idx) -> 'RayBatch':
        return self._map(lambda a: a[idx])

    def pad_to(self, size: int) -> 'RayBatch':
        """Pad with zero rays to a fixed ray count (static chunking)."""
        n = len(self)
        if n == size:
            return self
        if n > size:
            return self[:size]
        return self._map(lambda a: torch.cat(
            [a, a.new_zeros((size - n,) + tuple(a.shape[1:]))], 0))

    def replace(self, **kwargs) -> 'RayBatch':
        return dataclasses.replace(self, **kwargs)


@dataclass
class RayCollection:
    """RayBatch + per-view slices (reference: Datasets/utils.py:673-690)."""

    rays: RayBatch
    view_slices: list[tuple[int, int]]

    def rays_of_view(self, view_index: int) -> RayBatch:
        start, stop = self.view_slices[view_index]
        return self.rays[start:stop]


class View:
    """One observation: camera + pose + lazy image slots
    (reference: Datasets/utils.py:766-1086)."""

    def __init__(self, camera: BaseCamera, c2w: np.ndarray,
                 camera_index: int = 0, frame_idx: int = 0,
                 global_frame_idx: int | None = None,
                 timestamp: float = 0.0,
                 rgb: ImageData | None = None, alpha: ImageData | None = None):
        self.camera = camera
        self.c2w = c2w  # validated setter below
        self.camera_index = camera_index
        self.frame_idx = frame_idx
        self.global_frame_idx = frame_idx if global_frame_idx is None else global_frame_idx
        self.timestamp = float(timestamp)
        self.rgb_data = rgb if rgb is not None else ImageData()
        self.alpha_data = alpha if alpha is not None else ImageData()

    @property
    def c2w(self) -> np.ndarray:
        return self._c2w

    @c2w.setter
    def c2w(self, value: np.ndarray) -> None:
        value = np.asarray(value, dtype=np.float64)
        if value.shape == (3, 4):
            value = np.concatenate([value, np.array([[0., 0., 0., 1.]])], axis=0)
        if value.shape != (4, 4):
            raise DatasetError(f'c2w must be (4,4) or (3,4), got {value.shape}')
        self._c2w = value

    def prefetch(self) -> 'View':
        self.rgb_data.prefetch()
        self.alpha_data.prefetch()
        return self

    @property
    def rgb(self) -> Optional[np.ndarray]:
        return self.rgb_data.load()

    @property
    def alpha(self) -> Optional[np.ndarray]:
        return self.alpha_data.load()

    def get_rays(self, with_images: bool = True,
                 device: torch.device | str = 'cpu') -> RayBatch:
        """Full-image RayBatch on ``device`` (reference: utils.py:1053-1074)."""
        local_dirs = self.camera.local_ray_directions(device)
        origins, directions = generate_rays(
            torch.as_tensor(self._c2w, dtype=torch.float32, device=device),
            local_dirs)
        n = origins.shape[0]

        def image(data: ImageData):
            if not (with_images and data.exists()):
                return None
            return torch.as_tensor(data.load().reshape(n, -1),
                                   dtype=torch.float32, device=device)

        return RayBatch(
            origins=origins, directions=directions,
            view_directions=directions, rgb=image(self.rgb_data),
            alpha=image(self.alpha_data),
            timestamps=torch.full((n, 1), self.timestamp, device=device),
            pixel_ids=torch.arange(n, dtype=torch.int32, device=device)[:, None],
            view_ids=torch.full((n, 1), self.global_frame_idx,
                                dtype=torch.int32, device=device))

