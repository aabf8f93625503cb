"""Core data model: lazy images, views, ray batches, point clouds, boxes.

Port of nerficg_tpu/data/types.py (reference: src/Datasets/utils.py
ImageData :693-763, View :766-1086, RayBatch :536-670, RayCollection
:673-690, BasicPointCloud :300-403, AxisAlignedBox :406-457). Images stay
numpy HWC on the host until a step consumes them; rays are generated on
the requested device.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from nerficg_torch.cameras.base import BaseCamera, generate_rays
from nerficg_torch.cameras.pose import invert_3d_affine
from nerficg_torch.core.errors import DatasetError
from nerficg_torch.data.io import load_image, resize_image

__all__ = ['ImageData', 'View', 'RayBatch', 'RayCollection',
           'BasicPointCloud', 'AxisAlignedBox']


@dataclass
class ImageData:
    """Lazy image handle: path + channel slice + scale factor; decoded on
    access (reference: Datasets/utils.py:693-763)."""

    path: Optional[Path] = None
    channels: Optional[slice] = None
    scale_factor: Optional[float] = None
    load_fn: Optional[Callable] = None
    data: Optional[np.ndarray] = None       # eager data (HWC float32)
    data_scale: float = 1.0                 # multiplicative rescale (depth units)
    _cache: Optional[np.ndarray] = field(default=None, repr=False)

    def exists(self) -> bool:
        return self.data is not None or (self.path is not None and Path(self.path).is_file())

    def prefetch(self) -> 'ImageData':
        """Decode now and keep the decoded image until ``release``
        (reference: ImageData.prefetch)."""
        if self.data is None and self._cache is None and self.path is not None:
            self._cache = self._decode()
        return self

    def release(self) -> None:
        self._cache = None

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
        elif self._cache is not None:
            out = self._cache
        else:
            if self.path is None:
                return None
            out = self._decode()
        if self.channels is not None:
            out = out[..., self.channels]
        if self.data_scale != 1.0:
            out = out * self.data_scale
        return out

    def update_data_scale(self, scale: float) -> None:
        """Multiply the values at load (depth under scene normalization;
        reference: Datasets/utils.py:756-763)."""
        self.data_scale *= scale


_RAY_FIELDS = ('origins', 'directions', 'view_directions', 'rgb', 'alpha',
               'depth', 'timestamps', 'pixel_ids', 'view_ids', 'radii')


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
    radii: Optional[torch.Tensor] = None    # (N, 1) cone base radii

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

    def split(self, chunk_size: int) -> list['RayBatch']:
        return [self[i:i + chunk_size] for i in range(0, len(self), chunk_size)]

    @staticmethod
    def cat(batches: Sequence['RayBatch']) -> 'RayBatch':
        """Concatenated along the rays; a field is None if any batch's is."""
        fields = {}
        for name in _RAY_FIELDS:
            values = [getattr(b, name) for b in batches]
            fields[name] = None if any(v is None for v in values) \
                else torch.cat(values, 0)
        return RayBatch(**fields)

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

    IMAGE_SLOTS = ('rgb', 'alpha', 'depth', 'segmentation',
                   'flow_fwd', 'flow_bwd', 'misc')

    def __init__(self, camera: BaseCamera, c2w: np.ndarray,
                 camera_index: int = 0, frame_idx: int = 0,
                 global_frame_idx: int | None = None,
                 timestamp: float = 0.0,
                 rgb: ImageData | None = None, alpha: ImageData | None = None,
                 depth: ImageData | None = None,
                 segmentation: ImageData | None = None,
                 flow_fwd: ImageData | None = None,
                 flow_bwd: ImageData | None = None,
                 misc: ImageData | None = None):
        self.camera = camera
        self.c2w = c2w  # validated setter below
        self.camera_index = camera_index
        self.frame_idx = frame_idx
        self.global_frame_idx = frame_idx if global_frame_idx is None else global_frame_idx
        self.timestamp = float(timestamp)
        slots = (rgb, alpha, depth, segmentation, flow_fwd, flow_bwd, misc)
        for slot, data in zip(self.IMAGE_SLOTS, slots):
            setattr(self, f'{slot}_data',
                    data if data is not None else ImageData())

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

    @property
    def w2c(self) -> np.ndarray:
        return invert_3d_affine(self._c2w)

    @property
    def position(self) -> np.ndarray:
        return self._c2w[:3, 3]

    def world_to_cam(self, points: np.ndarray) -> np.ndarray:
        w2c = self.w2c
        return points @ w2c[:3, :3].T + w2c[:3, 3]

    def cam_to_world(self, points: np.ndarray) -> np.ndarray:
        return points @ self._c2w[:3, :3].T + self._c2w[:3, 3]

    def project_points(self, points_world: np.ndarray) -> np.ndarray:
        """World points (M, 3) -> (px, py, depth) (M, 3), on the host
        (reference: utils.py:980-1005)."""
        return np.asarray(self.camera.cam_to_screen(
            np.asarray(self.world_to_cam(points_world), np.float32)))

    def unproject_points(self, pixels: np.ndarray,
                         depth: np.ndarray) -> np.ndarray:
        """Pixels (M, 2) at depths (M,) -> world points (M, 3)."""
        cam_pts = np.asarray(self.camera.screen_to_cam(
            np.asarray(pixels, np.float32), np.asarray(depth, np.float32)))
        return self.cam_to_world(cam_pts)

    def prefetch(self) -> 'View':
        for slot in self.IMAGE_SLOTS:
            getattr(self, f'{slot}_data').prefetch()
        return self

    def release_images(self) -> None:
        for slot in self.IMAGE_SLOTS:
            getattr(self, f'{slot}_data').release()

    @property
    def rgb(self) -> Optional[np.ndarray]:
        return self.rgb_data.load()

    @property
    def alpha(self) -> Optional[np.ndarray]:
        return self.alpha_data.load()

    @property
    def depth(self) -> Optional[np.ndarray]:
        return self.depth_data.load()

    @property
    def segmentation(self) -> Optional[np.ndarray]:
        return self.segmentation_data.load()

    @property
    def flow_fwd(self) -> Optional[np.ndarray]:
        return self.flow_fwd_data.load()

    @property
    def flow_bwd(self) -> Optional[np.ndarray]:
        return self.flow_bwd_data.load()

    @property
    def misc(self) -> Optional[np.ndarray]:
        return self.misc_data.load()

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
            alpha=image(self.alpha_data), depth=image(self.depth_data),
            timestamps=torch.full((n, 1), self.timestamp, device=device),
            pixel_ids=torch.arange(n, dtype=torch.int32, device=device)[:, None],
            view_ids=torch.full((n, 1), self.global_frame_idx,
                                dtype=torch.int32, device=device))

    def to_simple(self) -> 'View':
        """Camera/pose-only copy without image handles (the viewer's first
        view; reference: utils.py:1076-1086)."""
        return View(camera=self.camera, c2w=self._c2w.copy(),
                    camera_index=self.camera_index, frame_idx=self.frame_idx,
                    global_frame_idx=self.global_frame_idx,
                    timestamp=self.timestamp)


@dataclass
class BasicPointCloud:
    """Positions + colors (reference: Datasets/utils.py:300-403)."""

    positions: np.ndarray                       # (N, 3) float
    colors: Optional[np.ndarray] = None         # (N, 3) float in [0, 1]
    normals: Optional[np.ndarray] = None

    def __post_init__(self):
        self.positions = np.asarray(self.positions,
                                    dtype=np.float32).reshape(-1, 3)
        if self.colors is not None:
            self.colors = np.asarray(self.colors,
                                     dtype=np.float32).reshape(-1, 3)

    def __len__(self) -> int:
        return self.positions.shape[0]

    def transform(self, mat4: np.ndarray) -> 'BasicPointCloud':
        pos = self.positions @ mat4[:3, :3].T + mat4[:3, 3]
        return BasicPointCloud(pos, self.colors, self.normals)

    def filter_outliers(self, quantile: float = 0.97) -> 'BasicPointCloud':
        """Drop points far from the median (reference: utils.py:352-367)."""
        center = np.median(self.positions, axis=0)
        dist = np.linalg.norm(self.positions - center, axis=-1)
        keep = dist <= np.quantile(dist, quantile)
        return BasicPointCloud(
            self.positions[keep],
            None if self.colors is None else self.colors[keep],
            None if self.normals is None else self.normals[keep])

    def get_aabb(self) -> 'AxisAlignedBox':
        return AxisAlignedBox(np.stack([self.positions.min(0),
                                        self.positions.max(0)]))

    @staticmethod
    def from_ply(path: str | Path) -> 'BasicPointCloud':
        from nerficg_torch.data.ply import read_ply_pointcloud
        return read_ply_pointcloud(path)

    def save_ply(self, path: str | Path) -> None:
        from nerficg_torch.data.ply import write_ply_pointcloud
        write_ply_pointcloud(self, path)


@dataclass
class AxisAlignedBox:
    """(2, 3) min/max box (reference: Datasets/utils.py:406-457)."""

    bounds: np.ndarray

    def __post_init__(self):
        self.bounds = np.asarray(self.bounds, dtype=np.float32).reshape(2, 3)
        if np.any(self.bounds[0] > self.bounds[1]):
            raise DatasetError(f'invalid AABB: min > max in {self.bounds}')

    @property
    def min(self) -> np.ndarray:
        return self.bounds[0]

    @property
    def max(self) -> np.ndarray:
        return self.bounds[1]

    @property
    def center(self) -> np.ndarray:
        return 0.5 * (self.bounds[0] + self.bounds[1])

    @property
    def size(self) -> np.ndarray:
        return self.bounds[1] - self.bounds[0]

    def transform(self, mat4: np.ndarray) -> 'AxisAlignedBox':
        """The box around the transformed corners."""
        corners = np.stack(np.meshgrid(*zip(self.bounds[0], self.bounds[1]),
                                       indexing='ij'), axis=-1).reshape(-1, 3)
        corners = corners @ mat4[:3, :3].T + mat4[:3, 3]
        return AxisAlignedBox(np.stack([corners.min(0), corners.max(0)]))

    def cube(self) -> 'AxisAlignedBox':
        """Smallest enclosing cube (reference: utils.py:440-448)."""
        half = self.size.max() * 0.5
        return AxisAlignedBox(np.stack([self.center - half,
                                        self.center + half]))
