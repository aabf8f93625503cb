"""Dataset base class: views in subsets, scene normalization, the training
ray pool, the point cloud and the scene's bounding box, a port of
nerficg_tpu/data/base.py (reference: src/Datasets/Base.py:29-244)."""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from nerficg_torch.cameras.base import SharedCameraSettings
from nerficg_torch.cameras.pose import (recenter_poses,
                                        rescale_poses_to_unit_cube)
from nerficg_torch.core.config import ConfigNode, Configurable
from nerficg_torch.core.errors import DatasetError
from nerficg_torch.core.logging import Logger
from nerficg_torch.data.types import (AxisAlignedBox, BasicPointCloud,
                                      RayBatch, RayCollection, View)

__all__ = ['BaseDataset']


@Configurable.configure(
    PATH='',
    IMAGE_SCALE_FACTOR=None,
    NORMALIZE_CUBE=False,
    NORMALIZE_RECENTER=False,
    BACKGROUND_COLOR=[0.0, 0.0, 0.0],
    NEAR_PLANE=0.01,
    FAR_PLANE=100.0,
)
class BaseDataset(Configurable):
    """Loads views into train/test/val subsets (reference: Base.py:56-74),
    optionally normalizes the scene into the unit cube, and estimates its
    bounding box."""

    SUBSETS = ('train', 'test', 'val')

    def __init__(self, config: ConfigNode | None, path: str | None = None):
        super().__init__(config, 'DATASET')
        if path is not None:
            self.PATH = path
        self.path = Path(self.PATH)
        self.camera_settings = SharedCameraSettings(
            background_color=np.asarray(self.BACKGROUND_COLOR, np.float32),
            near=float(self.NEAR_PLANE), far=float(self.FAR_PLANE))
        self.subsets: dict[str, list[View]] = {s: [] for s in self.SUBSETS}
        self.mode: str = 'train'
        self.point_cloud: BasicPointCloud | None = None
        self.bounding_box: AxisAlignedBox | None = None
        self._applied_transform = np.eye(4)

        start = time.perf_counter()
        self.load()
        Logger.info(f'{type(self).__name__}: loaded '
                    f'{ {s: len(v) for s, v in self.subsets.items()} } views in '
                    f'{time.perf_counter() - start:.2f}s')
        for i, view in enumerate(self.all_views()):
            view.global_frame_idx = i
        if self.NORMALIZE_RECENTER or self.NORMALIZE_CUBE:
            self.normalize_scene()
        if self.bounding_box is None:
            self.bounding_box = self.estimate_bounding_box()

    def load(self) -> None:
        """Populate ``self.subsets`` (reference: Datasets/Base.py:76-79)."""
        raise NotImplementedError

    def set_mode(self, mode: str) -> 'BaseDataset':
        """Select the subset that ``views``, ``len`` and indexing read
        (reference: Datasets/Base.py:56-74)."""
        if mode not in self.SUBSETS:
            raise DatasetError(f'unknown subset {mode!r}; expected {self.SUBSETS}')
        self.mode = mode
        return self

    @property
    def views(self) -> list[View]:
        return self.subsets[self.mode]

    def train(self) -> 'BaseDataset':
        return self.set_mode('train')

    def test(self) -> 'BaseDataset':
        return self.set_mode('test')

    def val(self) -> 'BaseDataset':
        return self.set_mode('val')

    def __len__(self) -> int:
        return len(self.views)

    def __getitem__(self, idx: int) -> View:
        return self.views[idx]

    def all_views(self) -> list[View]:
        return [v for s in self.SUBSETS for v in self.subsets[s]]

    def estimate_bounding_box(self) -> AxisAlignedBox:
        """From the point cloud if there is one, else from the cameras'
        positions and far-plane frustum corners (reference:
        Datasets/Base.py:144-170; nerficg_tpu/data/base.py:108-126)."""
        if self.point_cloud is not None and len(self.point_cloud) > 0:
            return self.point_cloud.filter_outliers().get_aabb()
        views = self.all_views()
        if not views:
            return AxisAlignedBox(np.array([[-1.0, -1.0, -1.0],
                                            [1.0, 1.0, 1.0]]))
        points = []
        for view in views:
            points.append(view.position)
            cam = view.camera
            corners = np.array([[0, 0], [cam.width, 0], [0, cam.height],
                                [cam.width, cam.height]], np.float32)
            points.append(view.unproject_points(
                corners, np.full(4, cam.far, np.float32)))
        points = np.concatenate([np.atleast_2d(p) for p in points], axis=0)
        return AxisAlignedBox(np.stack([points.min(0), points.max(0)]))

    def normalize_scene(self) -> None:
        """Recenter and/or rescale every pose, the planes, the bounding box
        and the point cloud into the unit cube (reference:
        Datasets/Base.py:218-244; nerficg_tpu/data/base.py:128-158)."""
        views = self.all_views()
        if not views:
            return
        c2ws = np.stack([v.c2w for v in views])
        transform = np.eye(4)
        if self.NORMALIZE_RECENTER:
            c2ws, t = recenter_poses(c2ws)
            transform = t @ transform
        scale = 1.0
        if self.NORMALIZE_CUBE:
            aabb = None if self.point_cloud is None else \
                self.point_cloud.filter_outliers().get_aabb().bounds
            c2ws, t = rescale_poses_to_unit_cube(c2ws, aabb=aabb)
            scale = float(t[0, 0])
            transform = t @ transform
        for view, c2w in zip(views, c2ws):
            view.c2w = c2w
            if view.depth_data.exists():
                view.depth_data.update_data_scale(scale)
        if scale != 1.0:
            self.camera_settings.near *= scale
            self.camera_settings.far *= scale
        if self.point_cloud is not None:
            self.point_cloud = self.point_cloud.transform(transform)
        if self.bounding_box is not None:
            self.bounding_box = self.bounding_box.transform(transform)
        self._applied_transform = transform

    def preload(self) -> None:
        """Decode every image now (reference: Trainer.py:122-161)."""
        for view in Logger.progress(self.all_views(), desc='preloading images'):
            view.prefetch()

    def precompute_rays(self, subset: str = 'train',
                        device: torch.device | str = 'cpu',
                        radii: bool = False) -> RayCollection:
        """All rays of a subset in one RayBatch pool on ``device``, in view
        order, each view's slice in ``view_slices`` (reference:
        Datasets/Base.py:172-216; nerficg_tpu/data/base.py:161-227). Views
        that share a camera are generated in one batched rotation over
        their stacked c2w matrices (``_shared_camera_rays``); views with
        different cameras, one such rotation per camera, then one gather
        per field into view order (``_grouped_rays``). With ``radii`` the
        pool also holds each ray's cone base radius
        (``BaseCamera.local_ray_radii``), which Mip-NeRF 360 reads."""
        views = self.subsets[subset]
        if not views:
            raise DatasetError(f'no views in subset {subset!r}')
        groups: dict[int, list[int]] = {}
        for i, view in enumerate(views):
            groups.setdefault(id(view.camera), []).append(i)
        if len(groups) == 1:
            rays = self._shared_camera_rays(views, device, radii)
        else:
            rays = self._grouped_rays(views, list(groups.values()), device,
                                      radii)
        bounds = np.cumsum([0] + [v.camera.width * v.camera.height
                                  for v in views]).tolist()
        return RayCollection(rays, list(zip(bounds[:-1], bounds[1:])))

    @staticmethod
    def _shared_camera_rays(views: list[View], device: torch.device | str,
                            radii: bool = False) -> RayBatch:
        """The rays of ``views``, which share one camera, in their order."""
        camera = views[0].camera
        local = camera.local_ray_directions(device)             # (N, 3)
        c2w = torch.as_tensor(np.stack([v.c2w for v in views]),
                              dtype=torch.float32, device=device)
        d = torch.einsum('nj,vij->vni', local, c2w[:, :3, :3])
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        o = c2w[:, None, :3, 3].expand(d.shape)
        v, n = len(views), camera.width * camera.height

        def stack_images(slot: str):
            data = [getattr(view, f'{slot}_data') for view in views]
            if not all(image.exists() for image in data):
                return None
            host = np.stack([image.load().reshape(n, -1) for image in data])
            return torch.as_tensor(host.reshape(v * n, -1),
                                   dtype=torch.float32, device=device)

        def per_view(values, dtype):
            return torch.as_tensor(np.repeat(np.asarray(values), n)[:, None],
                                   dtype=dtype, device=device)

        return RayBatch(
            origins=o.reshape(-1, 3), directions=d.reshape(-1, 3),
            view_directions=d.reshape(-1, 3), rgb=stack_images('rgb'),
            alpha=stack_images('alpha'), depth=stack_images('depth'),
            timestamps=per_view([view.timestamp for view in views],
                                torch.float32),
            pixel_ids=torch.arange(n, dtype=torch.int32,
                                   device=device).repeat(v)[:, None],
            view_ids=per_view([view.global_frame_idx for view in views],
                              torch.int32),
            radii=camera.local_ray_radii(device).repeat(v)[:, None]
            if radii else None)

    @classmethod
    def _grouped_rays(cls, views: list[View], groups: list[list[int]],
                      device: torch.device | str,
                      radii: bool = False) -> RayBatch:
        """The rays of ``views`` with different cameras: each group of view
        indices (one camera) through ``_shared_camera_rays``, the groups
        concatenated, then gathered into view order. A field is None unless
        every view has it."""
        rays = RayBatch.cat([cls._shared_camera_rays(
            [views[i] for i in group], device, radii) for group in groups])
        counts = [v.camera.width * v.camera.height for v in views]
        starts, offset = [0] * len(views), 0
        for group in groups:
            for i in group:
                starts[i] = offset
                offset += counts[i]
        order = np.concatenate([np.arange(start, start + count)
                                for start, count in zip(starts, counts)])
        return rays[torch.as_tensor(order, device=device)]
