"""Dataset base class: views in subsets and the training ray pool, a port
of nerficg_tpu/data/base.py (reference: src/Datasets/Base.py:29-244).
Scene normalization and bounding boxes are not ported yet."""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from nerficg_torch.cameras.base import SharedCameraSettings
from nerficg_torch.core.config import ConfigNode, Configurable
from nerficg_torch.core.errors import DatasetError
from nerficg_torch.core.logging import Logger
from nerficg_torch.data.types import RayBatch, RayCollection, View

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
    """Loads views into train/test/val subsets (reference: Base.py:56-74)."""

    SUBSETS = ('train', 'test', 'val')

    def __init__(self, config: ConfigNode | None, path: str | None = None):
        super().__init__(config, 'DATASET')
        if self.NORMALIZE_RECENTER or self.NORMALIZE_CUBE:
            raise DatasetError('scene normalization is not ported yet')
        if path is not None:
            self.PATH = path
        self.path = Path(self.PATH)
        self.camera_settings = SharedCameraSettings(
            background_color=np.asarray(self.BACKGROUND_COLOR, np.float32),
            near=float(self.NEAR_PLANE), far=float(self.FAR_PLANE))
        self.subsets: dict[str, list[View]] = {s: [] for s in self.SUBSETS}

        start = time.perf_counter()
        self.load()
        Logger.info(f'{type(self).__name__}: loaded '
                    f'{ {s: len(v) for s, v in self.subsets.items()} } views in '
                    f'{time.perf_counter() - start:.2f}s')
        for i, view in enumerate(self.all_views()):
            view.global_frame_idx = i

    def load(self) -> None:
        """Populate ``self.subsets`` (reference: Datasets/Base.py:76-79)."""
        raise NotImplementedError

    def all_views(self) -> list[View]:
        return [v for s in self.SUBSETS for v in self.subsets[s]]

    def preload(self) -> None:
        """Decode every image now (reference: Trainer.py:122-161)."""
        for view in Logger.progress(self.all_views(), desc='preloading images'):
            view.prefetch()

    def precompute_rays(self, subset: str = 'train',
                        device: torch.device | str = 'cpu') -> RayCollection:
        """All rays of a subset in one RayBatch pool on ``device``
        (reference: Datasets/Base.py:172-216; nerficg_tpu/data/base.py:
        161-227). Views that share a camera are generated in one batched
        rotation over their stacked c2w matrices."""
        views = self.subsets[subset]
        if not views:
            raise DatasetError(f'no views in subset {subset!r}')
        camera = views[0].camera
        if not all(v.camera is camera for v in views):
            raise DatasetError('precompute_rays needs views that share one '
                               'camera; per-view cameras are not ported yet')
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

        rays = RayBatch(
            origins=o.reshape(-1, 3), directions=d.reshape(-1, 3),
            view_directions=d.reshape(-1, 3), rgb=stack_images('rgb'),
            alpha=stack_images('alpha'),
            timestamps=per_view([view.timestamp for view in views],
                                torch.float32),
            pixel_ids=torch.arange(n, dtype=torch.int32,
                                   device=device).repeat(v)[:, None],
            view_ids=per_view([view.global_frame_idx for view in views],
                              torch.int32))
        return RayCollection(rays, [(i * n, (i + 1) * n) for i in range(v)])

