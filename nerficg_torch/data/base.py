"""Dataset base class: views in subsets, ported from
nerficg_tpu/data/base.py (the part the serving path uses; reference:
src/Datasets/Base.py:29-244). Scene normalization, bounding boxes and ray
precompute belong to training and come with it."""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np

from nerficg_torch.cameras.base import SharedCameraSettings
from nerficg_torch.core.config import ConfigNode, Configurable
from nerficg_torch.core.errors import DatasetError
from nerficg_torch.core.logging import Logger
from nerficg_torch.data.types import View

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

