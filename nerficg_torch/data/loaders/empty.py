"""Camera-only 'Empty' dataset: one default camera and no images, a port
of nerficg_tpu/data/loaders/empty.py (reference: src/Datasets/Empty.py:14-35):
what a checkpoint is viewed with when no dataset is on disk.
"""

from __future__ import annotations

import numpy as np

from nerficg_torch.cameras.perspective import PerspectiveCamera
from nerficg_torch.core.config import Configurable
from nerficg_torch.core.registry import register_dataset
from nerficg_torch.data.base import BaseDataset
from nerficg_torch.data.types import View

__all__ = ['EmptyDataset']


@register_dataset('Empty')
@Configurable.configure(
    WIDTH=800,
    HEIGHT=800,
    NEAR_PLANE=0.1,
    FAR_PLANE=10.0,
)
class EmptyDataset(BaseDataset):

    def load(self) -> None:
        camera = PerspectiveCamera(width=int(self.WIDTH), height=int(self.HEIGHT),
                                   settings=self.camera_settings)
        c2w = np.eye(4)
        c2w[2, 3] = -3.0  # back the camera off the origin
        self.subsets['train'].append(View(camera=camera, c2w=c2w))
