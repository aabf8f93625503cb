"""D-NeRF dataset loader: the Blender (NeRF) format with a ``time`` per frame,
ported from nerficg_tpu/data/loaders/dnerf.py (reference:
src/Datasets/DNeRF.py:22-89). Timestamps are normalised by their maximum
over all splits to [0, 1]; the background is white."""

from __future__ import annotations

import json

import numpy as np
from PIL import Image

from nerficg_torch.cameras.perspective import PerspectiveCamera
from nerficg_torch.cameras.pose import fov_to_focal
from nerficg_torch.core.config import Configurable
from nerficg_torch.core.errors import DatasetError
from nerficg_torch.core.registry import register_dataset
from nerficg_torch.data.loaders.nerf import NeRFDataset, opengl_to_colmap
from nerficg_torch.data.types import ImageData, View

__all__ = ['DNeRFDataset']


@register_dataset('DNeRF')
@Configurable.configure(
    NEAR_PLANE=2.0,
    FAR_PLANE=6.0,
    BACKGROUND_COLOR=[1.0, 1.0, 1.0],
)
class DNeRFDataset(NeRFDataset):

    def load(self) -> None:
        if not self.path.is_dir():
            raise DatasetError(f'D-NeRF dataset path not found: {self.path}')
        cameras: dict[tuple, PerspectiveCamera] = {}
        staged = []
        for subset, filename in self.SPLIT_FILES.items():
            meta_path = self.path / filename
            if not meta_path.is_file():
                continue
            with open(meta_path) as f:
                meta = json.load(f)
            for frame_idx, frame in enumerate(meta['frames']):
                img_path = self.path / frame['file_path'].lstrip('./')
                if not img_path.suffix:
                    img_path = img_path.with_suffix('.png')
                if not img_path.is_file():
                    continue
                with Image.open(img_path) as img:
                    width, height = img.size
                scale = self.IMAGE_SCALE_FACTOR
                if scale:
                    width = max(int(round(width * scale)), 1)
                    height = max(int(round(height * scale)), 1)
                focal = fov_to_focal(float(meta['camera_angle_x']), width)
                key = (width, height, focal)
                if key not in cameras:
                    cameras[key] = PerspectiveCamera(
                        width=width, height=height, focal_x=focal,
                        focal_y=focal, settings=self.camera_settings)
                staged.append((subset, View(
                    camera=cameras[key],
                    c2w=opengl_to_colmap(np.asarray(frame['transform_matrix'])),
                    frame_idx=frame_idx,
                    timestamp=float(frame.get('time', 0.0)),
                    rgb=ImageData(path=img_path, channels=slice(0, 3),
                                  scale_factor=scale),
                    alpha=ImageData(path=img_path, channels=slice(3, 4),
                                    scale_factor=scale))))
        if not staged:
            raise DatasetError(f'no views found in {self.path}')
        # Normalise the timestamps to [0, 1] (reference: DNeRF.py:70-80).
        t_max = max(view.timestamp for _, view in staged) or 1.0
        for subset, view in staged:
            view.timestamp = view.timestamp / t_max
            self.subsets[subset].append(view)
