"""COLMAP reconstruction dataset loader, a port of
nerficg_tpu/data/loaders/colmap.py (reference: src/Datasets/Colmap.py:20-174):
a sparse model's cameras (the six models of ``ColmapCamera.intrinsics``)
with their distortion, optional masks and monocular depth, Zip-NeRF PCA
pose alignment, the SfM point cloud and an every-Nth test split.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from nerficg_torch.cameras.distortion import RadialTangentialDistortion
from nerficg_torch.cameras.perspective import PerspectiveCamera
from nerficg_torch.cameras.pose import transform_poses_pca
from nerficg_torch.core.config import Configurable
from nerficg_torch.core.errors import DatasetError
from nerficg_torch.core.registry import register_dataset
from nerficg_torch.data.base import BaseDataset
from nerficg_torch.data.colmap_model import read_colmap_model
from nerficg_torch.data.io import resize_image
from nerficg_torch.data.types import BasicPointCloud, ImageData, View

__all__ = ['ColmapDataset']


@register_dataset('Colmap')
@Configurable.configure(
    TEST_STEP=8,                  # every Nth image -> test split (0 = none)
    IMAGE_DIR='images',
    MODEL_DIR=None,               # default: sparse/0 or sparse
    NORMALIZE_PCA=True,
    LOAD_MASKS=False,
    MASK_DIR='masks',
    LOAD_DEPTH=False,
    DEPTH_DIR='depth',
    NEAR_PLANE=0.01,
    FAR_PLANE=100.0,
)
class ColmapDataset(BaseDataset):

    def _model_dir(self) -> Path:
        if self.MODEL_DIR:
            return self.path / self.MODEL_DIR
        for candidate in ('sparse/0', 'sparse', 'colmap/sparse/0'):
            if (self.path / candidate).is_dir():
                return self.path / candidate
        raise DatasetError(f'no COLMAP sparse model under {self.path}')

    def load(self) -> None:
        cameras_raw, images_raw, (pts, cols) = read_colmap_model(
            self._model_dir())
        image_dir = self.path / str(self.IMAGE_DIR)
        scale = self.IMAGE_SCALE_FACTOR

        cameras: dict[int, PerspectiveCamera] = {}
        for cam_id, cam in cameras_raw.items():
            intr = cam.intrinsics()
            s = scale or 1.0
            dist = intr['distortion']
            cameras[cam_id] = PerspectiveCamera(
                width=max(int(round(cam.width * s)), 1),
                height=max(int(round(cam.height * s)), 1),
                focal_x=intr['focal_x'] * s, focal_y=intr['focal_y'] * s,
                center_x=intr['center_x'] * s, center_y=intr['center_y'] * s,
                distortion=(RadialTangentialDistortion.from_colmap(dist)
                            if dist else None),
                settings=self.camera_settings)

        ordered = sorted(images_raw.values(), key=lambda im: im.name)
        test_step = int(self.TEST_STEP)
        for idx, image in enumerate(ordered):
            img_path = image_dir / image.name
            if not img_path.is_file():
                continue
            view = View(camera=cameras[image.camera_id], c2w=image.c2w(),
                        camera_index=image.camera_id, frame_idx=idx,
                        rgb=ImageData(path=img_path, channels=slice(0, 3),
                                      scale_factor=scale))
            if self.LOAD_MASKS:
                mask = self.path / str(self.MASK_DIR) / \
                    (Path(image.name).stem + '.png')
                if mask.is_file():
                    view.alpha_data = ImageData(path=mask,
                                                channels=slice(0, 1),
                                                scale_factor=scale)
            if self.LOAD_DEPTH:
                depth = self.path / str(self.DEPTH_DIR) / \
                    (Path(image.name).stem + '.npy')
                if depth.is_file():
                    view.depth_data = ImageData(
                        path=depth, load_fn=self._load_npy_depth,
                        scale_factor=scale)
            subset = ('test' if test_step > 0 and idx % test_step == 0
                      else 'train')
            self.subsets[subset].append(view)

        if pts is not None and len(pts):
            self.point_cloud = BasicPointCloud(pts, cols)

        if not any(self.subsets.values()):
            raise DatasetError(f'no images found under {image_dir}')

        if self.NORMALIZE_PCA:
            self._apply_pca_alignment()

    def _apply_pca_alignment(self) -> None:
        """Zip-NeRF-style ground-plane alignment (reference: Colmap.py:120-140);
        near and far scale by the transform's cube-root determinant."""
        views = self.all_views()
        c2ws = np.stack([v.c2w for v in views])
        aligned, transform = transform_poses_pca(c2ws)
        for view, c2w in zip(views, aligned):
            view.c2w = c2w
        if self.point_cloud is not None:
            self.point_cloud = self.point_cloud.transform(transform)
        scale = float(np.cbrt(max(np.linalg.det(transform[:3, :3]), 1e-12)))
        self.camera_settings.near *= scale
        self.camera_settings.far *= scale

    @staticmethod
    def _load_npy_depth(path, scale_factor=None):
        depth = np.load(path).astype(np.float32)
        if depth.ndim == 2:
            depth = depth[..., None]
        if scale_factor and scale_factor != 1.0:
            depth = resize_image(depth, scale_factor)
        return depth
