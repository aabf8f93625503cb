"""RaR-Pano panorama dataset loader, ported from
nerficg_tpu/data/loaders/rar_pano.py (reference: src/Datasets/RaRPano.py:34):
Ricoh360's layout, plus an optional point cloud (POINT_CLOUD_FILE) for the
scene's bounds, and frame timestamps normalised over the capture."""

from __future__ import annotations

from nerficg_torch.core.config import Configurable
from nerficg_torch.core.registry import register_dataset
from nerficg_torch.data.loaders.ricoh360 import Ricoh360Dataset
from nerficg_torch.data.types import BasicPointCloud

__all__ = ['RaRPanoDataset']


@register_dataset('RaRPano')
@Configurable.configure(
    NEAR_PLANE=0.1,
    FAR_PLANE=50.0,
    POINT_CLOUD_FILE='points3d.ply',
)
class RaRPanoDataset(Ricoh360Dataset):

    def load(self) -> None:
        super().load()
        pcd_path = self.path / str(self.POINT_CLOUD_FILE)
        if pcd_path.is_file():
            self.point_cloud = BasicPointCloud.from_ply(pcd_path)
        views = self.all_views()
        if views:
            t_max = max(v.frame_idx for v in views) or 1
            for v in views:
                v.timestamp = v.frame_idx / t_max
