"""Plenoptic-video dataset loader, ported from
nerficg_tpu/data/loaders/plenoptic_video_blender.py (reference:
src/Datasets/PlenopticVideoBlender.py:18): the D-NeRF json format, with
timestamps capped at MAX_TIMESTAMP for sequences whose time does not span
[0, 1]."""

from __future__ import annotations

from nerficg_torch.core.config import Configurable
from nerficg_torch.core.registry import register_dataset
from nerficg_torch.data.loaders.dnerf import DNeRFDataset

__all__ = ['PlenopticVideoBlenderDataset']


@register_dataset('PlenopticVideoBlender')
@Configurable.configure(
    MAX_TIMESTAMP=1.0,
    NEAR_PLANE=0.1,
    FAR_PLANE=20.0,
    BACKGROUND_COLOR=[0.0, 0.0, 0.0],
)
class PlenopticVideoBlenderDataset(DNeRFDataset):

    def load(self) -> None:
        super().load()
        cap = float(self.MAX_TIMESTAMP)
        if cap > 0:
            for view in self.all_views():
                view.timestamp = min(view.timestamp, cap)
