"""Ricoh360 panorama dataset loader, ported from
nerficg_tpu/data/loaders/ricoh360.py (reference: src/Datasets/Ricoh360.py:18):
OmniBlender's transforms-json equirectangular layout, captured with a Ricoh
Theta; without a transforms_test.json every TEST_STEP-th training frame
(the first included) becomes a test view."""

from __future__ import annotations

from nerficg_torch.core.config import Configurable
from nerficg_torch.core.registry import register_dataset
from nerficg_torch.data.loaders.omni_blender import OmniBlenderDataset

__all__ = ['Ricoh360Dataset']


@register_dataset('Ricoh360')
@Configurable.configure(
    NEAR_PLANE=0.1,
    FAR_PLANE=50.0,
    TEST_STEP=8,
)
class Ricoh360Dataset(OmniBlenderDataset):

    def load(self) -> None:
        super().load()
        step = int(self.TEST_STEP)
        if not self.subsets['test'] and step > 0:
            train = self.subsets['train']
            self.subsets['test'] = train[::step]
            self.subsets['train'] = [v for i, v in enumerate(train)
                                     if i % step != 0]
