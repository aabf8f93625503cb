"""Trajectory plugin base, a port of nerficg_tpu/visual/trajectories/base.py
(reference: src/Visual/Trajectories/utils.py:15-96)."""

from __future__ import annotations

import math

import numpy as np

from nerficg_torch.cameras.pose import look_at
from nerficg_torch.core.errors import VisualizationError
from nerficg_torch.data.types import View

__all__ = ['CameraTrajectory', 'lemniscate_poses']

_registry: dict[str, 'CameraTrajectory'] = {}


class CameraTrajectory:
    """Generates a list of Views and attaches them as a dataset subset
    (reference: Trajectories/utils.py:15-62)."""

    name: str = ''

    def __init_subclass__(cls, **kwargs):
        super().__init_subclass__(**kwargs)
        if cls.name:
            _registry[cls.name] = cls()

    @staticmethod
    def list_options() -> list[str]:
        return sorted(_registry)

    @staticmethod
    def get(name: str) -> 'CameraTrajectory':
        if name not in _registry:
            raise VisualizationError(
                f'unknown trajectory {name!r}; options: {sorted(_registry)}')
        return _registry[name]

    # -- plugin contract -------------------------------------------------------
    def generate(self, dataset, num_frames: int) -> list[View]:
        raise NotImplementedError

    # -- shared -----------------------------------------------------------------
    def add_to_dataset(self, dataset, num_frames: int = 120) -> None:
        views = self.generate(dataset, num_frames)
        for i, view in enumerate(views):
            view.frame_idx = i
        dataset.subsets[self.name] = views
        if self.name not in dataset.SUBSETS:
            dataset.SUBSETS = tuple(dataset.SUBSETS) + (self.name,)


def lemniscate_poses(center: np.ndarray, radius: float, num_frames: int,
                     height: float = 0.0, look_at_point: np.ndarray | None = None
                     ) -> list[np.ndarray]:
    """Figure-eight path (reference: Trajectories/utils.py:65-96)."""
    target = center if look_at_point is None else look_at_point
    poses = []
    for i in range(num_frames):
        t = 2 * math.pi * i / num_frames
        denom = 1 + math.sin(t) ** 2
        x = radius * math.cos(t) / denom
        z = radius * math.sin(t) * math.cos(t) / denom
        eye = center + np.array([x, height, z])
        poses.append(look_at(eye, target))
    return poses
