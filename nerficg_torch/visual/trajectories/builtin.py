"""The seven built-in camera trajectories, a port of
nerficg_tpu/visual/trajectories/builtin.py.

Reference equivalents (src/Visual/Trajectories/):
  ellipse_path (Ellipse.py:16, Zip-NeRF ellipse), spiral_path (SpiralPath.py:16,
  LLFF-style), bullet_time (BulletTime.py:12), novel_view (NovelView.py:12,
  lemniscate at frozen time), fixed_view (FixedView.py:10, time replay),
  fancy_zoom (FancyZoom.py:13), stabilized_path (StabilizedPath.py:10,
  sliding-window pose smoothing).
"""

from __future__ import annotations

import math

import numpy as np

from nerficg_torch.cameras.pose import average_pose, look_at
from nerficg_torch.data.types import View
from nerficg_torch.visual.trajectories.base import CameraTrajectory, lemniscate_poses

__all__ = ['EllipsePath', 'SpiralPath', 'BulletTime', 'NovelView', 'FixedView',
           'FancyZoom', 'StabilizedPath']


def _train_views(dataset) -> list[View]:
    views = dataset.subsets['train']
    if not views:
        raise ValueError('trajectory generation needs training views')
    return views


def _scene_center(dataset) -> np.ndarray:
    if dataset.bounding_box is not None:
        return dataset.bounding_box.center.astype(np.float64)
    positions = np.stack([v.position for v in _train_views(dataset)])
    return positions.mean(0)


def _mean_radius(dataset, center) -> float:
    positions = np.stack([v.position for v in _train_views(dataset)])
    return float(np.linalg.norm(positions - center, axis=-1).mean())


def _timestamps(dataset, num_frames):
    stamps = sorted({v.timestamp for v in _train_views(dataset)})
    if len(stamps) <= 1:
        return [stamps[0] if stamps else 0.0] * num_frames
    return list(np.interp(np.linspace(0, len(stamps) - 1, num_frames),
                          np.arange(len(stamps)), stamps))


class EllipsePath(CameraTrajectory):
    """Zip-NeRF-style ellipse through the camera distribution
    (reference: Ellipse.py:16)."""

    name = 'ellipse_path'

    def generate(self, dataset, num_frames: int) -> list[View]:
        views = _train_views(dataset)
        positions = np.stack([v.position for v in views])
        center = _scene_center(dataset)
        offsets = positions - center
        # Ellipse axes from the 10/90 percentiles of the offsets.
        radii = np.percentile(np.abs(offsets), 90, axis=0)
        height = float(np.median(offsets[:, 1]))
        camera = views[0].camera
        stamps = _timestamps(dataset, num_frames)
        out = []
        for i in range(num_frames):
            t = 2 * math.pi * i / num_frames
            eye = center + np.array([radii[0] * math.cos(t), height,
                                     radii[2] * math.sin(t)])
            out.append(View(camera=camera, c2w=look_at(eye, center),
                            timestamp=stamps[i]))
        return out


class SpiralPath(CameraTrajectory):
    """LLFF-style spiral around the average pose (reference: SpiralPath.py:16)."""

    name = 'spiral_path'

    def generate(self, dataset, num_frames: int) -> list[View]:
        views = _train_views(dataset)
        c2ws = np.stack([v.c2w for v in views])
        avg = average_pose(c2ws)
        positions = c2ws[:, :3, 3]
        radii = np.percentile(np.abs(positions - avg[:3, 3]), 80, axis=0) * 0.6
        focus_depth = _mean_radius(dataset, _scene_center(dataset))
        camera = views[0].camera
        stamps = _timestamps(dataset, num_frames)
        out = []
        for i in range(num_frames):
            t = 4 * math.pi * i / num_frames  # two loops
            offset = np.array([radii[0] * math.cos(t), radii[1] * math.sin(t),
                               radii[2] * math.sin(t * 0.5)])
            eye = avg[:3, 3] + avg[:3, :3] @ offset
            target = avg[:3, 3] + avg[:3, :3] @ np.array([0, 0, focus_depth])
            out.append(View(camera=camera, c2w=look_at(eye, target),
                            timestamp=stamps[i]))
        return out


class BulletTime(CameraTrajectory):
    """Orbit at a frozen timestamp around the scene (reference: BulletTime.py:12)."""

    name = 'bullet_time'
    frozen_fraction = 0.5

    def generate(self, dataset, num_frames: int) -> list[View]:
        views = _train_views(dataset)
        stamps = sorted({v.timestamp for v in views})
        frozen = stamps[int(self.frozen_fraction * (len(stamps) - 1))]
        center = _scene_center(dataset)
        radius = _mean_radius(dataset, center)
        camera = views[0].camera
        out = []
        for i in range(num_frames):
            t = 2 * math.pi * i / num_frames
            eye = center + radius * np.array([math.sin(t), 0.0, math.cos(t)])
            out.append(View(camera=camera, c2w=look_at(eye, center),
                            timestamp=frozen))
        return out


class NovelView(CameraTrajectory):
    """Lemniscate path at frozen time (reference: NovelView.py:12)."""

    name = 'novel_view'

    def generate(self, dataset, num_frames: int) -> list[View]:
        views = _train_views(dataset)
        center = _scene_center(dataset)
        radius = _mean_radius(dataset, center)
        poses = lemniscate_poses(center + np.array([0, 0, -radius]),
                                 radius * 0.5, num_frames,
                                 look_at_point=center)
        camera = views[0].camera
        frozen = views[len(views) // 2].timestamp
        return [View(camera=camera, c2w=c2w, timestamp=frozen) for c2w in poses]


class FixedView(CameraTrajectory):
    """Static camera replaying the timeline (reference: FixedView.py:10)."""

    name = 'fixed_view'

    def generate(self, dataset, num_frames: int) -> list[View]:
        views = _train_views(dataset)
        anchor = views[len(views) // 2]
        stamps = _timestamps(dataset, num_frames)
        return [View(camera=anchor.camera, c2w=anchor.c2w.copy(), timestamp=s)
                for s in stamps]


class FancyZoom(CameraTrajectory):
    """Dolly zoom toward the scene center (reference: FancyZoom.py:13)."""

    name = 'fancy_zoom'

    def generate(self, dataset, num_frames: int) -> list[View]:
        views = _train_views(dataset)
        anchor = views[len(views) // 2]
        center = _scene_center(dataset)
        eye0 = anchor.position
        direction = center - eye0
        stamps = _timestamps(dataset, num_frames)
        out = []
        for i in range(num_frames):
            # Smooth in-out zoom to 40% of the distance.
            s = 0.4 * 0.5 * (1 - math.cos(2 * math.pi * i / num_frames))
            eye = eye0 + direction * s
            out.append(View(camera=anchor.camera, c2w=look_at(eye, center),
                            timestamp=stamps[i]))
        return out


class StabilizedPath(CameraTrajectory):
    """Sliding-window smoothing of the training path
    (reference: StabilizedPath.py:10)."""

    name = 'stabilized_path'
    window = 7

    def generate(self, dataset, num_frames: int) -> list[View]:
        views = sorted(_train_views(dataset), key=lambda v: v.frame_idx)
        n = len(views)
        half = self.window // 2
        out = []
        for i in range(n):
            lo, hi = max(0, i - half), min(n, i + half + 1)
            positions = np.stack([v.position for v in views[lo:hi]])
            forwards = np.stack([v.c2w[:3, 2] for v in views[lo:hi]])
            eye = positions.mean(0)
            forward = forwards.mean(0)
            forward /= np.linalg.norm(forward)
            out.append(View(camera=views[i].camera,
                            c2w=look_at(eye, eye + forward),
                            timestamp=views[i].timestamp))
        return out
