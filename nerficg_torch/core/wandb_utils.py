"""wandb experiment tracking: optional, inactive when wandb is unavailable.

Port of nerficg_tpu/core/wandb_utils.py (reference: Framework.setup_wandb,
src/Framework.py:291-308, and the trainer's loss, image and sweep logging,
src/Methods/Base/Trainer.py:308-395). Images and point clouds arrive as
numpy arrays on the host.
"""

from __future__ import annotations

from typing import Any, Optional

import numpy as np

from nerficg_torch.core.logging import Logger

__all__ = ['WandbSession']


class WandbSession:
    """Thin wrapper: init/log/finish, inactive (with a warning) without
    wandb or when its init fails."""

    def __init__(self, config: Optional[dict] = None,
                 project: str = 'nerficg_tpu',
                 run_name: Optional[str] = None, active: bool = True):
        self._run = None
        if not active:
            return
        try:
            import wandb
            self._run = wandb.init(project=project, name=run_name,
                                   config=config or {})
            Logger.info(f'wandb run: {self._run.url}')
        except ImportError:
            Logger.warning('wandb not installed; experiment tracking disabled')
        except Exception as exc:  # offline/env errors must not kill training
            Logger.warning(f'wandb init failed: {exc}')

    @property
    def active(self) -> bool:
        return self._run is not None

    def log(self, metrics: dict[str, Any], step: Optional[int] = None) -> None:
        if self._run is not None:
            self._run.log(metrics, step=step)

    def log_image(self, key: str, image: np.ndarray,
                  step: Optional[int] = None) -> None:
        if self._run is not None:
            import wandb
            self._run.log({key: wandb.Image(image)}, step=step)

    def log_point_cloud(self, key: str, points: np.ndarray,
                        colors: np.ndarray | None = None,
                        step: Optional[int] = None,
                        max_points: int = 65536) -> None:
        """3D point-cloud panel (wandb.Object3D): the occupancy grid and the
        Gaussians' means (reference: src/Methods/InstantNGP/utils.py:20-64,
        src/Methods/GaussianSplatting/Trainer.py:133-140). Above
        ``max_points`` a seeded subset is logged."""
        if self._run is None:
            return
        import wandb
        pts = np.asarray(points, np.float32).reshape(-1, 3)
        cols = None if colors is None else np.asarray(colors,
                                                      np.float32)[:, :3]
        if pts.shape[0] > max_points:
            idx = np.random.default_rng(0).choice(pts.shape[0], max_points,
                                                  replace=False)
            pts = pts[idx]
            cols = None if cols is None else cols[idx]
        if cols is not None:
            pts = np.concatenate([pts, np.clip(cols * 255.0, 0, 255)], axis=1)
        self._run.log({key: wandb.Object3D(pts)}, step=step)

    def finish(self) -> None:
        if self._run is not None:
            self._run.finish()
            self._run = None
