"""Per-frame and per-camera photometric ISP correction (PPISP), ported from
nerficg_tpu/optim/ppisp.py (reference: src/Optim/ppisp.py:16-141, a
wrapper around nv-tlabs' ppisp package): camera and frame bookkeeping
sorted by camera, an optimiser and its schedule, checkpoint extra state, a
text report, and the correction applied to a rendered image by its view's
camera and frame. The correction's stages, each initialised to the
identity so that an untrained PPISP changes nothing:

  1. per-frame exposure (a gain, log-parameterised)
  2. per-frame white balance (r and b gains, g fixed)
  3. per-camera 3x3 colour-correction matrix
  4. per-camera radial vignetting  1 + k1 r^2 + k2 r^4  (normalised radius)
  5. per-camera gamma (log-parameterised)

The parameters are leaf tensors on the caller's device; the optimiser is
Adam under optax's ``cosine_decay_schedule`` (lr * (1 + cos(pi t / T)) / 2),
as the JAX package steps it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import torch

from nerficg_torch.core.logging import Logger

__all__ = ['PPISP', 'PPISPWrapper', 'init_ppisp_params', 'apply_ppisp']


def init_ppisp_params(n_cameras: int, n_frames: int,
                      device: torch.device | str = 'cpu'
                      ) -> dict[str, torch.Tensor]:
    """Identity parameters, as leaf tensors that take gradients."""
    params = {
        'log_exposure': torch.zeros((n_frames,)),
        'wb_gains': torch.zeros((n_frames, 2)),                 # log r/b
        'ccm': torch.eye(3)[None].repeat(n_cameras, 1, 1),
        'vignette': torch.zeros((n_cameras, 2)),                # k1, k2
        'log_gamma': torch.zeros((n_cameras,)),
    }
    return {k: v.to(device).requires_grad_(True) for k, v in params.items()}


def apply_ppisp(params: dict, rgb: torch.Tensor, camera_idx: int,
                frame_idx: int) -> torch.Tensor:
    """The correction of one (H, W, 3) image in [0, 1] for a camera and a
    frame (indices into the parameters)."""
    h, w = rgb.shape[0], rgb.shape[1]
    exposure = torch.exp(params['log_exposure'][frame_idx])
    wb = torch.exp(params['wb_gains'][frame_idx])                 # (2,)
    gains = torch.stack([wb[0], torch.ones_like(wb[0]), wb[1]])   # (3,)
    out = rgb * (exposure * gains)
    out = out @ params['ccm'][camera_idx].T
    ys = (torch.arange(h, dtype=torch.float32, device=rgb.device)
          - (h - 1) / 2) / max(h, w)
    xs = (torch.arange(w, dtype=torch.float32, device=rgb.device)
          - (w - 1) / 2) / max(h, w)
    r2 = (ys[:, None] ** 2 + xs[None, :] ** 2) * 4.0
    k1, k2 = params['vignette'][camera_idx]
    out = out * (1.0 + k1 * r2 + k2 * r2 * r2)[..., None]
    gamma = torch.exp(params['log_gamma'][camera_idx])
    return torch.clamp(out, min=1e-6) ** gamma


@dataclass
class PPISP:
    """Indexing, optimiser and checkpoint extra state around
    ``apply_ppisp``. Per-frame parameters are laid out sorted by camera,
    so that the report groups the frames of one camera."""

    params: dict | None = None
    known_camera_indices: dict = field(default_factory=dict)
    known_global_frame_indices: dict = field(default_factory=dict)
    frames_per_camera: list = field(default_factory=list)
    learning_rate: float = 1e-3
    total_training_steps: int = 0
    device: torch.device | str = 'cpu'
    optimizer: torch.optim.Optimizer | None = None
    scheduler: object = None

    def initialize(self, dataset, n_iterations: int) -> None:
        """The index bookkeeping, parameters and optimiser from the views
        of ``dataset`` (an iterable of views)."""
        for view in dataset:
            cam = self.known_camera_indices.setdefault(
                view.camera_index, len(self.known_camera_indices))
            if cam == len(self.frames_per_camera):
                self.frames_per_camera.append(0)
            self.frames_per_camera[cam] += 1
        cursor = [0]
        for count in self.frames_per_camera[:-1]:
            cursor.append(cursor[-1] + count)
        for view in dataset:
            cam = self.known_camera_indices[view.camera_index]
            self.known_global_frame_indices[view.global_frame_idx] = \
                cursor[cam]
            cursor[cam] += 1
        n_cameras = len(self.known_camera_indices)
        n_frames = len(self.known_global_frame_indices)
        Logger.info(f'initializing PPISP (cameras: {n_cameras}, '
                    f'total frames: {n_frames})')
        self.total_training_steps = n_iterations
        self.params = init_ppisp_params(n_cameras, n_frames, self.device)
        decay_steps = max(n_iterations, 1)
        self.optimizer = torch.optim.Adam(list(self.params.values()),
                                          lr=self.learning_rate, eps=1e-8)
        self.scheduler = torch.optim.lr_scheduler.LambdaLR(
            self.optimizer, lambda t: 0.5 * (1.0 + math.cos(
                math.pi * min(t, decay_steps) / decay_steps)))

    def step(self, grads: dict) -> None:
        """One optimiser step from the gradients of the parameters (the
        caller differentiates its loss through ``apply_ppisp``)."""
        for name, value in self.params.items():
            value.grad = grads[name].to(value)
        self.optimizer.step()
        self.scheduler.step()
        self.optimizer.zero_grad(set_to_none=True)

    def __call__(self, rgb: torch.Tensor, view) -> torch.Tensor:
        """The correction of an (H, W, 3) or (3, H, W) image for ``view``."""
        to_chw = rgb.ndim == 3 and rgb.shape[0] == 3 and rgb.shape[-1] != 3
        if to_chw:
            rgb = rgb.permute(1, 2, 0)
        cam = self.known_camera_indices.get(view.camera_index)
        if cam is None:
            Logger.warning('ppisp: camera unseen during training, '
                           'defaulting to camera 0')
            cam = 0
        frame = self.known_global_frame_indices.get(view.global_frame_idx, 0)
        out = apply_ppisp(self.params, rgb, cam, frame)
        return out.permute(2, 0, 1) if to_chw else out

    def get_extra_state(self) -> dict:
        return {
            'total_training_steps': self.total_training_steps,
            'known_camera_indices': self.known_camera_indices,
            'known_global_frame_indices': self.known_global_frame_indices,
            'frames_per_camera': self.frames_per_camera,
        }

    def set_extra_state(self, state: dict) -> None:
        self.total_training_steps = state['total_training_steps']
        self.known_camera_indices = state['known_camera_indices']
        self.known_global_frame_indices = state['known_global_frame_indices']
        self.frames_per_camera = state['frames_per_camera']

    def create_report(self, output_directory: Path) -> None:
        """A plain-text report of every camera's and frame's parameters
        (the reference writes a PDF), in ``ppisp_report/report.txt``."""
        out_dir = Path(output_directory) / 'ppisp_report'
        out_dir.mkdir(parents=True, exist_ok=True)
        p = {k: v.detach().cpu().numpy() for k, v in self.params.items()}
        lines = ['PPISP parameter report', '=' * 40]
        frame = 0
        for cam_key, cam in sorted(self.known_camera_indices.items(),
                                   key=lambda kv: kv[1]):
            lines.append(f'camera {cam_key} (index {cam}):')
            lines.append(f'  ccm:\n{p["ccm"][cam]}')
            lines.append(f'  vignette k1={p["vignette"][cam][0]:+.4f} '
                         f'k2={p["vignette"][cam][1]:+.4f}')
            lines.append(f'  gamma={float(np.exp(p["log_gamma"][cam])):.4f}')
            for _ in range(self.frames_per_camera[cam]):
                lines.append(
                    f'    frame {frame}: exposure='
                    f'{float(np.exp(p["log_exposure"][frame])):.4f} '
                    f'wb_r={float(np.exp(p["wb_gains"][frame][0])):.4f} '
                    f'wb_b={float(np.exp(p["wb_gains"][frame][1])):.4f}')
                frame += 1
        (out_dir / 'report.txt').write_text('\n'.join(lines) + '\n')


# The reference wrapper's class name (src/Optim/ppisp.py:15).
PPISPWrapper = PPISP
