"""3D Gaussian Splatting trainer: L1 + DSSIM, densification schedule.

Port of nerficg_tpu/methods/gaussian_splatting/trainer.py (reference:
src/Methods/GaussianSplatting/Trainer.py:18-150): camera extent 1.1x the
largest camera distance from their mean; initialisation from the dataset's
point cloud, or RANDOM_POINTS random points in its bounding box; per
iteration one full-image render of a random training view (16-wide stream,
``gs_composite_fwd`` and ``gs_composite_bwd``), loss 0.8 L1 + 0.2 DSSIM,
then Adam per parameter group (eps 1e-15) with the position rate scaled by
the camera extent and log-lerp decayed; densification every
DENSIFY_INTERVAL iterations in (DENSIFY_FROM, DENSIFY_UNTIL], opacity reset
every OPACITY_RESET_INTERVAL, one more SH band every SH_UPDATE_INTERVAL, and
a Morton-ordered bake after training.

The training view comes from ``np.random.default_rng(RANDOM_SEED)`` as in
the JAX trainer, so both trainers see the same views. The densification
statistics stay on the model's device; densification itself runs on the
host. With wandb active, the primitive count and the Gaussians' means are
logged (``_wandb_log_primitives``). The loss and Adam run in the ``loss``
and ``optimizer`` spans (``core/tracing.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from nerficg_torch.core.config import Configurable
from nerficg_torch.core.logging import Logger
from nerficg_torch.core.tracing import span, traced
from nerficg_torch.data.types import BasicPointCloud
from nerficg_torch.methods.base.callbacks import (post_training_callback,
                                                  pre_training_callback,
                                                  training_callback)
from nerficg_torch.methods.base.trainer import (BaseTrainer,
                                                adam_state_from_numpy,
                                                adam_state_to_numpy)
from nerficg_torch.methods.gaussian_splatting.convert import PARAM_KEYS
from nerficg_torch.methods.gaussian_splatting.renderer import to_device
from nerficg_torch.ops.encoding import SH_C0
from nerficg_torch.optim.losses import dssim, l1
from nerficg_torch.optim.lr import lr_decay_policy
from nerficg_torch.optim.metrics import mse_to_psnr
from nerficg_torch.optim.state_surgery import reset_rows

__all__ = ['GaussianSplattingTrainer']


@Configurable.configure(
    NUM_ITERATIONS=30000,
    LAMBDA_DSSIM=0.2,
    POSITION_LR_INIT=1.6e-4,      # x camera extent (reference: Model.py:121-150)
    POSITION_LR_FINAL=1.6e-6,
    FEATURE_LR=2.5e-3,
    OPACITY_LR=0.025,
    SCALING_LR=5e-3,
    ROTATION_LR=1e-3,
    DENSIFY_FROM=500,
    DENSIFY_UNTIL=15000,
    DENSIFY_INTERVAL=100,
    DENSIFY_GRAD_THRESHOLD=2e-4,
    OPACITY_RESET_INTERVAL=3000,
    PERCENT_DENSE=0.01,
    MIN_OPACITY=0.005,
    SH_UPDATE_INTERVAL=1000,
    RANDOM_POINTS=100000,
    LOG_INTERVAL=500,
)
class GaussianSplattingTrainer(BaseTrainer):

    def __init__(self, config, model, renderer):
        super().__init__(config, model, renderer)
        self.optimizer: torch.optim.Adam | None = None
        self.updates = 0                 # optimizer steps taken
        self.camera_extent = 1.0
        self.losses: list[torch.Tensor] = []    # per-step loss, on the device
        self._last_logs: dict = {}
        self._targets: dict[int, torch.Tensor] = {}
        self._np_rng = np.random.default_rng(self.seed)

    # -- optimizer state ------------------------------------------------------
    def get_optimizer_state(self) -> dict:
        return adam_state_to_numpy(self.optimizer, self.model.params.items(),
                                   self.updates)

    def set_optimizer_state(self, state: dict) -> None:
        self.updates = adam_state_from_numpy(
            self.optimizer, self.model.params.items(), state)

    def get_resume_metadata(self) -> dict:
        return {'num_active': int(self.model.num_active),
                'active_sh_degree': int(self.model.active_sh_degree)}

    def set_resume_metadata(self, meta: dict) -> None:
        if 'num_active' in meta:
            self.model.num_active = int(meta['num_active'])
        if 'active_sh_degree' in meta:
            self.model.active_sh_degree = int(meta['active_sh_degree'])

    # -- setup ------------------------------------------------------------------
    def _set_camera_extent(self, dataset) -> None:
        positions = np.stack([v.position for v in dataset.subsets['train']])
        self.camera_extent = 1.1 * float(np.linalg.norm(
            positions - positions.mean(0), axis=-1).max()) or 1.0

    @pre_training_callback(priority=4500)
    def _setup_gaussians(self, dataset) -> None:
        """(reference: Trainer.py:57-68)"""
        self._set_camera_extent(dataset)
        pcd = dataset.point_cloud
        if pcd is None or len(pcd) == 0:
            rng = np.random.default_rng(0)
            lo, hi = dataset.bounding_box.min, dataset.bounding_box.max
            count = int(self.RANDOM_POINTS)
            pts = rng.random((count, 3)) * (hi - lo) + lo
            pcd = BasicPointCloud(pts.astype(np.float32),
                                  rng.random((count, 3)).astype(np.float32))
            Logger.info(f'GS init from {len(pcd)} random points in bbox')
        self.model.init_from_point_cloud(pcd)
        self.model.active_sh_degree = 1
        self._build_optimizer()
        self._reset_densify_stats()
        self._np_rng = np.random.default_rng(self.seed)

    def on_resume(self, dataset) -> None:
        """Rebuild the optimizer, statistics and view generator around the
        restored parameters, without re-initialising them."""
        self._set_camera_extent(dataset)
        self._build_optimizer()
        self._reset_densify_stats()
        self._np_rng = np.random.default_rng(self.seed)

    def _build_optimizer(self) -> None:
        """Adam per parameter group; the position rate scaled by the camera
        extent and log-lerp decayed (reference: Model.py:121-150)."""
        self._position_lr = lr_decay_policy(
            float(self.POSITION_LR_INIT) * self.camera_extent,
            float(self.POSITION_LR_FINAL) * self.camera_extent,
            int(self.NUM_ITERATIONS))
        lrs = {'positions': self._position_lr(0),
               'features_dc': float(self.FEATURE_LR),
               'features_rest': float(self.FEATURE_LR) / 20.0,
               'opacities': float(self.OPACITY_LR),
               'scales': float(self.SCALING_LR),
               'rotations': float(self.ROTATION_LR)}
        self.optimizer = torch.optim.Adam(
            [{'params': [self.model.params[key]], 'lr': lrs[key],
              'name': key} for key in PARAM_KEYS], eps=1e-15)
        self.updates = 0

    def _reset_densify_stats(self) -> None:
        shape = (self.model.capacity,)
        self._grad_accum = torch.zeros(shape, device=self.device)
        self._grad_count = torch.zeros(shape, device=self.device)
        self._max_radii = torch.zeros(shape, device=self.device)

    # -- one step -----------------------------------------------------------------
    def loss_and_grads(self, w2c: torch.Tensor, cam_pos: torch.Tensor,
                       intrinsics: tuple, background: torch.Tensor,
                       target: torch.Tensor) -> dict:
        """Render, loss and backward of one view (nerficg_tpu :166-204); the
        gradients land in the parameters' ``.grad``. Returns the logs as
        tensors on the device, with the viewspace gradient norm in NDC
        units (the reference rasterizer's means2D gradient, for which
        DENSIFY_GRAD_THRESHOLD is calibrated)."""
        params = self.model.params
        offset = torch.zeros((self.model.capacity, 2), device=self.device,
                             requires_grad=True)
        out = self.renderer.render_impl(
            params, offset, w2c, cam_pos, intrinsics, background,
            int(self.model.active_sh_degree))
        rgb = out['rgb']
        with span('loss'):
            loss_l1 = l1(rgb, target)
            loss_dssim = dssim(rgb, target)
            lam = float(self.LAMBDA_DSSIM)
            loss = (1.0 - lam) * loss_l1 + lam * loss_dssim
        for p in params.values():
            p.grad = None
        loss.backward()
        ndc = to_device((0.5 * intrinsics[4], 0.5 * intrinsics[5]),
                        self.device)
        with torch.no_grad():
            return {
                'l1': loss_l1.detach(), 'dssim': loss_dssim.detach(),
                'total': loss.detach(),
                'psnr': mse_to_psnr(torch.mean((rgb.detach() - target) ** 2)),
                'radii': out['radii'].detach(), 'visible': out['visible'],
                'viewspace_grad_norm': torch.linalg.norm(offset.grad * ndc,
                                                         dim=-1),
                'overflow_gaussians': out['overflow_gaussians'],
                'overflow_entries': out['overflow_entries']}

    @traced('optimizer')
    def apply_update(self) -> None:
        """Adam, with the position rate at the step count before the update
        (optax's convention)."""
        for group in self.optimizer.param_groups:
            if group['name'] == 'positions':
                group['lr'] = self._position_lr(self.updates)
        self.optimizer.step()
        self.updates += 1

    def _target(self, index: int, view) -> torch.Tensor:
        """The view's image on the device, composited on its background."""
        if index not in self._targets:
            gt = view.rgb
            if view.alpha is not None:
                gt = gt[..., :3] * view.alpha + \
                    view.camera.background_color * (1 - view.alpha)
            self._targets[index] = torch.as_tensor(
                np.asarray(gt, np.float32), device=self.device)
        return self._targets[index]

    # -- callbacks ------------------------------------------------------------------
    @training_callback(priority=100)
    def training_iteration(self, dataset, iteration: int) -> None:
        """(reference: Trainer.py:77-99)"""
        views = dataset.subsets['train']
        index = int(self._np_rng.integers(len(views)))
        view = views[index]
        intrinsics, w2c, cam_pos = self.renderer.view_constants(view)
        background = to_device(view.camera.background_color, self.device)
        logs = self.loss_and_grads(w2c, cam_pos, intrinsics, background,
                                   self._target(index, view))
        self.apply_update()
        self._last_logs = {k: logs[k] for k in ('l1', 'dssim', 'total',
                                                'psnr')}
        self.losses.append(logs['total'])
        # Surface the rasterizer's truncation instead of dropping it.
        if iteration % 500 == 0:
            og = int(logs['overflow_gaussians'])
            oe = int(logs['overflow_entries'])
            if og or oe:
                Logger.verbose(f'iter {iteration}: rasterizer truncation - '
                               f'{og} gaussians exceed the tile rect, {oe} '
                               f'entries beyond the per-tile budget')
        # Densification statistics (reference: Model.py:256-259).
        if int(self.DENSIFY_FROM) <= iteration <= int(self.DENSIFY_UNTIL):
            visible = logs['visible'].float()
            n = visible.shape[0]
            self._grad_accum[:n] += logs['viewspace_grad_norm'] * visible
            self._grad_count[:n] += visible
            self._max_radii[:n] = torch.maximum(self._max_radii[:n],
                                                logs['radii'])

    @training_callback(priority=90, start_iteration='DENSIFY_FROM',
                       end_iteration='DENSIFY_UNTIL',
                       iteration_stride='DENSIFY_INTERVAL')
    def _densify(self, dataset, iteration: int) -> None:
        """(reference: Trainer.py:101-123)"""
        if iteration <= int(self.DENSIFY_FROM):
            return
        use_screen = iteration > int(self.OPACITY_RESET_INTERVAL)
        self.model.densify_and_prune(
            self.optimizer, self._grad_accum.cpu().numpy(),
            self._grad_count.cpu().numpy(),
            float(self.DENSIFY_GRAD_THRESHOLD), self.camera_extent,
            percent_dense=float(self.PERCENT_DENSE),
            min_opacity=float(self.MIN_OPACITY),
            max_screen_size=20.0 if use_screen else None,
            max_radii=self._max_radii.cpu().numpy())
        self._reset_densify_stats()

    @training_callback(priority=85, start_iteration='OPACITY_RESET_INTERVAL',
                       end_iteration='DENSIFY_UNTIL',
                       iteration_stride='OPACITY_RESET_INTERVAL')
    def _reset_opacity(self, dataset, iteration: int) -> None:
        """Clamp the opacities and zero their Adam moments, which would
        otherwise snap them back within a few steps (reference:
        Trainer.py:118-123, src/Optim/adam_utils.py:6-20)."""
        self.model.reset_opacity()
        mask = np.zeros(self.model.capacity, bool)
        mask[:self.model.num_active] = True
        reset_rows(self.optimizer, self.model.params['opacities'], mask)
        Logger.verbose(f'iter {iteration}: opacity reset')

    @training_callback(priority=80, iteration_stride='SH_UPDATE_INTERVAL',
                       start_iteration='SH_UPDATE_INTERVAL')
    def _increase_sh_degree(self, dataset, iteration: int) -> None:
        """(reference: Trainer.py:72-75)"""
        if self.model.active_sh_degree < int(self.model.SH_DEGREE):
            self.model.active_sh_degree += 1
            Logger.verbose(f'iter {iteration}: SH degree -> '
                           f'{self.model.active_sh_degree}')

    @training_callback(priority=45, iteration_stride='LOG_INTERVAL',
                       start_iteration='LOG_INTERVAL')
    def _wandb_log_primitives(self, dataset, iteration: int) -> None:
        """Primitive count and the Gaussians' means as a 3D panel
        (reference: src/Methods/GaussianSplatting/Trainer.py:133-140 logs
        the count; the panel mirrors Instant-NGP's occupancy panel)."""
        if self._wandb is None or not self._wandb.active:
            return
        n = int(self.model.num_active)
        self._wandb.log({'gaussians/count': n}, step=iteration)
        if n:
            params = self.model.params
            points = params['positions'][:n].detach().cpu().numpy()
            colors = np.clip(params['features_dc'][:n, 0].detach().cpu()
                             .numpy() * SH_C0 + 0.5, 0.0, 1.0)
            self._wandb.log_point_cloud('gaussians/means', points,
                                        colors=colors, step=iteration)

    @training_callback(priority=50, iteration_stride='LOG_INTERVAL')
    def _log_progress(self, dataset, iteration: int) -> None:
        if self._last_logs:
            Logger.verbose(
                f'iter {iteration} ({self.model.num_active} gaussians): ' +
                ', '.join(f'{k}={float(v):.4f}'
                          for k, v in self._last_logs.items()))

    @post_training_callback(priority=2000)
    def _bake(self, dataset) -> None:
        """(reference: Trainer.py:141-149)"""
        self.model.bake()
        Logger.info(f'baked model: {self.model.num_active} gaussians '
                    '(morton-sorted, pruned)')
