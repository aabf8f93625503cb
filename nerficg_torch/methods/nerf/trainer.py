"""NeRF trainer: Adam with a log-linear rate decay, random ray batches from
the training rays, MSE losses.

Port of nerficg_tpu/methods/nerf/trainer.py (reference: src/Methods/NeRF/
Trainer.py:30-74 and Loss.py:10-45): Adam at optax's defaults (eps 1e-8)
with the rate ``lr_decay_policy(LR_INIT, LR_FINAL, NUM_ITERATIONS)`` taken
at the step count before each update, as optax's schedule counts; per
iteration RAYS_PER_BATCH rays drawn from the precomputed training rays; the
target composited onto the background where the dataset has alpha; loss =
colour MSE + COARSE_LOSS_WEIGHT x coarse MSE (+ ALPHA_LOSS_WEIGHT x alpha
MSE), with the PSNR logged.

Ray ids come from ``np.random.default_rng(RANDOM_SEED)``, as in the JAX
trainer, so both pick the same rays; the sample draws come from a
generator on the model's device, seeded from RANDOM_SEED. The loss and Adam
run in the ``loss`` and ``optimizer`` spans (``core/tracing.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nerficg_torch.core.config import Configurable
from nerficg_torch.core.logging import Logger
from nerficg_torch.core.tracing import span, traced
from nerficg_torch.methods.base.callbacks import (pre_training_callback,
                                                  training_callback)
from nerficg_torch.methods.base.trainer import (BaseTrainer,
                                                adam_state_from_numpy,
                                                adam_state_to_numpy)
from nerficg_torch.optim.losses import LossContainer, mse
from nerficg_torch.optim.lr import lr_decay_policy
from nerficg_torch.optim.metrics import mse_to_psnr

__all__ = ['NeRFTrainer']


@Configurable.configure(
    NUM_ITERATIONS=500000,
    RAYS_PER_BATCH=1024,
    LR_INIT=5e-4,
    LR_FINAL=5e-5,
    ALPHA_LOSS_WEIGHT=0.0,
    COARSE_LOSS_WEIGHT=1.0,
    VALIDATION_INTERVAL=None,
    LOG_INTERVAL=500,
)
class NeRFTrainer(BaseTrainer):

    def __init__(self, config, model, renderer):
        super().__init__(config, model, renderer)
        self.schedule = lr_decay_policy(float(self.LR_INIT),
                                        float(self.LR_FINAL),
                                        int(self.NUM_ITERATIONS))
        self.optimizer = torch.optim.Adam(model.module.parameters(),
                                          lr=float(self.LR_INIT), eps=1e-8)
        self.updates = 0               # optimizer steps taken
        self.loss_container = LossContainer()
        self.loss_container.add_loss('color', mse, 1.0)
        if float(self.COARSE_LOSS_WEIGHT) > 0:
            self.loss_container.add_loss('coarse', mse,
                                         float(self.COARSE_LOSS_WEIGHT))
        if float(self.ALPHA_LOSS_WEIGHT) > 0:
            self.loss_container.add_loss('alpha', mse,
                                         float(self.ALPHA_LOSS_WEIGHT))
        self.sample_generator = torch.Generator(
            device=self.device).manual_seed(self.seed)
        self._pool = None
        self.losses: list[torch.Tensor] = []    # per-step loss, on the card
        self._last_logs: dict = {}

    # -- optimizer state ----------------------------------------------------------
    def get_optimizer_state(self) -> dict:
        return adam_state_to_numpy(self.optimizer,
                                   self.model.module.named_parameters(),
                                   self.updates)

    def set_optimizer_state(self, state: dict) -> None:
        self.updates = adam_state_from_numpy(
            self.optimizer, self.model.module.named_parameters(), state)

    # -- setup ----------------------------------------------------------------------
    @pre_training_callback(priority=4000)
    def _init_samplers(self, dataset) -> None:
        """The training rays on the device (reference:
        NeRF/Trainer.py:40-50)."""
        rays = dataset.precompute_rays('train', device=self.device).rays
        self._pool = {'origins': rays.origins,
                      'directions': rays.directions, 'rgb': rays.rgb,
                      'alpha': rays.alpha}
        self._pool_size = int(rays.origins.shape[0])
        self._np_rng = np.random.default_rng(self.seed)
        self.renderer.bind_camera_settings(dataset.camera_settings)

    def on_resume(self, dataset) -> None:
        self._init_samplers(dataset)

    # -- one step -----------------------------------------------------------------
    def loss_and_grads(self, ids: torch.Tensor,
                       draws: Optional[dict] = None) -> dict:
        """Forward and backward of one batch (nerficg_tpu trainer.py:
        113-147); the gradients land in the parameters' ``.grad``.
        ``draws`` hands the renderer its uniforms (tests). Returns the logs
        as tensors on the device."""
        pool = self._pool
        near, far, bg = self.renderer.ray_constants()
        target = pool['rgb'][ids]
        alpha = pool['alpha'][ids] if pool['alpha'] is not None else None
        if alpha is not None:
            # Ground truth composited onto the background the renderer
            # blends in (reference: NeRF/Trainer.py:55-58).
            target = target * alpha + bg * (1 - alpha)
        out = self.renderer._render_rays_impl(
            pool['origins'][ids], pool['directions'][ids], near, far, bg,
            randomized=True, generator=self.sample_generator, draws=draws)
        terms = {'color': {'pred': out['rgb'], 'target': target}}
        if 'coarse' in self.loss_container.terms and 'coarse_rgb' in out:
            terms['coarse'] = {'pred': out['coarse_rgb'], 'target': target}
        if 'alpha' in self.loss_container.terms and alpha is not None:
            terms['alpha'] = {'pred': out['alpha'], 'target': alpha}
        with span('loss'):
            loss, logs = self.loss_container(**terms)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        logs = {k: v.detach() for k, v in logs.items()}
        logs['psnr'] = mse_to_psnr(logs['color'])
        return logs

    @traced('optimizer')
    def apply_update(self) -> None:
        """Adam with the schedule's rate at the step count before the
        update (optax's convention)."""
        lr = self.schedule(self.updates)
        for group in self.optimizer.param_groups:
            group['lr'] = lr
        self.optimizer.step()
        self.updates += 1

    def train_step(self, ids: torch.Tensor,
                   draws: Optional[dict] = None) -> dict:
        logs = self.loss_and_grads(ids, draws)
        self.apply_update()
        return logs

    # -- callbacks -----------------------------------------------------------------
    @training_callback(priority=100)
    def training_iteration(self, dataset, iteration: int) -> None:
        """(reference: NeRF/Trainer.py:52-64)"""
        ids = torch.as_tensor(self._np_rng.integers(
            0, self._pool_size, size=int(self.RAYS_PER_BATCH)),
            device=self.device)
        self._last_logs = self.train_step(ids)
        self.losses.append(self._last_logs['total'])

    @training_callback(priority=50, iteration_stride='LOG_INTERVAL')
    def _log_progress(self, dataset, iteration: int) -> None:
        if self._last_logs:
            Logger.verbose(f'iter {iteration}: ' + ', '.join(
                f'{k}={float(v):.4f}' for k, v in self._last_logs.items()))

    @training_callback(priority=40, active='VALIDATION_INTERVAL',
                       iteration_stride='VALIDATION_INTERVAL')
    def _validate(self, dataset, iteration: int) -> None:
        """PSNR of the first validation (or test) view (reference:
        NeRF/Trainer.py:66-74)."""
        views = dataset.subsets.get('val') or dataset.subsets.get('test')
        if not views or views[0].rgb is None:
            return
        view = views[0]
        out = self.renderer.render_image(view)
        gt = torch.as_tensor(view.rgb[..., :3], dtype=torch.float32,
                             device=self.device)
        err = torch.mean((out['rgb'] - gt) ** 2)
        Logger.info(f'validation iter {iteration}: '
                    f'psnr={float(mse_to_psnr(err)):.3f}')
