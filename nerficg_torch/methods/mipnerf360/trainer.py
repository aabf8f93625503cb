"""Mip-NeRF 360 trainer: random ray batches from the training rays, the
data, distortion and interlevel losses, a clipped Adam update.

Per iteration (Barron et al. 2022, §4 and §6; multinerf ``configs/
360.gin`` and ``internal/train_utils.py``): RAYS_PER_BATCH rays drawn
uniformly from the pool of every training pixel, each with its cone's base
radius; the loss is

    Charbonnier(C, C*) (eps 1e-3, the NeRF round only)
    + DISTORTION_LOSS_WEIGHT x the distortion loss of the NeRF round's
      s-midpoints and widths (``ops/compositing.distortion_loss``)
    + INTERLEVEL_LOSS_WEIGHT x, per proposal round, the interlevel loss
      against the NeRF round held fixed (``ops/compositing.interlevel_loss``),

each term a mean over rays. The gradients are clipped to a global norm of
GRAD_MAX_NORM, and Adam (betas 0.9, 0.999, eps 1e-6) steps at the
log-linear rate LR_INIT -> LR_FINAL over NUM_ITERATIONS with mip-NeRF's
sine warm-up (LR_DELAY_STEPS, LR_DELAY_MULT), taken at the step count
before the update.

Ray ids come from ``np.random.default_rng(RANDOM_SEED)``; the jitters
from a generator on the model's device seeded from RANDOM_SEED, one
(RAYS_PER_BATCH,) draw per round in round order. The loss runs in the
``loss`` span and the clip and Adam in ``optimizer`` (``core/tracing.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from nerficg_torch.core.config import Configurable
from nerficg_torch.core.logging import Logger
from nerficg_torch.core.tracing import traced
from nerficg_torch.methods.base.callbacks import (pre_training_callback,
                                                  training_callback)
from nerficg_torch.methods.base.trainer import (BaseTrainer,
                                                adam_state_from_numpy,
                                                adam_state_to_numpy)
from nerficg_torch.ops.compositing import distortion_loss, interlevel_loss
from nerficg_torch.optim.losses import charbonnier
from nerficg_torch.optim.lr import lr_decay_policy
from nerficg_torch.optim.metrics import mse_to_psnr

__all__ = ['MipNeRF360Trainer']


@Configurable.configure(
    NUM_ITERATIONS=250000,
    RAYS_PER_BATCH=16384,
    LR_INIT=2e-3,
    LR_FINAL=2e-5,
    LR_DELAY_STEPS=512,
    LR_DELAY_MULT=0.01,
    GRAD_MAX_NORM=1e-3,
    DISTORTION_LOSS_WEIGHT=0.01,
    INTERLEVEL_LOSS_WEIGHT=1.0,
    LOG_INTERVAL=500,
)
class MipNeRF360Trainer(BaseTrainer):

    def __init__(self, config, model, renderer):
        super().__init__(config, model, renderer)
        self.schedule = lr_decay_policy(
            float(self.LR_INIT), float(self.LR_FINAL),
            int(self.NUM_ITERATIONS), int(self.LR_DELAY_STEPS),
            float(self.LR_DELAY_MULT))
        self.optimizer = torch.optim.Adam(
            model.module.parameters(), lr=float(self.LR_INIT),
            betas=(0.9, 0.999), eps=1e-6)
        self.updates = 0               # optimizer steps taken
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
        """The training rays, with their base radii, on the device."""
        rays = dataset.precompute_rays('train', device=self.device,
                                       radii=True).rays
        self._pool = {'origins': rays.origins,
                      'directions': rays.directions, 'rgb': rays.rgb,
                      'radii': rays.radii[:, 0]}
        self._pool_size = int(rays.origins.shape[0])
        self._np_rng = np.random.default_rng(self.seed)

    def on_resume(self, dataset) -> None:
        self._init_samplers(dataset)

    # -- one step -----------------------------------------------------------------
    @traced('loss')
    def compute_loss(self, out: dict, target: torch.Tensor
                     ) -> tuple[torch.Tensor, dict]:
        """The total loss and its terms from a batch's render."""
        *proposals, nerf = out['rounds']
        data = charbonnier(out['rgb'], target, 1e-3)
        s = nerf['edges']
        distortion = distortion_loss(nerf['weights'],
                                     0.5 * (s[:, 1:] + s[:, :-1]),
                                     s[:, 1:] - s[:, :-1]).mean()
        interlevel = sum(interlevel_loss(s, nerf['weights'], p['edges'],
                                         p['weights']).mean()
                         for p in proposals)
        total = data + float(self.DISTORTION_LOSS_WEIGHT) * distortion + \
            float(self.INTERLEVEL_LOSS_WEIGHT) * interlevel
        return total, {'data': data, 'distortion': distortion,
                       'interlevel': interlevel, 'total': total}

    def loss_and_grads(self, ids: torch.Tensor,
                       draws: Optional[list] = None) -> dict:
        """Forward and backward of one batch; the gradients land in the
        parameters' ``.grad``. ``draws`` hands the renderer its jitters
        (tests). Returns the logs as tensors on the device."""
        pool = self._pool
        out = self.renderer._render_rays_impl(
            pool['origins'][ids], pool['directions'][ids],
            pool['radii'][ids], randomized=True,
            generator=self.sample_generator, draws=draws)
        target = pool['rgb'][ids]
        loss, logs = self.compute_loss(out, target)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        logs = {k: v.detach() for k, v in logs.items()}
        logs['psnr'] = mse_to_psnr(torch.mean(
            (out['rgb'].detach() - target) ** 2))
        return logs

    @traced('optimizer')
    def apply_update(self) -> None:
        """The gradients clipped to GRAD_MAX_NORM, then Adam with the
        schedule's rate at the step count before the update."""
        torch.nn.utils.clip_grad_norm_(self.model.module.parameters(),
                                       float(self.GRAD_MAX_NORM))
        lr = self.schedule(self.updates)
        for group in self.optimizer.param_groups:
            group['lr'] = lr
        self.optimizer.step()
        self.updates += 1

    def train_step(self, ids: torch.Tensor,
                   draws: Optional[list] = None) -> dict:
        logs = self.loss_and_grads(ids, draws)
        self.apply_update()
        return logs

    # -- callbacks -----------------------------------------------------------------
    @training_callback(priority=100)
    def training_iteration(self, dataset, iteration: int) -> None:
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
