"""D-NeRF trainer: Instant-NGP's schedule over timestamped rays, with the
deformation MLP in its own optimizer group and an offset prior.

Port of nerficg_tpu/methods/dnerf/trainer.py. One ``torch.optim.Adam``
(eps 1e-15) holds two groups, as ``optax.multi_transform`` does: the hash
table and field MLPs on Instant-NGP's multistep rate, the deformation MLP
on DEFORM_LR decaying exponentially to DEFORM_LR * DEFORM_LR_FINAL_FACTOR
over NUM_ITERATIONS. The offset prior adds OFFSET_REG_WEIGHT * mean
|deform(x, t) - x|^2 over OFFSET_REG_POINTS uniform points of the scene box
and times, drawn each step from the trainer's generator (the JAX trainer
draws them from its step key, so the two see different points).
"""

from __future__ import annotations

import torch

from nerficg_torch.core.config import Configurable
from nerficg_torch.methods.instant_ngp.trainer import InstantNGPTrainer
from nerficg_torch.optim.lr import exponential_decay

__all__ = ['DNeRFTrainer']


@Configurable.configure(
    NUM_ITERATIONS=30000,
    DEFORM_LR=1e-3,
    DEFORM_LR_FINAL_FACTOR=0.1,
    # weight * E[|deform(x, t) - x|^2] over uniform points of the box and
    # times; 0 switches it off.
    OFFSET_REG_WEIGHT=1e-2,
    OFFSET_REG_POINTS=4096,
)
class DNeRFTrainer(InstantNGPTrainer):

    def __init__(self, config, model, renderer):
        super().__init__(config, model, renderer)
        named = list(model.module.named_parameters())
        self.optimizer = torch.optim.Adam(
            [{'params': [p for n, p in named
                         if not n.startswith('deform_mlp.')]},
             {'params': list(model.module.deform_mlp.parameters())}],
            lr=float(self.LR), eps=1e-15)
        self.deform_schedule = exponential_decay(
            float(self.DEFORM_LR), max(int(self.NUM_ITERATIONS), 1),
            float(self.DEFORM_LR_FINAL_FACTOR))

    def apply_update(self) -> None:
        """Adam with each group's rate at the step count before the
        update."""
        base, deform = self.optimizer.param_groups
        base['lr'] = self.schedule(self.updates)
        deform['lr'] = self.deform_schedule(self.updates)
        self.optimizer.step()
        self.updates += 1

    def offset_prior(self, points: torch.Tensor,
                     times: torch.Tensor) -> torch.Tensor:
        """mean |deform(x, t) - x|^2 over points (N, 3) at times (N,)."""
        offset = self.model.deform(points, times) - points
        return (offset ** 2).sum(-1).mean()

    def _draw_offset_points(self, n: int):
        """n uniform points of the scene box and times in [0, 1)."""
        model = self.model
        u = torch.rand((n, 3), generator=self.generator).to(self.device)
        t = torch.rand((n,), generator=self.generator).to(self.device)
        return model.aabb_min + u * (model.aabb_max - model.aabb_min), t

    def _loss_extras(self) -> tuple:
        n = int(self.OFFSET_REG_POINTS)
        weight = float(self.OFFSET_REG_WEIGHT)
        if n <= 0 or weight <= 0.0:
            return 0.0, {}
        reg = self.offset_prior(*self._draw_offset_points(n))
        return weight * reg, {'offset_reg': reg.detach()}
