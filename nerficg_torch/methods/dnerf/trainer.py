"""D-NeRF trainer: Instant-NGP's schedule over timestamped rays, with the
deformation MLP in its own optimizer group and an offset prior.

Port of nerficg_tpu/methods/dnerf/trainer.py. One ``torch.optim.Adam``
(eps 1e-15) holds two groups, as ``optax.multi_transform`` does: the hash
table and field MLPs on Instant-NGP's multistep rate, the deformation MLP
on DEFORM_LR decaying exponentially to DEFORM_LR * DEFORM_LR_FINAL_FACTOR
over NUM_ITERATIONS. The offset prior adds OFFSET_REG_WEIGHT * mean
|deform(x, t) - x|^2 over OFFSET_REG_POINTS uniform points of the scene box
and times, drawn each step from the trainer's generator (the JAX trainer
draws them from its step key, so the two see different points). In a
data-parallel run each rank draws its own points, from a generator seeded
with RANDOM_SEED folded with its rank, as the JAX step folds the device
index into the key the prior draws from.
"""

from __future__ import annotations

import torch

from nerficg_torch.core.config import Configurable
from nerficg_torch.methods.instant_ngp.trainer import InstantNGPTrainer
from nerficg_torch.optim.lr import optax_exponential_decay
from nerficg_torch.parallel.data_parallel import fold_seed

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
        self.deform_schedule = optax_exponential_decay(
            float(self.DEFORM_LR), max(int(self.NUM_ITERATIONS), 1),
            float(self.DEFORM_LR_FINAL_FACTOR))
        self.offset_generator = self.generator if self.num_devices == 1 \
            else torch.Generator().manual_seed(fold_seed(self.seed,
                                                         self.rank))

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
        u = torch.rand((n, 3), generator=self.offset_generator).to(
            self.device)
        t = torch.rand((n,), generator=self.offset_generator).to(self.device)
        return model.aabb_min + u * (model.aabb_max - model.aabb_min), t

    def _loss_extras(self) -> tuple:
        n = int(self.OFFSET_REG_POINTS)
        weight = float(self.OFFSET_REG_WEIGHT)
        if n <= 0 or weight <= 0.0:
            return 0.0, {}
        reg = self.offset_prior(*self._draw_offset_points(n))
        return weight * reg, {'offset_reg': reg.detach()}
