"""D-NeRF renderer: Instant-NGP's marching and compositing with each sample
warped to the canonical frame at its ray's time.

Port of nerficg_tpu/methods/dnerf/renderer.py. Only the field hook and the
grid refresh change: the field reads the per-sample times, and each refresh
queries the density at one random time (drawn by the caller from the
trainer's generator), so that the EMA-max over refreshes approximates the
occupancy of the union over time.
"""

from __future__ import annotations

from typing import Optional

import torch

from nerficg_torch.core.config import Configurable
from nerficg_torch.methods.dnerf.model import DNeRFModel
from nerficg_torch.methods.instant_ngp.renderer import InstantNGPRenderer

__all__ = ['DNeRFRenderer']


@Configurable.configure()
class DNeRFRenderer(InstantNGPRenderer):

    MODEL_CLASS = DNeRFModel
    TIME_CONDITIONED = True

    def _field(self, positions, directions, encode_seed, sample_times,
               anchor_keys=None):
        # The anchor keys are dropped: the deformation moves samples off the
        # marcher's morton stream, and the crossbar needs no windows.
        return self.model.field(positions, directions,
                                encode_seed=encode_seed,
                                timestamps=sample_times)

    @torch.no_grad()
    def _update_grid_impl(self, density_grid: torch.Tensor, draws,
                          encode_seed: int,
                          carve_mask: Optional[torch.Tensor] = None,
                          time: float = 0.0) -> torch.Tensor:
        """One grid refresh with every cell queried at ``time``. The biased
        slab starts count every cell of positive density as occupied: the
        JAX package's D-NeRF refresh leaves ``update_density_grid``'s
        occupied threshold at its default of 0 (nerficg_tpu/methods/dnerf/
        renderer.py:60-65)."""
        def query(positions):
            times = torch.full((positions.shape[0],), time,
                               device=positions.device)
            return self.model.density(positions, encode_seed=encode_seed,
                                      timestamps=times)[0]
        return self._refresh_grid(density_grid, draws, query, carve_mask,
                                  0.0)

    def _grid_draws(self, generator: torch.Generator) -> dict:
        return {'time': float(torch.rand((), generator=generator))}
