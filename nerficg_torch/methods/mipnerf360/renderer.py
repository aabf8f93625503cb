"""Mip-NeRF 360 renderer: proposal rounds, then the NeRF round, each
resampling intervals from the previous round's histogram in s-space.

Per ray (Barron et al. 2022, §2-§3; multinerf ``Model.__call__``):
distances t in [NEAR_PLANE, FAR_PLANE] map to s in [0, 1] under
g(t) = 1/t. Round 0 starts from one interval [0, 1] of weight 1. Each
round draws its intervals from the previous round's weights
(``ops/sampling.sample_intervals``: PROPOSAL_SAMPLES, then NERF_SAMPLES,
one jitter per ray), detached; each interval's conical frustum becomes a
Gaussian (``ops/frustum.py``, the ray's base radius from the pool), is
contracted, and its axis-aligned variances give the integrated positional
encoding. A proposal round evaluates the proposal MLP's densities, the
NeRF round the NeRF MLP's densities and colours; weights come from
``densities_to_weights`` on the t-space lengths times |d|, and the NeRF
round composites onto a black background.

The spans ``render_image``, ``sampler``, ``encoding`` and ``compositor``
open here (``proposal`` and ``field`` in the model); every MLP evaluation
counts as ``mip/samples``, and NeRF samples whose mean lies outside the
unit ball as ``mip/contracted`` (``core/tracing.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from nerficg_torch.core import tracing
from nerficg_torch.core.config import Configurable
from nerficg_torch.core.tracing import count, span, traced
from nerficg_torch.data.types import View
from nerficg_torch.methods.base.renderer import BaseRenderer
from nerficg_torch.methods.mipnerf360.model import MipNeRF360Model
from nerficg_torch.ops.compositing import composite_rays, \
    densities_to_weights
from nerficg_torch.ops.encoding import integrated_pos_encode
from nerficg_torch.ops.frustum import conical_frustum_gaussians, \
    contract_gaussians
from nerficg_torch.ops.sampling import s_to_t, sample_intervals

__all__ = ['MipNeRF360Renderer']


@Configurable.configure(
    RAY_BATCH_SIZE=8192,
    PROPOSAL_SAMPLES=[64, 64],
    NERF_SAMPLES=32,
    NEAR_PLANE=0.2,
    FAR_PLANE=1e6,
)
class MipNeRF360Renderer(BaseRenderer):

    MODEL_CLASS = MipNeRF360Model

    @traced('sampler')
    def resample(self, edges: torch.Tensor, weights: torch.Tensor,
                 num_samples: int, randomized: bool,
                 generator: Optional[torch.Generator],
                 u: Optional[torch.Tensor] = None) -> torch.Tensor:
        """The next round's s-edges (R, num_samples + 1), detached."""
        return sample_intervals(generator, edges, weights, num_samples,
                                randomized, u=u)

    @traced('encoding')
    def encode(self, origins: torch.Tensor, directions: torch.Tensor,
               radii: torch.Tensor, t_edges: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor]:
        """Each interval's frustum Gaussian, contracted, and its integrated
        positional encoding: (R * S, encoding_dim) features and the
        (R, S) mask of means outside the unit ball."""
        means, covs = conical_frustum_gaussians(
            origins, directions, radii, t_edges[:, :-1], t_edges[:, 1:])
        means, covs, outside = contract_gaussians(means, covs)
        variances = torch.diagonal(covs, dim1=-2, dim2=-1)
        features = integrated_pos_encode(means, variances,
                                         int(self.model.POSITION_DEGREES))
        return features.reshape(-1, features.shape[-1]), outside

    def _render_rays_impl(self, origins: torch.Tensor,
                          directions: torch.Tensor, radii: torch.Tensor,
                          randomized: bool = True,
                          generator: Optional[torch.Generator] = None,
                          draws: Optional[list] = None) -> dict:
        """One chunk of rays: origins, directions (R, 3), base radii (R,).
        Randomized rendering (training) draws one jitter per ray and round
        from ``generator``, or takes round k's from ``draws[k]`` (R,).
        Returns 'rgb', 'depth', 'alpha' (R, ...) and 'rounds': per round
        its s-edges (R, n + 1) and weights (R, n)."""
        num_rays = origins.shape[0]
        near, far = float(self.NEAR_PLANE), float(self.FAR_PLANE)
        dir_norm = torch.linalg.norm(directions, dim=-1, keepdim=True)
        unit_dirs = directions / dir_norm
        edges = torch.linspace(0.0, 1.0, 2, device=origins.device
                               ).expand(num_rays, 2)
        weights = torch.ones((num_rays, 1), device=origins.device)
        sizes = [int(n) for n in self.PROPOSAL_SAMPLES] + \
            [int(self.NERF_SAMPLES)]
        rounds = []
        for k, n in enumerate(sizes):
            edges = self.resample(edges, weights, n, randomized, generator,
                                  None if draws is None else draws[k])
            t_edges = s_to_t(edges, near, far)
            features, outside = self.encode(origins, directions, radii,
                                            t_edges)
            count('mip/samples', num_rays * n)
            deltas = (t_edges[:, 1:] - t_edges[:, :-1]) * dir_norm
            if k < len(sizes) - 1:
                density = self.model.proposal_density(features)
                with span('compositor'):
                    weights = densities_to_weights(
                        density.reshape(num_rays, n), deltas)
                rounds.append({'edges': edges, 'weights': weights})
                continue
            if tracing.enabled():
                count('mip/contracted', outside.sum())
            flat_dirs = unit_dirs[:, None, :].expand(num_rays, n, 3)
            density, rgb = self.model.field(features,
                                            flat_dirs.reshape(-1, 3))
            with span('compositor'):
                out = composite_rays(
                    rgb.reshape(num_rays, n, 3), density.reshape(num_rays, n),
                    0.5 * (t_edges[:, 1:] + t_edges[:, :-1]), deltas,
                    background=torch.zeros(3, device=origins.device))
            rounds.append({'edges': edges, 'weights': out['weights']})
        return {'rgb': out['rgb'], 'depth': out['depth'],
                'alpha': out['alpha'], 'rounds': rounds}

    @torch.no_grad()
    def render_rays(self, origins: torch.Tensor, directions: torch.Tensor,
                    radii: torch.Tensor) -> dict:
        """Rays in RAY_BATCH_SIZE chunks, deterministic samples (each
        round's quantiles at (i + 0.5) / n)."""
        chunk = int(self.RAY_BATCH_SIZE)
        outputs = [self._render_rays_impl(
            origins[i:i + chunk], directions[i:i + chunk],
            radii[i:i + chunk], randomized=False)
            for i in range(0, origins.shape[0], chunk)]
        return {k: torch.cat([o[k] for o in outputs], 0)
                for k in ('rgb', 'depth', 'alpha')}

    @traced('render_image')
    def render_image(self, view: View,
                     benchmark: bool = False) -> dict[str, torch.Tensor]:
        device = self.model.device
        rays = view.get_rays(with_images=False, device=device)
        out = self.render_rays(rays.origins, rays.directions,
                               view.camera.local_ray_radii(device))
        h, w = view.camera.height, view.camera.width
        result = {'rgb': out['rgb'].reshape(h, w, 3),
                  'depth': out['depth'].reshape(h, w, 1),
                  'alpha': out['alpha'].reshape(h, w, 1)}
        if benchmark and device.type == 'cuda':
            torch.cuda.synchronize(device)
        return result
