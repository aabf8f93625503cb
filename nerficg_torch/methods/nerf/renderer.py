"""NeRF renderer: hierarchical coarse -> fine ray rendering.

Port of nerficg_tpu/methods/nerf/renderer.py (reference: src/Methods/NeRF/
Renderer.py:21-140): rays in chunks of RAY_BATCH_SIZE; N_SAMPLES per ray,
of which COARSE_RATIO are stratified coarse samples. With a coarse block,
its weights (detached) give a PDF over the coarse intervals from which the
fine samples are drawn, and the fine block evaluates the coarse and fine
samples merged in depth order; without one, more stratified samples are
merged in. Each pass composites with the last interval ending at ``far``.
``near``, ``far`` and the background come from the bound camera settings
(2, 6 and black without any).

The JAX renderer pads the last chunk to keep one compiled shape; here the
last chunk is shorter, which changes no result (every output is per ray).
The spans ``render_image``, ``sampler`` and ``compositor`` open here (the
``field`` span in ``NeRFModel.apply``), and each block's field evaluations
count as ``nerf/samples`` (``core/tracing.py``).
"""

from __future__ import annotations

from typing import Optional

import torch

from nerficg_torch.core.config import Configurable
from nerficg_torch.core.tracing import count, span, traced
from nerficg_torch.data.types import RayBatch, View
from nerficg_torch.methods.base.renderer import BaseRenderer
from nerficg_torch.methods.nerf.model import NeRFModel
from nerficg_torch.ops.compositing import composite_rays
from nerficg_torch.ops.sampling import (merge_sorted_samples, sample_pdf,
                                        stratified_samples)

__all__ = ['NeRFRenderer']


@Configurable.configure(
    RAY_BATCH_SIZE=8192,
    N_SAMPLES=256,
    COARSE_RATIO=0.25,
)
class NeRFRenderer(BaseRenderer):

    MODEL_CLASS = NeRFModel

    def __init__(self, config, model, mesh=None):
        super().__init__(config, model, mesh)
        self.num_coarse = max(int(int(self.N_SAMPLES) *
                                  float(self.COARSE_RATIO)), 1)
        self.num_fine = int(self.N_SAMPLES) - self.num_coarse
        self._camera_settings = None

    def _render_rays_impl(self, origins: torch.Tensor,
                          directions: torch.Tensor, near: torch.Tensor,
                          far: torch.Tensor, background: torch.Tensor,
                          randomized: bool = True,
                          generator: Optional[torch.Generator] = None,
                          draws: Optional[dict] = None) -> dict:
        """One chunk of rays. Randomized rendering (training) draws its
        uniforms from ``generator``, or takes them from ``draws``:
        'coarse' (R, num_coarse) for the stratified samples and 'fine'
        (R, num_fine) for the PDF (or the extra stratified) samples."""
        num_rays = origins.shape[0]
        device = origins.device
        draws = draws or {}
        noise_generator = generator if randomized else None
        with span('sampler'):
            t_coarse = stratified_samples(generator, num_rays,
                                          self.num_coarse, near, far,
                                          randomized, u=draws.get('coarse'),
                                          device=device)
        dirs_n = directions / torch.linalg.norm(directions, dim=-1,
                                                keepdim=True)

        def eval_block(block: str, t: torch.Tensor) -> dict:
            s = t.shape[1]
            positions = origins[:, None, :] + dirs_n[:, None, :] * t[..., None]
            flat_dir = dirs_n[:, None, :].expand(num_rays, s, 3).reshape(-1, 3)
            count('nerf/samples', num_rays * s)
            density, rgb = self.model.apply(block, positions.reshape(-1, 3),
                                            flat_dir, noise_generator)
            deltas = torch.diff(t, dim=-1,
                                append=far * torch.ones_like(t[:, :1]))
            with span('compositor'):
                return composite_rays(rgb.reshape(num_rays, s, 3),
                                      density.reshape(num_rays, s), t,
                                      deltas, background=background)

        outputs = {}
        if 'coarse' in self.model.module:
            coarse = eval_block('coarse', t_coarse)
            mids = 0.5 * (t_coarse[:, 1:] + t_coarse[:, :-1])
            bins = torch.cat([t_coarse[:, :1], mids, t_coarse[:, -1:]], -1)
            with span('sampler'):
                t_fine = sample_pdf(generator, bins,
                                    coarse['weights'].detach(),
                                    self.num_fine, randomized,
                                    u=draws.get('fine'))
                t_all = merge_sorted_samples(t_coarse, t_fine)
            outputs['coarse_rgb'] = coarse['rgb']
        else:
            with span('sampler'):
                t_extra = stratified_samples(generator, num_rays,
                                             self.num_fine, near, far,
                                             randomized, u=draws.get('fine'),
                                             device=device)
                t_all = merge_sorted_samples(t_coarse, t_extra)
        fine = eval_block('fine', t_all)
        outputs.update(rgb=fine['rgb'], depth=fine['depth'],
                       alpha=fine['alpha'])
        return outputs

    def ray_constants(self) -> tuple[torch.Tensor, torch.Tensor,
                                     torch.Tensor]:
        """(near, far, background) on the model's device."""
        cs = self._camera_settings
        device = self.model.device
        near = torch.tensor(cs.near if cs else 2.0, device=device)
        far = torch.tensor(cs.far if cs else 6.0, device=device)
        bg = torch.as_tensor(cs.background_color if cs else (0.0, 0.0, 0.0),
                             dtype=torch.float32, device=device)
        return near, far, bg

    def bind_camera_settings(self, settings) -> None:
        self._camera_settings = settings

    @torch.no_grad()
    def render_rays(self, rays: RayBatch) -> dict:
        """A RayBatch in RAY_BATCH_SIZE chunks, deterministic samples
        (reference: Renderer.py:44-47)."""
        chunk = int(self.RAY_BATCH_SIZE)
        near, far, bg = self.ray_constants()
        outputs = [self._render_rays_impl(
            rays.origins[i:i + chunk], rays.directions[i:i + chunk], near,
            far, bg, randomized=False)
            for i in range(0, len(rays), chunk)]
        return {k: torch.cat([o[k] for o in outputs], 0) for k in outputs[0]}

    @traced('render_image')
    def render_image(self, view: View,
                     benchmark: bool = False) -> dict[str, torch.Tensor]:
        """(reference: Renderer.py:132-140)"""
        device = self.model.device
        self.bind_camera_settings(view.camera.settings)
        out = self.render_rays(view.get_rays(with_images=False,
                                             device=device))
        h, w = view.camera.height, view.camera.width
        result = {'rgb': out['rgb'].reshape(h, w, 3),
                  'depth': out['depth'].reshape(h, w, 1),
                  'alpha': out['alpha'].reshape(h, w, 1)}
        if benchmark and device.type == 'cuda':
            torch.cuda.synchronize(device)
        return result
