"""3D Gaussian Splatting renderer: projection, SH color, tile rasterizer.

Port of nerficg_tpu/methods/gaussian_splatting/renderer.py (reference:
src/Methods/GaussianSplatting/Renderer.py:27-188). ``render_impl`` is one
differentiable render; its zero (N, 2) ``means2d_offset`` input stands for
the reference's retained viewspace points, and its gradient is the
densification statistic. ``render_image`` serves through the packed
stream (``gs_composite_fwd_packed``). The spans ``render_image`` and
``frontend`` open here (``core/tracing.py``).
"""

from __future__ import annotations

import numpy as np
import torch

from nerficg_torch.core.config import Configurable
from nerficg_torch.core.tracing import traced
from nerficg_torch.data.types import View
from nerficg_torch.methods.base.renderer import BaseRenderer
from nerficg_torch.methods.gaussian_splatting.model import \
    GaussianSplattingModel
from nerficg_torch.ops.gaussian import gs_frontend
from nerficg_torch.ops.gs_rasterize import rasterize_gaussians

__all__ = ['GaussianSplattingRenderer', 'to_device']


def to_device(values, device: torch.device) -> torch.Tensor:
    """A small host array as an f32 tensor on ``device``. On CUDA it is
    staged through pinned memory and copied in stream order: a copy from
    pageable memory would synchronise the stream, and the host would lose
    its lead over the card at every view."""
    host = torch.as_tensor(np.asarray(values, np.float32))
    if torch.device(device).type != 'cuda':
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


@Configurable.configure(
    MAX_PER_TILE=256,           # front-to-back budget k per 16x16 tile
    MAX_TILES_PER_GAUSSIAN=6,   # linearized rect cover: any <= 6-tile rect
    # TILE_CHUNK and PROJECT_CHUNK are the JAX renderer's TPU memory chunks
    # (tiles per compositor call, Gaussians per frontend map), kept so that
    # both packages write the same config files; the result does not depend
    # on them, and the port runs the compositor and the frontend unchunked.
    TILE_CHUNK=64,
    LOW_PASS_FILTER=0.3,
    PROJECT_CHUNK=262144,
)
class GaussianSplattingRenderer(BaseRenderer):

    MODEL_CLASS = GaussianSplattingModel

    @traced('frontend')
    def frontend(self, params: dict, w2c: torch.Tensor,
                 cam_pos: torch.Tensor, intrinsics: tuple,
                 sh_degree: int) -> dict:
        """Covariances, EWA projection and view-dependent SH color of every
        Gaussian: the rasterizer's inputs (nerficg_tpu :65-85), by
        ``gs_frontend`` (the fused kernels on the card). intrinsics:
        (focal_x, focal_y, center_x, center_y, W, H)."""
        return gs_frontend(params, w2c, cam_pos, intrinsics, sh_degree,
                           low_pass=float(self.LOW_PASS_FILTER))

    def render_impl(self, params: dict, means2d_offset: torch.Tensor,
                    w2c: torch.Tensor, cam_pos: torch.Tensor,
                    intrinsics: tuple, background: torch.Tensor,
                    sh_degree: int, packed_inference: bool = False) -> dict:
        """One render (nerficg_tpu :51-117): the rasterizer's dict plus
        'radii' and 'visible' per Gaussian."""
        inputs = self.frontend(params, w2c, cam_pos, intrinsics, sh_degree)
        inputs['means2d'] = inputs['means2d'] + means2d_offset
        out = rasterize_gaussians(
            **inputs, width=intrinsics[4], height=intrinsics[5],
            background=background,
            max_tiles_per_gaussian=int(self.MAX_TILES_PER_GAUSSIAN),
            max_per_tile=int(self.MAX_PER_TILE),
            packed_inference=packed_inference)
        out['radii'] = inputs['radii']
        out['visible'] = inputs['visible']
        return out

    def view_constants(self, view: View) -> tuple:
        """(intrinsics, w2c (4, 4), camera position (3,)) on the model's
        device."""
        cam = view.camera
        intrinsics = (float(cam.focal_x), float(cam.focal_y),
                      float(cam.center_x), float(cam.center_y),
                      int(cam.width), int(cam.height))
        device = self.model.device
        return (intrinsics, to_device(view.w2c, device),
                to_device(view.position, device))

    @traced('render_image')
    def render_image(self, view: View,
                     benchmark: bool = False) -> dict[str, torch.Tensor]:
        """Serve one view through the packed stream (nerficg_tpu :141-155)."""
        intrinsics, w2c, cam_pos = self.view_constants(view)
        device = self.model.device
        params = self.model.params
        background = to_device(view.camera.background_color, device)
        with torch.no_grad():
            out = self.render_impl(
                params, torch.zeros((self.model.capacity, 2), device=device),
                w2c, cam_pos, intrinsics, background,
                int(self.model.active_sh_degree), packed_inference=True)
        result = {'rgb': torch.clamp(out['rgb'], 0.0, 1.0),
                  'alpha': out['alpha'], 'depth': out['depth']}
        if benchmark and device.type == 'cuda':
            torch.cuda.synchronize(device)
        return result
