"""Volume-rendering integration on a dense (rays, samples) layout, the
port of nerficg_tpu/ops/compositing.py (reference: NeRF/utils.py:112-136 and
the CUDA composite kernels, VolumeRenderingV2/csrc/volumerendering.cu).
Transmittance is an exclusive cumulative product; early termination is a
mask on it. Mip-NeRF 360's interlevel loss binds a proposal histogram to
the NeRF one. Plain PyTorch; gradients come from autograd."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ['densities_to_weights', 'composite_rays', 'distortion_loss',
           'interlevel_bound', 'interlevel_loss']


def densities_to_weights(densities: torch.Tensor, deltas: torch.Tensor,
                         mask: Optional[torch.Tensor] = None,
                         early_stop_eps: float = 0.0) -> torch.Tensor:
    """(R, S) densities and segment lengths -> weights T_i * alpha_i with
    alpha_i = 1 - exp(-sigma_i delta_i) and T_i = prod_{j<i}(1 - alpha_j +
    1e-10). Invalid samples (``mask`` 0) contribute nothing; with
    ``early_stop_eps`` > 0, samples whose transmittance is at or below it
    neither (the CUDA early termination at T <= 1e-4)."""
    alpha = 1.0 - torch.exp(-densities * deltas)
    if mask is not None:
        alpha = alpha * mask
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    if early_stop_eps > 0.0:
        alpha = alpha * (trans > early_stop_eps)
    return trans * alpha


def composite_rays(rgb: torch.Tensor, densities: torch.Tensor,
                   depths: torch.Tensor, deltas: torch.Tensor,
                   background: Optional[torch.Tensor] = None,
                   mask: Optional[torch.Tensor] = None,
                   early_stop_eps: float = 0.0) -> dict:
    """Front-to-back compositing: rgb (R, S, 3), densities, depths and
    deltas (R, S), background (3,) or (R, 3) blended by the residual
    transmittance. Returns 'rgb' (R, 3), 'depth' (R, 1) (the weighted mean,
    over max(acc, 1e-10)), 'alpha' (R, 1) and 'weights' (R, S)."""
    weights = densities_to_weights(densities, deltas, mask, early_stop_eps)
    acc = weights.sum(-1, keepdim=True)
    out_rgb = torch.einsum('rs,rsc->rc', weights, rgb)
    depth = (weights * depths).sum(-1, keepdim=True) / \
        torch.clamp(acc, min=1e-10)
    if background is not None:
        background = torch.as_tensor(background, dtype=out_rgb.dtype,
                                     device=out_rgb.device)
        out_rgb = out_rgb + (1.0 - acc) * background
    return {'rgb': out_rgb, 'depth': depth, 'alpha': acc, 'weights': weights}


def distortion_loss(weights: torch.Tensor, depths: torch.Tensor,
                    deltas: torch.Tensor,
                    mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """MipNeRF360 distortion loss per ray, in its O(S) prefix-sum form
    (reference: VolumeRenderingV2/csrc/losses.cu:10-174):
    2 sum_i w_i (m_i A_{i-1} - B_{i-1}) + 1/3 sum_i w_i^2 d_i with
    ``depths`` the interval midpoints m, A = cumsum(w), B = cumsum(w m)."""
    if mask is not None:
        weights = weights * mask
    mids = depths
    w_cum = torch.cumsum(weights, -1)
    wm_cum = torch.cumsum(weights * mids, -1)
    w_prev = w_cum - weights
    wm_prev = wm_cum - weights * mids
    loss_bi = 2.0 * (weights * (mids * w_prev - wm_prev)).sum(-1)
    loss_uni = (1.0 / 3.0) * (weights * weights * deltas).sum(-1)
    return loss_bi + loss_uni


def interlevel_bound(edges: torch.Tensor, env_edges: torch.Tensor,
                     env_weights: torch.Tensor) -> torch.Tensor:
    """For each interval of ``edges`` (R, S+1), the sum of the weights
    ``env_weights`` (R, M) of the intervals of ``env_edges`` (R, M+1)
    that overlap it: [a_j, a_j+1) overlaps [c_i, c_i+1] where
    a_j <= c_i+1 and a_j+1 > c_i (Mip-NeRF 360's outer measure, eq. 13).
    Returns (R, S)."""
    cum = torch.cat([torch.zeros_like(env_weights[:, :1]),
                     torch.cumsum(env_weights, -1)], -1)          # (R, M+1)
    last = env_edges.shape[-1] - 1
    above = torch.searchsorted(env_edges.contiguous(), edges.contiguous(),
                               right=True)
    lo = torch.clamp(above - 1, 0, last)
    hi = torch.clamp(above, 0, last)
    return torch.gather(cum, -1, hi[:, 1:]) - torch.gather(cum, -1, lo[:, :-1])


def interlevel_loss(edges: torch.Tensor, weights: torch.Tensor,
                    env_edges: torch.Tensor, env_weights: torch.Tensor
                    ) -> torch.Tensor:
    """Per ray, sum_i max(0, w_i - bound_i)^2 / (w_i + eps) with bound_i
    the proposal weights over NeRF interval i (``interlevel_bound``); the
    NeRF's ``edges`` and ``weights`` are held fixed (stop-gradient), so
    the loss trains the proposal alone. eps: float32's machine epsilon.
    Returns (R,)."""
    edges, weights = edges.detach(), weights.detach()
    bound = interlevel_bound(edges, env_edges, env_weights)
    eps = torch.finfo(torch.float32).eps
    return (torch.clamp(weights - bound, min=0.0) ** 2 /
            (weights + eps)).sum(-1)
