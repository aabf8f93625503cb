"""Conical frustums as Gaussians and the scene contraction, for Mip-NeRF
360 (Barron et al., CVPR 2022, §2; mip-NeRF, ICCV 2021, §3.1 and App. A).

``conical_frustum_gaussians`` gives the mean and full covariance of the
cone of a pixel between two distances along each ray (mip-NeRF's stable
form in t_mu and t_d); ``contract_gaussians`` pushes them through
contract(x) = x inside the unit ball, (2 - 1/|x|) x/|x| outside, the
covariance linearised at the mean (J cov J^T). Plain PyTorch, no kernel;
nothing here needs a gradient (the distances are detached samples).
"""

from __future__ import annotations

import torch

__all__ = ['conical_frustum_gaussians', 'contract', 'contract_jacobian',
           'contract_gaussians']

_EPS = float(torch.finfo(torch.float32).eps)


def conical_frustum_gaussians(origins: torch.Tensor, directions: torch.Tensor,
                              radii: torch.Tensor, t0: torch.Tensor,
                              t1: torch.Tensor
                              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Origins and directions (R, 3), base radii (R,) and interval ends
    t0, t1 (R, S) -> means (R, S, 3) and covariances (R, S, 3, 3).

    With t_mu = (t0 + t1)/2, t_d = (t1 - t0)/2 and q = 3 t_mu^2 + t_d^2:
    mu_t = t_mu + 2 t_mu t_d^2 / q, the variance along the ray
    t_d^2/3 - (4/15) t_d^4 (12 t_mu^2 - t_d^2) / q^2, across it
    r^2 (t_mu^2/4 + (5/12) t_d^2 - (4/15) t_d^4 / q); the covariance is
    s_t^2 d d^T + s_r^2 (I - d d^T / |d|^2)."""
    t_mu = 0.5 * (t0 + t1)
    t_d = 0.5 * (t1 - t0)
    t_mu2, t_d2 = t_mu * t_mu, t_d * t_d
    q = torch.clamp(3.0 * t_mu2 + t_d2, min=_EPS)
    mu_t = t_mu + 2.0 * t_mu * t_d2 / q
    var_t = t_d2 / 3.0 - (4.0 / 15.0) * t_d2 * t_d2 * \
        (12.0 * t_mu2 - t_d2) / (q * q)
    var_r = (radii * radii)[:, None] * (
        t_mu2 / 4.0 + (5.0 / 12.0) * t_d2 - (4.0 / 15.0) * t_d2 * t_d2 / q)
    means = origins[:, None, :] + mu_t[..., None] * directions[:, None, :]
    outer = directions[:, :, None] * directions[:, None, :]         # (R, 3, 3)
    mag2 = torch.clamp((directions * directions).sum(-1), min=1e-10)
    eye = torch.eye(3, dtype=directions.dtype, device=directions.device)
    null = eye - outer / mag2[:, None, None]
    covs = var_t[..., None, None] * outer[:, None] + \
        var_r[..., None, None] * null[:, None]
    return means, covs


def contract(x: torch.Tensor) -> torch.Tensor:
    """x where |x| <= 1, else (2 - 1/|x|) x/|x|, over the last axis."""
    mag2 = torch.clamp((x * x).sum(-1, keepdim=True), min=_EPS)
    mag = torch.sqrt(mag2)
    return torch.where(mag2 <= 1.0, x, (2.0 * mag - 1.0) / mag2 * x)


def contract_jacobian(x: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> the Jacobian of ``contract`` at x, (..., 3, 3): I inside
    the unit ball, (2n - 1)/n^2 I - 2 (n - 1)/n^4 x x^T outside (n = |x|)."""
    mag2 = torch.clamp((x * x).sum(-1), min=_EPS)
    mag = torch.sqrt(mag2)
    inside = mag2 <= 1.0
    a = torch.where(inside, 1.0, (2.0 * mag - 1.0) / mag2)
    b = torch.where(inside, 0.0, 2.0 * (mag - 1.0) / (mag2 * mag2))
    eye = torch.eye(3, dtype=x.dtype, device=x.device)
    return a[..., None, None] * eye - \
        b[..., None, None] * (x[..., :, None] * x[..., None, :])


def contract_gaussians(means: torch.Tensor, covs: torch.Tensor
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Means (..., 3) and covariances (..., 3, 3) through ``contract``:
    (contracted means, J cov J^T, whether each mean lies outside the unit
    ball)."""
    jac = contract_jacobian(means)
    covs = jac @ covs @ jac.transpose(-1, -2)
    outside = (means * means).sum(-1) > 1.0
    return contract(means), covs, outside
