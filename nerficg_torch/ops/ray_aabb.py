"""Ray/AABB and ray/sphere intersection, ported from
nerficg_tpu/ops/ray_aabb.py (reference: VolumeRenderingV2/csrc/
intersection.cu:5-196). Elementwise PyTorch, no kernel."""

from __future__ import annotations

import torch

__all__ = ['ray_aabb_intersect', 'ray_sphere_intersect']


def ray_aabb_intersect(origins: torch.Tensor, directions: torch.Tensor,
                       aabb_min: torch.Tensor, aabb_max: torch.Tensor,
                       min_near: float = 0.0
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """Slab-test entry and exit t per ray; t_near > t_far marks a miss.
    Direction components below 1e-10 in magnitude are clamped to +-1e-10
    (the sign of a zero is +)."""
    tiny = torch.where(directions >= 0, 1e-10, -1e-10)
    inv_dir = 1.0 / torch.where(directions.abs() < 1e-10, tiny, directions)
    t0 = (aabb_min - origins) * inv_dir
    t1 = (aabb_max - origins) * inv_dir
    t_near = torch.clamp(torch.minimum(t0, t1).amax(-1), min=min_near)
    t_far = torch.maximum(t0, t1).amin(-1)
    return t_near, t_far


def ray_sphere_intersect(origins: torch.Tensor, directions: torch.Tensor,
                         center: torch.Tensor, radius: float,
                         min_near: float = 0.0
                         ) -> tuple[torch.Tensor, torch.Tensor]:
    """Analytic entry and exit t; a miss gives (max(1, min_near), 0)."""
    oc = origins - center
    b = (oc * directions).sum(-1)
    c = (oc * oc).sum(-1) - radius * radius
    disc = b * b - c
    sqrt_disc = torch.sqrt(torch.clamp(disc, min=0.0))
    hit = disc >= 0
    t_near = torch.where(hit, -b - sqrt_disc, 1.0)
    t_far = torch.where(hit, -b + sqrt_disc, 0.0)
    return torch.clamp(t_near, min=min_near), t_far
