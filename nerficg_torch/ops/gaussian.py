"""3D Gaussian math: covariances, EWA projection, culling.

Port of nerficg_tpu/ops/gaussian.py (reference: the projection half of
diff-gaussian-rasterization). Batched PyTorch over all Gaussians; no kernel.
"""

from __future__ import annotations

import torch

__all__ = ['quaternion_to_rotation', 'build_covariance_3d',
           'project_gaussians']


def quaternion_to_rotation(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) wxyz (normalized by the caller) -> (..., 3, 3)."""
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)


def build_covariance_3d(scales: torch.Tensor,
                        rotations: torch.Tensor) -> torch.Tensor:
    """(N, 3) scales + (N, 4) unit quaternions -> (N, 3, 3) covariances
    R S S^T R^T."""
    m = quaternion_to_rotation(rotations) * scales[:, None, :]
    return m @ m.transpose(-1, -2)


def project_gaussians(means3d: torch.Tensor, cov3d: torch.Tensor,
                      w2c: torch.Tensor, focal_x: float, focal_y: float,
                      center_x: float, center_y: float, width: int,
                      height: int, near: float = 0.01,
                      low_pass: float = 0.3) -> dict:
    """EWA splatting projection (nerficg_tpu/ops/gaussian.py:41-106):
    means2d (N, 2) pixels, depths (N,), conics (N, 3) inverse 2D covariance
    (a, b, c), radii (N,) 3-sigma pixel radius (0 where culled), in_frustum
    (N,) bool."""
    cam = means3d @ w2c[:3, :3].T + w2c[:3, 3]
    x, y, z = cam[..., 0], cam[..., 1], cam[..., 2]
    in_front = z > near
    z_safe = torch.clamp(z, min=near)
    px = x / z_safe * focal_x + center_x
    py = y / z_safe * focal_y + center_y
    # Jacobian of the projection with the tan-fov clamp of the reference
    # kernel at the frustum edge.
    lim_x = 1.3 * (0.5 * width / focal_x)
    lim_y = 1.3 * (0.5 * height / focal_y)
    tx = torch.clamp(x / z_safe, -lim_x, lim_x) * z_safe
    ty = torch.clamp(y / z_safe, -lim_y, lim_y) * z_safe
    zero = torch.zeros_like(z_safe)
    j_row0 = torch.stack([focal_x / z_safe, zero,
                          -focal_x * tx / (z_safe ** 2)], -1)
    j_row1 = torch.stack([zero, focal_y / z_safe,
                          -focal_y * ty / (z_safe ** 2)], -1)
    jac = torch.stack([j_row0, j_row1], dim=-2)                # (N, 2, 3)
    t = jac @ w2c[:3, :3]
    cov2d = t @ cov3d @ t.transpose(-1, -2)
    a = cov2d[..., 0, 0] + low_pass
    b = cov2d[..., 0, 1]
    c = cov2d[..., 1, 1] + low_pass
    det = a * c - b * b
    det_safe = torch.clamp(det, min=1e-12)
    conics = torch.stack([c / det_safe, -b / det_safe, a / det_safe], dim=-1)
    mid = 0.5 * (a + c)
    eig1 = mid + torch.sqrt(torch.clamp(mid * mid - det, min=0.1))
    radii = torch.ceil(3.0 * torch.sqrt(torch.clamp(eig1, min=0.0)))
    visible = in_front & (det > 0) & (px + radii > 0) & \
        (px - radii < width) & (py + radii > 0) & (py - radii < height)
    return {'means2d': torch.stack([px, py], dim=-1), 'depths': z,
            'conics': conics, 'radii': torch.where(visible, radii, 0.0),
            'in_frustum': visible}
