"""Real spherical-harmonics direction encoding, ported from
nerficg_tpu/ops/encoding.py (tcnn / 3DGS convention, reference:
GaussianSplatting/utils.py:21-59). Elementwise PyTorch, no kernel."""

from __future__ import annotations

import torch

__all__ = ['sh_encode', 'SH_C0']

SH_C0 = 0.28209479177387814
_SH_C1 = 0.4886025119029199
_SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
          -1.0925484305920792, 0.5462742152960396)
_SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
          0.3731763325901154, -0.4570457994644658, 1.445305721320277,
          -0.5900435899266435)


def sh_encode(directions: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """Unit directions (..., 3) -> SH basis values (..., degree^2)."""
    x, y, z = directions[..., 0], directions[..., 1], directions[..., 2]
    out = [torch.full_like(x, SH_C0)]
    if degree > 1:
        out += [-_SH_C1 * y, _SH_C1 * z, -_SH_C1 * x]
    if degree > 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        out += [_SH_C2[0] * xy, _SH_C2[1] * yz,
                _SH_C2[2] * (2.0 * zz - xx - yy),
                _SH_C2[3] * xz, _SH_C2[4] * (xx - yy)]
    if degree > 3:
        out += [_SH_C3[0] * y * (3.0 * xx - yy),
                _SH_C3[1] * xy * z,
                _SH_C3[2] * y * (4.0 * zz - xx - yy),
                _SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                _SH_C3[4] * x * (4.0 * zz - xx - yy),
                _SH_C3[5] * z * (xx - yy),
                _SH_C3[6] * x * (xx - 3.0 * yy)]
    return torch.stack(out, dim=-1)
