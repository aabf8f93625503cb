"""Input encodings, ported from nerficg_tpu/ops/encoding.py: the NeRF
frequency encoding (reference: NeRF/utils.py:12-37), real spherical harmonics
and the 3DGS SH color (tcnn / 3DGS convention, reference:
GaussianSplatting/utils.py:21-59). Elementwise PyTorch, no kernel."""

from __future__ import annotations

import math

import torch

__all__ = ['frequency_encode', 'frequency_encoding_dim', 'sh_encode',
           'eval_sh', 'SH_C0']

SH_C0 = 0.28209479177387814
_SH_C1 = 0.4886025119029199
_SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
          -1.0925484305920792, 0.5462742152960396)
_SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
          0.3731763325901154, -0.4570457994644658, 1.445305721320277,
          -0.5900435899266435)


def frequency_encode(x: torch.Tensor, num_frequencies: int,
                     include_input: bool = True) -> torch.Tensor:
    """NeRF positional encoding (..., D) -> [x, sin(2^k pi x), cos(2^k pi x)]
    with, per frequency k, the D sines then the D cosines, as the JAX
    reshape orders them."""
    if num_frequencies == 0:
        return x
    freqs = (2.0 ** torch.arange(num_frequencies, dtype=torch.float32,
                                 device=x.device)) * math.pi
    scaled = x[..., None, :] * freqs[:, None]               # (..., F, D)
    enc = torch.cat([torch.sin(scaled), torch.cos(scaled)], dim=-1)
    enc = enc.reshape(*x.shape[:-1], -1)
    if include_input:
        enc = torch.cat([x, enc], dim=-1)
    return enc


def frequency_encoding_dim(input_dim: int, num_frequencies: int,
                           include_input: bool = True) -> int:
    return input_dim * (2 * num_frequencies + (1 if include_input else 0))


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


def eval_sh(sh_coeffs: torch.Tensor, directions: torch.Tensor,
            degree: int) -> torch.Tensor:
    """SH color: coefficients (..., K, C) x basis (..., K) -> (..., C) over
    the first degree^2 coefficients; the caller adds the 3DGS +0.5."""
    basis = sh_encode(directions, degree)
    k = degree * degree
    return torch.einsum('...kc,...k->...c', sh_coeffs[..., :k, :],
                        basis[..., :k])
