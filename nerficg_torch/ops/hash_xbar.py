"""Stochastic trilinear corners, ported from nerficg_tpu/ops/hash_xbar.py
(``_trilinear_w`` :169 and ``_stoch_corners`` :176). The crossbar encode
kernels of that module (#10-#12) are not ported yet.

``_stoch_corners`` takes the three per-dimension 32-bit random words as an
argument (int64 tensors holding uint32 values) instead of calling the TPU's
``pltpu.prng_random_bits``; the words' transform is the JAX one:
``u24 = bits >> 8; u = u24 / 2^24; offset = u < frac``.
"""

from __future__ import annotations

import torch

__all__ = ['_trilinear_w', '_stoch_corners']


def _trilinear_w(frac, corner):
    w = frac[0] if corner[0] else 1.0 - frac[0]
    w = w * (frac[1] if corner[1] else 1.0 - frac[1])
    return w * (frac[2] if corner[2] else 1.0 - frac[2])


def _stoch_corners(frac, bits, n_corners: int):
    """Variance-reduced stochastic trilinear interpolation.

    frac: three (...) f32 tensors; bits: three int64 tensors of uint32
    words. log2(n_corners) dimensions, the ones with the largest
    m_d = min(f_d, 1 - f_d), are interpolated exactly; the others take
    corner ~ Bernoulli(f_d). Unbiased for the trilinear interpolation for
    n in {1, 2, 4}. Returns (corners, weights): ``n_corners`` triples of
    int64 offsets and their partial-lerp weights."""
    offs = [((bits[d] >> 8).to(torch.float32) * (1.0 / 16777216.0)
             < frac[d]).long() for d in range(3)]
    if n_corners == 1:
        return [tuple(offs)], [torch.ones_like(frac[0])]
    m = [torch.minimum(f, 1.0 - f) for f in frac]
    if n_corners == 2:
        # exact dim = argmax m
        k0 = (m[0] >= m[1]) & (m[0] >= m[2])
        k1 = ~k0 & (m[1] >= m[2])
        exact = [k0, k1, ~k0 & ~k1]
    elif n_corners == 4:
        # stochastic dim = argmin m; exact = the other two
        s0 = (m[0] <= m[1]) & (m[0] <= m[2])
        s1 = ~s0 & (m[1] <= m[2])
        exact = [~s0, ~s1, s0 | s1]
    else:
        raise ValueError(f'n_corners must be 1, 2 or 4, got {n_corners}')
    # Each exact dim takes the enumeration bit of its rank among the exact
    # dims (0 = lowest dim index).
    first = [exact[0], exact[1] & ~exact[0],
             exact[2] & ~exact[0] & ~exact[1]]
    n_bits = 1 if n_corners == 2 else 2
    corners, weights = [], []
    for c in range(n_corners):
        bit = [(c >> 0) & 1, (c >> 1) & 1]
        corner, w = [], torch.ones_like(frac[0])
        for d in range(3):
            enum_d = torch.where(first[d], bit[0], bit[n_bits - 1])
            o_d = torch.where(exact[d], enum_d, offs[d])
            w_d = torch.where(o_d == 1, frac[d], 1.0 - frac[d])
            w = w * torch.where(exact[d], w_d, 1.0)
            corner.append(o_d)
        corners.append(tuple(corner))
        weights.append(w)
    return corners, weights
