"""Index and corner math the three hash encodes share (window, cell,
crossbar), and the bf16 gather and f32 scatter-add of their plain versions:
the Python side of ``nerficg_torch/csrc/hash_common.cuh``.

  * the Instant-NGP hash, the fixed-width brick morton code and the 2^10
    morton sort keys (nerficg_tpu/ops/hash_window.py);
  * the window wrap ``wrap_rel`` and the sub-block padding of the windowed
    encodes (window: 8192 samples, cell: 2048);
  * a level's corner set: the 8 trilinear corners (``trilinear_w``), or
    1/2/4 stochastic ones (``stoch_corners``, nerficg_tpu/ops/
    hash_xbar.py:169-176) drawn from the counter hash of
    ``ops/counter_rng.py``.

``stoch_corners`` takes the three per-dimension 32-bit random words as an
argument (int64 tensors holding uint32 values) instead of calling the TPU's
``pltpu.prng_random_bits``; the words' transform is the JAX one:
``u24 = bits >> 8; u = u24 / 2^24; offset = u < frac``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops.counter_rng import M32, corner_bits

LANES = 128
BRICK_BITS_MAX = 5
DIV_MAX = 0.105
MID_LOAD = 8
CORNERS = tuple((i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1))
_P1 = 2654435761
_P2 = 805459861


# ---------------------------------------------------------------------------
# index math (integer tensors; int64 holds the uint32 hash exactly)
# ---------------------------------------------------------------------------

def pow2_floor(x: int) -> int:
    return 1 << max(int(math.floor(math.log2(max(x, 1)))), 0)


def ngp_hash(vx, vy, vz):
    """uint32 Instant-NGP hash, held in int64."""
    return (vx ^ ((vy * _P1) & M32) ^ ((vz * _P2) & M32)) & M32


def morton3_static(x, y, z):
    """Generalized 3D morton over <= BRICK_BITS_MAX bits per dim."""
    m = torch.zeros_like(x)
    for i in range(BRICK_BITS_MAX):
        m = m | (((x >> i) & 1) << (3 * i + 2))
        m = m | (((y >> i) & 1) << (3 * i + 1))
        m = m | (((z >> i) & 1) << (3 * i))
    return m


def morton_keys_xyz(ux: torch.Tensor, uy: torch.Tensor,
                    uz: torch.Tensor) -> torch.Tensor:
    """Per-axis unit coordinate planes -> int32 morton keys at 2^10."""
    x = torch.clamp((ux * 1024.0).to(torch.int32), 0, 1023)
    y = torch.clamp((uy * 1024.0).to(torch.int32), 0, 1023)
    z = torch.clamp((uz * 1024.0).to(torch.int32), 0, 1023)
    m = torch.zeros_like(x)
    for i in range(10):
        m = m | (((x >> i) & 1) << (3 * i + 2))
        m = m | (((y >> i) & 1) << (3 * i + 1))
        m = m | (((z >> i) & 1) << (3 * i))
    return m


def wrap_rel(rel, win):
    """Fold a row offset into [0, win): floor(rel * (1/win)) in f32, then
    clamp — bit-identical to the oracle (nerficg_tpu hash_window.py:216)."""
    q = torch.floor(rel.float() * torch.reciprocal(win.float()))
    out = rel - q.long() * win
    return torch.minimum(torch.clamp(out, min=0), win - 1)


# ---------------------------------------------------------------------------
# corners of one level
# ---------------------------------------------------------------------------

def trilinear_w(frac, corner):
    w = frac[0] if corner[0] else 1.0 - frac[0]
    w = w * (frac[1] if corner[1] else 1.0 - frac[1])
    return w * (frac[2] if corner[2] else 1.0 - frac[2])


def stoch_corners(frac, bits, n_corners: int):
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
    exact = exact_dims(frac, n_corners)
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


def exact_dims(frac, n_corners: int):
    """The three (...) bool masks of the dims a stochastic corner set
    interpolates exactly: none for 1 corner, argmax m_d for 2, all but
    argmin m_d for 4 (m_d = min(f_d, 1 - f_d), ties to the lowest dim)."""
    if n_corners == 1:
        return [torch.zeros_like(frac[0], dtype=torch.bool)] * 3
    m = [torch.minimum(f, 1.0 - f) for f in frac]
    if n_corners == 2:
        k0 = (m[0] >= m[1]) & (m[0] >= m[2])
        k1 = ~k0 & (m[1] >= m[2])
        return [k0, k1, ~k0 & ~k1]
    if n_corners == 4:
        s0 = (m[0] <= m[1]) & (m[0] <= m[2])
        s1 = ~s0 & (m[1] <= m[2])
        return [~s0, ~s1, s0 | s1]
    raise ValueError(f'n_corners must be 1, 2 or 4, got {n_corners}')


def _level_frac(positions: torch.Tensor, res: int):
    """Base vertex (N, 3) int64 and fraction (N, 3) f32 at resolution res."""
    scaled = positions * (res - 1)
    floor = torch.floor(scaled)
    return floor.long(), scaled - floor


def corner_set(positions: torch.Tensor, res: int, level: int,
               n_corners: int = 0, seed: int = 0):
    """The corners of one level: (vertices (N, C, 3) int64, weights (N, C)
    f32). ``n_corners`` 0: the 8 trilinear corners in ``CORNERS`` order,
    weights multiplied ((wx * wy) * wz) as the kernels do; 1, 2 or 4:
    stochastic corners from the counter-hash words of (seed, level, sample
    index, dim)."""
    base, frac = _level_frac(positions, res)
    frac3 = tuple(frac.unbind(-1))
    if n_corners == 0:
        offs = torch.tensor(CORNERS, dtype=torch.int64,
                            device=positions.device)[None]
        w = torch.stack([trilinear_w(frac3, c) for c in CORNERS], 1)
    else:
        index = torch.arange(positions.shape[0], device=positions.device)
        bits = [corner_bits(seed, level, index, d) for d in range(3)]
        corners, weights = stoch_corners(frac3, bits, n_corners)
        offs = torch.stack([torch.stack(c, -1) for c in corners], 1)
        w = torch.stack(weights, 1)
    return base[:, None, :] + offs, w


def corner_factors(positions: torch.Tensor, res: int, level: int,
                   n_corners: int = 0, seed: int = 0):
    """The corners of one level with their per-dim lerp factors and the
    factors' derivatives in the fraction (``_corner_set``, nerficg_tpu/ops/
    hash_xbar.py:236-296): (vertices (N, C, 3) int64, factors (N, C, 3),
    dfactors (N, C, 3)). Exact corners: factor f or 1 - f, dfactor +1 or -1.
    Stochastic corners (the draws of ``corner_set``): the interpolated dims
    likewise, the Bernoulli-sampled dims factor 1 and dfactor 0 (the
    straight-through position gradient)."""
    verts, _ = corner_set(positions, res, level, n_corners, seed)
    base, frac = _level_frac(positions, res)
    upper = (verts - base[:, None, :]) == 1                  # (N, C, 3)
    f = frac[:, None, :]
    factors = torch.where(upper, f, 1.0 - f)
    dfactors = torch.where(upper, 1.0, -1.0)
    if n_corners:
        exact = torch.stack(exact_dims(tuple(frac.unbind(-1)), n_corners),
                            -1)[:, None, :]
        factors = torch.where(exact, factors, 1.0)
        dfactors = torch.where(exact, dfactors, 0.0)
    return verts, factors, dfactors


# ---------------------------------------------------------------------------
# the plain versions' table reads and writes
# ---------------------------------------------------------------------------

def bf16_planes(table: torch.Tensor) -> torch.Tensor:
    """(L, 2, R, 128) -> (L, 2, R*128), rounded to bf16 as the kernels read."""
    return table.reshape(table.shape[0], 2, -1).to(torch.bfloat16).float()


def gather_sum(flat: torch.Tensor, idx: torch.Tensor,
               w: torch.Tensor) -> torch.Tensor:
    """flat (2, P) bf16-rounded plane; idx/w (N, C) -> (2, N) sum over C."""
    n, c = idx.shape
    g = flat[:, idx.reshape(-1)].reshape(2, n, c)
    return (g * w[None]).sum(-1)


def scatter_planes(levels: int, rows: int, idx_l, vals_l,
                   like: torch.Tensor) -> torch.Tensor:
    """Per level, index_add_ of (2, K) values at (K,) flat indices into a
    zero (L, 2, rows, 128) table."""
    out = torch.zeros((levels, 2, rows * LANES), dtype=torch.float32,
                      device=like.device)
    for lv in range(levels):
        out[lv].index_add_(1, idx_l[lv], vals_l[lv])
    return out.reshape(levels, 2, rows, LANES)


# ---------------------------------------------------------------------------
# sub-block windows of the windowed encodes (window and cell)
# ---------------------------------------------------------------------------

def check_windows(name: str, positions: torch.Tensor, lo: torch.Tensor,
                  win: torch.Tensor, levels: int, sub_block_n: int) -> None:
    n = positions.shape[0]
    if positions.shape != (n, 3) or n % sub_block_n != 0:
        raise KernelError(f'{name}: positions must be (N, 3) with N a '
                          f'multiple of {sub_block_n}, got '
                          f'{tuple(positions.shape)}')
    nsb = n // sub_block_n
    if lo.shape != (levels, nsb) or win.shape != lo.shape:
        raise KernelError(f'{name}: lo/win must be ({levels}, {nsb})')


def pad_positions(positions: torch.Tensor,
                  sub_block_n: int) -> tuple[torch.Tensor, int]:
    """Pad to a multiple of the sub-block (8192 samples for the window
    encode, 2048 for the cell encode) by edge replication (padding repeats
    the last real sample, so windows stay tight). The JAX package also
    rounds batches above 65536 up to its TPU grid tile; the extra
    all-padding sub-blocks change no real sample's window. Returns the
    padded positions and the real count."""
    n = positions.shape[0]
    pad = (-n) % sub_block_n
    if pad:
        positions = torch.cat([positions, positions[-1:].expand(pad, 3)], 0)
    return positions.contiguous(), n


def pad_anchors(anchor_keys: Optional[torch.Tensor], n_raw: int,
                n_padded: int) -> Optional[torch.Tensor]:
    """Pad the per-block anchor keys like pad_positions pads the samples;
    None when they do not evenly tile the sample count."""
    if anchor_keys is None:
        return None
    nb = anchor_keys.shape[0]
    if nb == 0 or n_raw % nb != 0:
        return None
    stride = n_raw // nb
    if n_padded % stride != 0:
        return None
    pad = n_padded // stride - nb
    if pad:
        anchor_keys = torch.cat([anchor_keys, anchor_keys[-1:].expand(pad)])
    return anchor_keys


def pad_cotangent(g: torch.Tensor, n_padded: int) -> torch.Tensor:
    """Zero cotangent for the padding samples, contiguous for the kernels."""
    return torch.nn.functional.pad(g, (0, n_padded - g.shape[1])).contiguous()
