"""Sorted-stream windowed hash encode (forward), ported from
nerficg_tpu/ops/hash_window.py.

The table layout is part of the function and is ported exactly: dense
levels use the linear vertex index; hash levels take the row from the
generalized morton code of the vertex's coarse brick times ``rpb`` plus hash
bits, and the lane from the hash. Each sample's corner rows are wrapped into
the table window ``[lo, lo + win)`` of its 8192-sample sub-block
(``window_bases``), and the table is read rounded to bf16. See the JAX module
for why the layout looks like this.

``hash_window_fwd`` is the kernel wrapper: for CUDA tensors it launches the
CUDA kernel in ``nerficg_torch/csrc/hash_window.cu`` (which replaces the TPU
kernel ``_fwd_kernel``, nerficg_tpu/ops/hash_window.py:468); for CPU tensors
it runs ``hash_window_fwd_plain``, the same function in plain PyTorch. Only
the forward is ported: rendering needs no table gradient.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import _kernels
from nerficg_torch.ops.hashgrid import HashGridConfig

__all__ = ['WindowLayout', 'window_layout', 'morton_keys_xyz',
           'morton_sort_keys', 'window_bases', 'hash_encode_win',
           'hash_window_fwd', 'hash_window_fwd_plain', 'SUB_BLOCK']

_LANES = 128
SUB_BLOCK = 64              # sublanes per window sub-block (64*128 = 8192)
_SB_N = SUB_BLOCK * _LANES
_P1 = 2654435761
_P2 = 805459861
_M32 = 0xFFFFFFFF
_CORNERS = tuple((i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1))
_BRICK_BITS_MAX = 5
_DENSE_MAX = 1 << 18
_DIV_MAX = 0.105
_MID_LOAD = 8


class WindowLayout(NamedTuple):
    """Static per-level layout (python tuples)."""
    res: tuple            # level resolution (vertex grid side)
    rows: tuple           # 128-lane rows of this level's table
    dense: tuple          # 1 = dense linear indexing, 0 = locality hash
    bscale: tuple         # 2^b / res (f32): brick_d = floor(v_d * bscale)
    rpb: tuple            # rows per brick = rows >> 3b (hash levels, pow2)
    r_max: int            # max rows over levels
    r_pad: int            # padded rows (multiple of 128, +128 margin)


@functools.lru_cache(maxsize=None)
def window_layout(config: HashGridConfig) -> WindowLayout:
    """Per-level table layout (nerficg_tpu/ops/hash_window.py:86-126)."""
    cap = config.table_size
    res_l, rows_l, dense_l, bscale_l, rpb_l = [], [], [], [], []
    for r in config.level_resolutions():
        pts = r ** 3 if r < 4096 else cap + 1
        if pts <= min(cap, _DENSE_MAX):
            rows = (pts + _LANES - 1) // _LANES
            res_l.append(r); rows_l.append(rows); dense_l.append(1)
            bscale_l.append(0.0); rpb_l.append(0)
        else:
            rows = cap // _LANES
            row_bits = int(math.log2(rows))
            b = max(min(int(math.floor(math.log2(max(
                        _DIV_MAX * r / 3.0, 1.0)))),
                        row_bits // 3, _BRICK_BITS_MAX), 0)
            if b == 0:
                size = min(cap, max(1 << 12, _pow2_floor(r ** 3 // _MID_LOAD)))
                rows = size // _LANES
            res_l.append(r); rows_l.append(rows); dense_l.append(0)
            bscale_l.append((1 << b) / r)
            rpb_l.append(rows >> (3 * b))
    r_max = max(rows_l)
    r_pad = -(-r_max // _LANES) * _LANES + _LANES
    return WindowLayout(tuple(res_l), tuple(rows_l), tuple(dense_l),
                        tuple(bscale_l), tuple(rpb_l), r_max, r_pad)


def _pow2_floor(x: int) -> int:
    return 1 << max(int(math.floor(math.log2(max(x, 1)))), 0)


# ---------------------------------------------------------------------------
# index math (integer tensors; int64 holds the uint32 hash exactly)
# ---------------------------------------------------------------------------

def _morton3_static(x, y, z):
    """Generalized 3D morton over <= _BRICK_BITS_MAX bits per dim."""
    m = torch.zeros_like(x)
    for i in range(_BRICK_BITS_MAX):
        m = m | (((x >> i) & 1) << (3 * i + 2))
        m = m | (((y >> i) & 1) << (3 * i + 1))
        m = m | (((z >> i) & 1) << (3 * i))
    return m


def _ngp_hash(vx, vy, vz):
    """uint32 Instant-NGP hash, held in int64."""
    return (vx ^ ((vy * _P1) & _M32) ^ ((vz * _P2) & _M32)) & _M32


def _row_lane(vx, vy, vz, res: int, dense: int, bscale: float, rpb: int):
    """Vertex integer coords (int64) -> (row, lane) for one level."""
    if dense:
        lin = vx * (res * res) + vy * res + vz
        return lin >> 7, lin & (_LANES - 1)
    # Brick at binary fractions: floor(v * 2^b / res) in f32, as the oracle.
    bs = torch.tensor(bscale, dtype=torch.float32, device=vx.device)
    bx = (vx.float() * bs).long()
    by = (vy.float() * bs).long()
    bz = (vz.float() * bs).long()
    h = _ngp_hash(vx, vy, vz)
    row = _morton3_static(bx, by, bz) * rpb + ((h >> 7) & (rpb - 1))
    return row, h & (_LANES - 1)


def _wrap_rel(rel, win):
    """Fold a row offset into [0, win): floor(rel * (1/win)) in f32, then
    clamp — bit-identical to the oracle (nerficg_tpu hash_window.py:216)."""
    q = torch.floor(rel.float() * torch.reciprocal(win.float()))
    out = rel - q.long() * win
    return torch.minimum(torch.clamp(out, min=0), win - 1)


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


def morton_sort_keys(positions_unit: torch.Tensor) -> torch.Tensor:
    """(N, 3) unit positions -> (N,) int32 morton keys at 2^10 resolution."""
    return morton_keys_xyz(positions_unit[..., 0], positions_unit[..., 1],
                           positions_unit[..., 2])


def window_bases(positions: torch.Tensor, config: HashGridConfig,
                 anchor_keys: Optional[torch.Tensor] = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per (level, sub-block) scan windows for a morton-sorted batch
    (nerficg_tpu/ops/hash_window.py:248-328).

    positions: (N, 3) unit, N a multiple of 8192. Returns (lo, win), each
    (L, N/8192) int32, lo 8-aligned and lo + win <= rows."""
    lay = window_layout(config)
    n = positions.shape[0]
    if n % _SB_N != 0:
        raise ValueError('positions must be padded to the sub-block size')
    nsb = n // _SB_N
    if anchor_keys is not None and anchor_keys.shape[0] % nsb == 0:
        anchors = anchor_keys.reshape(nsb, -1)
        kmin, kmax = anchors.amin(1).long(), anchors.amax(1).long()
    else:
        keys = morton_sort_keys(positions).long()
        stride = max(int(getattr(config, 'anchor_stride', 1)), 1)
        if stride > 1 and _SB_N % stride == 0:
            anchors = keys.reshape(nsb, _SB_N // stride, stride)[:, :, 0]
        else:
            anchors = keys.reshape(nsb, _SB_N)
        kmin, kmax = anchors.amin(1), anchors.amax(1)
    lo_l, win_l = [], []
    for lv in range(len(lay.res)):
        rows, res = lay.rows[lv], lay.res[lv]
        if lay.dense[lv]:
            v = torch.clamp((positions * (res - 1)).long(), 0, res - 1)
            row, _ = _row_lane(v[:, 0], v[:, 1], v[:, 2], res, 1, 0.0, 1)
            rb = row.reshape(nsb, _SB_N)
            pad = (res * res + res + 1) // _LANES + 1
            lo = rb.amin(1)
            hi = rb.amax(1) + pad
        else:
            rpb = max(lay.rpb[lv], 1)
            b = round(math.log2(max(lay.bscale[lv] * res, 1.0)))
            shift = 3 * (10 - b)
            lo = ((kmin >> shift) - 1) * rpb
            hi = ((kmax >> shift) + 2) * rpb - 1
        lo = torch.clamp(lo - lo % 8, min=0)
        win = torch.clamp(hi, max=rows - 1) - lo + 1
        lo_l.append(lo)
        win_l.append(win)
    return (torch.stack(lo_l).to(torch.int32),
            torch.stack(win_l).to(torch.int32))


# ---------------------------------------------------------------------------
# the encode: plain version and kernel wrapper
# ---------------------------------------------------------------------------

def hash_window_fwd_plain(table: torch.Tensor, positions: torch.Tensor,
                          lo: torch.Tensor, win: torch.Tensor,
                          config: HashGridConfig) -> torch.Tensor:
    """Plain-PyTorch windowed encode, the jnp oracle ``_fwd_jnp``
    (nerficg_tpu/ops/hash_window.py:379): table (L, 2, R, 128) f32,
    positions (N, 3) sub-block padded, lo/win (L, N/8192) -> (L*2, N)."""
    lay = window_layout(config)
    levels = table.shape[0]
    n = positions.shape[0]
    device = positions.device
    sb_of = torch.arange(n, device=device) // _SB_N
    corners = torch.tensor(_CORNERS, dtype=torch.int64, device=device)
    flat = table.reshape(levels, 2, -1).to(torch.bfloat16).float()
    outs = []
    for lv in range(levels):
        res = lay.res[lv]
        scaled = positions * (res - 1)
        floor = torch.floor(scaled)
        frac = scaled - floor
        cc = floor.long()[:, None, :] + corners[None]             # (N, 8, 3)
        w = torch.where(corners[None] > 0, frac[:, None, :],
                        1.0 - frac[:, None, :]).prod(-1)           # (N, 8)
        row, lane = _row_lane(cc[..., 0], cc[..., 1], cc[..., 2], res,
                              lay.dense[lv], lay.bscale[lv],
                              max(lay.rpb[lv], 1))
        lo_s = lo[lv].long()[sb_of][:, None]
        win_s = win[lv].long()[sb_of][:, None]
        idx = (lo_s + _wrap_rel(row - lo_s, win_s)) * _LANES + lane
        g = flat[lv][:, idx.reshape(-1)].reshape(2, n, 8)
        outs.append((g * w[None]).sum(-1))
    return torch.cat(outs, 0)


@functools.lru_cache(maxsize=8)
def _layout_tensors(config: HashGridConfig, device: torch.device):
    lay = window_layout(config)
    return (torch.tensor(lay.res, dtype=torch.int32, device=device),
            torch.tensor(lay.dense, dtype=torch.int32, device=device),
            torch.tensor(lay.bscale, dtype=torch.float32, device=device),
            torch.tensor([max(r, 1) for r in lay.rpb], dtype=torch.int32,
                         device=device))


def hash_window_fwd(table: torch.Tensor, positions: torch.Tensor,
                    lo: torch.Tensor, win: torch.Tensor,
                    config: HashGridConfig) -> torch.Tensor:
    """Windowed encode, exact 8 corners: (L*2, N) feature-major.

    CUDA tensors launch the hand-written kernel; CPU tensors take
    ``hash_window_fwd_plain``."""
    if positions.device.type == 'cpu':
        return hash_window_fwd_plain(table, positions, lo, win, config)
    name = 'hash_window_fwd'
    _kernels.require_cuda(name, table, positions, lo, win,
                          dtypes=(torch.float32, torch.float32, torch.int32,
                                  torch.int32))
    levels, feats, rows, lanes = table.shape
    n = positions.shape[0]
    if feats != 2 or lanes != _LANES or levels != config.num_levels:
        raise KernelError(f'{name}: table must be (L, 2, R, 128), got '
                          f'{tuple(table.shape)}')
    if positions.shape != (n, 3) or n % _SB_N != 0:
        raise KernelError(f'{name}: positions must be (N, 3) with N a '
                          f'multiple of {_SB_N}, got {tuple(positions.shape)}')
    if lo.shape != (levels, n // _SB_N) or win.shape != lo.shape:
        raise KernelError(f'{name}: lo/win must be ({levels}, {n // _SB_N})')
    if rows < window_layout(config).r_max:
        raise KernelError(f'{name}: table has {rows} rows, layout needs '
                          f'{window_layout(config).r_max}')
    res, dense, bscale, rpb = _layout_tensors(config, positions.device)
    out = torch.empty((levels * 2, n), dtype=torch.float32,
                      device=positions.device)
    code = _kernels.load_library().nerficg_hash_window_fwd(
        table.data_ptr(), positions.data_ptr(), lo.data_ptr(),
        win.data_ptr(), res.data_ptr(), dense.data_ptr(), bscale.data_ptr(),
        rpb.data_ptr(), out.data_ptr(), levels, n, n // _SB_N, rows,
        _kernels.stream_of(positions))
    _kernels.check(code, name)
    hash_window_fwd.launches += 1
    return out


hash_window_fwd.launches = 0


def _prep(positions: torch.Tensor) -> tuple[torch.Tensor, int]:
    """Pad to the 8192-sample sub-block multiple by edge replication
    (padding repeats the last real sample, so windows stay tight). The JAX
    package also rounds batches above 65536 up to its TPU grid tile; the
    extra all-padding sub-blocks change no real sample's window."""
    n = positions.shape[0]
    pad = (-n) % _SB_N
    if pad:
        positions = torch.cat([positions, positions[-1:].expand(pad, 3)], 0)
    return positions.contiguous(), n


def _prep_anchors(anchor_keys: Optional[torch.Tensor], n_raw: int,
                  n_padded: int) -> Optional[torch.Tensor]:
    """Pad the per-block anchor keys like _prep pads the samples; None when
    they do not evenly tile the sample count."""
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


def hash_encode_win(table: torch.Tensor, positions: torch.Tensor,
                    config: HashGridConfig,
                    anchor_keys: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Exact 8-corner windowed encode of morton-sorted positions in [0, 1)
    (nerficg_tpu/ops/hash_window.py:901). Returns feature-major (L*2, N)."""
    pos_p, n = _prep(positions)
    ak = _prep_anchors(anchor_keys, positions.shape[0], pos_p.shape[0])
    lo, win = window_bases(pos_p, config, anchor_keys=ak)
    return hash_window_fwd(table, pos_p, lo, win, config)[:, :n]
