"""Sorted-stream windowed hash encode and its table gradients, ported from
nerficg_tpu/ops/hash_window.py.

The table layout is part of the function and is ported exactly: dense
levels use the linear vertex index; hash levels take the row from the
generalized morton code of the vertex's coarse brick times ``rpb`` plus hash
bits, and the lane from the hash. Each sample's corner rows are wrapped into
the table window ``[lo, lo + win)`` of its 8192-sample sub-block
(``window_bases``), and the table is read rounded to bf16. See the JAX module
for why the layout looks like this.

Kernel wrappers (CUDA tensors launch the kernels of
``nerficg_torch/csrc/hash_window.cu``; CPU tensors take the plain version
beside each, the same function in plain PyTorch):
  * ``hash_window_fwd``: exact 8 corners (TPU kernel #1 ``_fwd_kernel``,
    nerficg_tpu/ops/hash_window.py:468): a block per (2048-sample tile,
    level) stages its sub-block's window in shared memory as bf16x2 words
    where it fits FWD_WIN_ROWS rows, else gathers from the table
    (``window_fwd_paths`` says which);
  * ``hash_window_fwd_stoch``: #1 in stochastic-corner mode, optionally
    saving each corner's flat index and weight;
  * ``hash_window_bwd``: the exact table gradient (#2 ``_bwd_kernel`` :526),
    each sample's 8 corners computed in registers from its position;
  * ``hash_window_bwd_cached``: the table gradient from the saved streams
    (#3 ``_bwd_kernel_cached`` :630).
Both gradients share one accumulation: each level's gradient in shared
memory, BWD_LEVEL_BLOCKS blocks a level, each adding its non-zero quads to
the table; tables of more than BWD_MAX_ROWS rows a level add to the table
directly (``window_bwd_path``).
``hash_encode_win`` and ``hash_encode_win_stochastic`` are the
differentiable entry points (``torch.autograd.Function``s), gradients to the
table only.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import _kernels
from nerficg_torch.ops._hash_common import (BRICK_BITS_MAX, DIV_MAX, LANES,
                                            MID_LOAD, bf16_planes,
                                            check_windows, corner_set,
                                            gather_sum, morton3_static,
                                            morton_keys_xyz, ngp_hash,
                                            pad_anchors, pad_cotangent,
                                            pad_positions, pow2_floor,
                                            scatter_planes, wrap_rel)
from nerficg_torch.ops.counter_rng import M32
from nerficg_torch.ops.hashgrid import HashGridConfig

__all__ = ['WindowLayout', 'window_layout', 'morton_keys_xyz',
           'morton_sort_keys', 'window_bases', 'hash_encode_win',
           'hash_encode_win_stochastic', 'hash_window_fwd',
           'hash_window_fwd_plain', 'hash_window_fwd_stoch',
           'hash_window_fwd_stoch_plain', 'hash_window_bwd',
           'hash_window_bwd_plain', 'hash_window_bwd_cached',
           'hash_window_bwd_cached_plain', 'window_fwd_paths',
           'window_bwd_path', 'SUB_BLOCK']

SUB_BLOCK = 64              # sublanes per window sub-block (64*128 = 8192)
_SB_N = SUB_BLOCK * LANES
_DENSE_MAX = 1 << 18
# The widest window an exact forward block stages in shared memory, in rows
# of 128 bf16x2 words, 512 bytes (kFwdWinRows in csrc/hash_window.cu, which
# says how it was chosen).
FWD_WIN_ROWS = 64
# The table gradients' blocks a level on their level-resident path, and the
# widest level, in rows, that a block keeps in shared memory (kBwdLevelBlocks
# and kBwdMaxRows in csrc/hash_window.cu, which says how they were chosen).
BWD_LEVEL_BLOCKS = 16
BWD_MAX_ROWS = 224


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
            rows = (pts + LANES - 1) // LANES
            res_l.append(r); rows_l.append(rows); dense_l.append(1)
            bscale_l.append(0.0); rpb_l.append(0)
        else:
            rows = cap // LANES
            row_bits = int(math.log2(rows))
            b = max(min(int(math.floor(math.log2(max(
                        DIV_MAX * r / 3.0, 1.0)))),
                        row_bits // 3, BRICK_BITS_MAX), 0)
            if b == 0:
                size = min(cap, max(1 << 12, pow2_floor(r ** 3 // MID_LOAD)))
                rows = size // LANES
            res_l.append(r); rows_l.append(rows); dense_l.append(0)
            bscale_l.append((1 << b) / r)
            rpb_l.append(rows >> (3 * b))
    r_max = max(rows_l)
    r_pad = -(-r_max // LANES) * LANES + LANES
    return WindowLayout(tuple(res_l), tuple(rows_l), tuple(dense_l),
                        tuple(bscale_l), tuple(rpb_l), r_max, r_pad)


# ---------------------------------------------------------------------------
# index math (integer tensors; int64 holds the uint32 hash exactly)
# ---------------------------------------------------------------------------

def _row_lane(vx, vy, vz, res: int, dense: int, bscale: float, rpb: int):
    """Vertex integer coords (int64) -> (row, lane) for one level."""
    if dense:
        lin = vx * (res * res) + vy * res + vz
        return lin >> 7, lin & (LANES - 1)
    # Brick at binary fractions: floor(v * 2^b / res) in f32, as the oracle.
    bs = torch.tensor(bscale, dtype=torch.float32, device=vx.device)
    bx = (vx.float() * bs).long()
    by = (vy.float() * bs).long()
    bz = (vz.float() * bs).long()
    h = ngp_hash(vx, vy, vz)
    row = morton3_static(bx, by, bz) * rpb + ((h >> 7) & (rpb - 1))
    return row, h & (LANES - 1)


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
            pad = (res * res + res + 1) // LANES + 1
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
# corners of one level: plain versions
# ---------------------------------------------------------------------------

def _windowed_index(lay: WindowLayout, lv: int, cc: torch.Tensor,
                    lo: torch.Tensor, win: torch.Tensor) -> torch.Tensor:
    """Corner vertices cc (N, C, 3) int64 of level ``lv`` -> absolute flat
    indices (N, C) into the level's (rows * 128) feature plane."""
    n = cc.shape[0]
    sb_of = torch.arange(n, device=cc.device) // _SB_N
    row, lane = _row_lane(cc[..., 0], cc[..., 1], cc[..., 2], lay.res[lv],
                          lay.dense[lv], lay.bscale[lv], max(lay.rpb[lv], 1))
    lo_s = lo[lv].long()[sb_of][:, None]
    win_s = win[lv].long()[sb_of][:, None]
    return (lo_s + wrap_rel(row - lo_s, win_s)) * LANES + lane


def _exact_corners(positions: torch.Tensor, lay: WindowLayout, lv: int,
                   lo: torch.Tensor, win: torch.Tensor):
    """The 8 trilinear corners: (idx (N, 8) int64, weights (N, 8) f32), the
    weights multiplied in the kernel's order ((wx * wy) * wz)."""
    cc, w = corner_set(positions, lay.res[lv], lv)
    return _windowed_index(lay, lv, cc, lo, win), w


def _stochastic_corners(positions: torch.Tensor, lay: WindowLayout, lv: int,
                        lo: torch.Tensor, win: torch.Tensor, n_corners: int,
                        seed: int):
    """``n_corners`` stochastic corners from the counter-hash words of
    (seed, level, sample index, dim): (idx (N, nc) int64, weights (N, nc))."""
    cc, w = corner_set(positions, lay.res[lv], lv, n_corners, seed)
    return _windowed_index(lay, lv, cc, lo, win), w


def _check_table(name: str, table: torch.Tensor, positions: torch.Tensor,
                 lo: torch.Tensor, win: torch.Tensor,
                 config: HashGridConfig) -> None:
    levels, feats, rows, lanes = table.shape
    if feats != 2 or lanes != LANES or levels != config.num_levels:
        raise KernelError(f'{name}: table must be (L, 2, R, 128), got '
                          f'{tuple(table.shape)}')
    check_windows(name, positions, lo, win, levels, _SB_N)
    if rows < window_layout(config).r_max:
        raise KernelError(f'{name}: table has {rows} rows, layout needs '
                          f'{window_layout(config).r_max}')


@functools.lru_cache(maxsize=8)
def _layout_tensors(config: HashGridConfig, device: torch.device):
    lay = window_layout(config)
    return (torch.tensor(lay.res, dtype=torch.int32, device=device),
            torch.tensor(lay.dense, dtype=torch.int32, device=device),
            torch.tensor(lay.bscale, dtype=torch.float32, device=device),
            torch.tensor([max(r, 1) for r in lay.rpb], dtype=torch.int32,
                         device=device))


# ---------------------------------------------------------------------------
# #1 forward: exact and stochastic
# ---------------------------------------------------------------------------

def hash_window_fwd_plain(table: torch.Tensor, positions: torch.Tensor,
                          lo: torch.Tensor, win: torch.Tensor,
                          config: HashGridConfig) -> torch.Tensor:
    """Plain-PyTorch windowed encode, the jnp oracle ``_fwd_jnp``
    (nerficg_tpu/ops/hash_window.py:379): table (L, 2, R, 128) f32,
    positions (N, 3) sub-block padded, lo/win (L, N/8192) -> (L*2, N)."""
    lay = window_layout(config)
    levels = table.shape[0]
    flat = bf16_planes(table)
    return torch.cat([gather_sum(flat[lv], *_exact_corners(
        positions, lay, lv, lo, win)) for lv in range(levels)], 0)


def hash_window_fwd(table: torch.Tensor, positions: torch.Tensor,
                    lo: torch.Tensor, win: torch.Tensor,
                    config: HashGridConfig) -> torch.Tensor:
    """Windowed encode, exact 8 corners: (L*2, N) feature-major.

    CUDA tensors launch the hand-written kernel; CPU tensors take
    ``hash_window_fwd_plain``. The kernel is fast only for morton-sorted
    samples (``morton_sort_keys``), as every caller of the library passes
    them: their windows are narrow and fit in shared memory. Unsorted
    samples give wide windows, which send most blocks to the gather while
    the staged blocks' shared memory takes the L1 that the gather leans
    on: 2.0x the previous kernel's time at a serving chunk's 196,608
    (0.1790 against 0.0887 ms, PERF.md section 6)."""
    if positions.device.type == 'cpu':
        return hash_window_fwd_plain(table, positions, lo, win, config)
    out = _launch_fwd('hash_window_fwd', table, positions, lo, win, config)
    hash_window_fwd.launches += 1
    return out


hash_window_fwd.launches = 0


def _launch_fwd(name: str, table: torch.Tensor, positions: torch.Tensor,
                lo: torch.Tensor, win: torch.Tensor, config: HashGridConfig,
                lib=None) -> torch.Tensor:
    """Check, allocate and launch ``nerficg_hash_window_fwd`` of the kernel
    library, or of ``lib``, a build of this source with other constants
    (``_kernels.build_variant``)."""
    _kernels.require_cuda(name, table, positions, lo, win,
                          dtypes=(torch.float32, torch.float32, torch.int32,
                                  torch.int32))
    _check_table(name, table, positions, lo, win, config)
    levels, _, rows, _ = table.shape
    n = positions.shape[0]
    res, dense, bscale, rpb = _layout_tensors(config, positions.device)
    out = torch.empty((levels * 2, n), dtype=torch.float32,
                      device=positions.device)
    code = (lib or _kernels.load_library()).nerficg_hash_window_fwd(
        table.data_ptr(), positions.data_ptr(), lo.data_ptr(),
        win.data_ptr(), res.data_ptr(), dense.data_ptr(), bscale.data_ptr(),
        rpb.data_ptr(), out.data_ptr(), levels, n, n // _SB_N, rows,
        _kernels.stream_of(positions))
    _kernels.check(code, name)
    return out


def window_fwd_paths(win: torch.Tensor) -> torch.Tensor:
    """(L, N/8192) bool of ``win``: which (level, sub-block) windows the
    exact forward's blocks stage in shared memory, by the kernel's own
    test: a window of at most FWD_WIN_ROWS rows. Morton-sorted samples
    (the library's) keep every window of a 2^14 table within it; unsorted
    ones send most blocks to the slower gather (``hash_window_fwd``)."""
    return win <= FWD_WIN_ROWS


def window_bwd_path(rows: int) -> str:
    """The path both table gradients (#2, #3) take on a table of ``rows``
    rows a level, by the kernel's own test: 'level' (each level's gradient
    in a block's shared memory, BWD_LEVEL_BLOCKS blocks a level) up to
    BWD_MAX_ROWS rows, the library's 2^14 entries (128 rows) among them;
    else 'global' (atomics into the table), as 2^16 (512 rows) and larger
    tables take."""
    return 'level' if rows <= BWD_MAX_ROWS else 'global'


StochOutput = tuple[torch.Tensor, Optional[torch.Tensor],
                    Optional[torch.Tensor]]


def hash_window_fwd_stoch_plain(table: torch.Tensor, positions: torch.Tensor,
                                lo: torch.Tensor, win: torch.Tensor,
                                config: HashGridConfig, n_corners: int,
                                seed: int, save: bool = False) -> StochOutput:
    """Plain stochastic-corner encode: (out (L*2, N), and with ``save`` the
    corners' absolute flat indices (L, nc, N) int32 and weights (L, nc, N)
    f32, else None, None)."""
    lay = window_layout(config)
    levels = table.shape[0]
    flat = bf16_planes(table)
    outs, idxs, ws = [], [], []
    for lv in range(levels):
        idx, w = _stochastic_corners(positions, lay, lv, lo, win, n_corners,
                                     seed)
        outs.append(gather_sum(flat[lv], idx, w))
        idxs.append(idx.T)
        ws.append(w.T)
    out = torch.cat(outs, 0)
    if not save:
        return out, None, None
    return (out, torch.stack(idxs).to(torch.int32).contiguous(),
            torch.stack(ws).contiguous())


def hash_window_fwd_stoch(table: torch.Tensor, positions: torch.Tensor,
                          lo: torch.Tensor, win: torch.Tensor,
                          config: HashGridConfig, n_corners: int, seed: int,
                          save: bool = False) -> StochOutput:
    """Windowed encode with ``n_corners`` in {1, 2, 4} stochastic corners
    drawn from the uint32 ``seed`` (#1 in stochastic mode); ``save`` also
    returns the per-corner streams the cached backward consumes.

    CUDA tensors launch the hand-written kernel; CPU tensors take
    ``hash_window_fwd_stoch_plain``."""
    if n_corners not in (1, 2, 4):
        raise ValueError(f'n_corners must be 1, 2 or 4, got {n_corners}')
    seed = int(seed) & M32
    if positions.device.type == 'cpu':
        return hash_window_fwd_stoch_plain(table, positions, lo, win, config,
                                           n_corners, seed, save)
    name = 'hash_window_fwd_stoch'
    _kernels.require_cuda(name, table, positions, lo, win,
                          dtypes=(torch.float32, torch.float32, torch.int32,
                                  torch.int32))
    _check_table(name, table, positions, lo, win, config)
    levels, _, rows, _ = table.shape
    n = positions.shape[0]
    device = positions.device
    res, dense, bscale, rpb = _layout_tensors(config, device)
    out = torch.empty((levels * 2, n), dtype=torch.float32, device=device)
    idx = w = None
    if save:
        idx = torch.empty((levels, n_corners, n), dtype=torch.int32,
                          device=device)
        w = torch.empty((levels, n_corners, n), dtype=torch.float32,
                        device=device)
    code = _kernels.load_library().nerficg_hash_window_fwd_stoch(
        table.data_ptr(), positions.data_ptr(), lo.data_ptr(),
        win.data_ptr(), res.data_ptr(), dense.data_ptr(), bscale.data_ptr(),
        rpb.data_ptr(), out.data_ptr(), _kernels.ptr(idx), _kernels.ptr(w),
        levels, n, n // _SB_N, rows, n_corners, seed,
        _kernels.stream_of(positions))
    _kernels.check(code, name)
    hash_window_fwd_stoch.launches += 1
    return out, idx, w


hash_window_fwd_stoch.launches = 0


# ---------------------------------------------------------------------------
# #2 / #3 table gradients
# ---------------------------------------------------------------------------

def hash_window_bwd_plain(g: torch.Tensor, positions: torch.Tensor,
                          lo: torch.Tensor, win: torch.Tensor,
                          config: HashGridConfig, rows: int) -> torch.Tensor:
    """Plain table gradient of the exact encode, the oracle ``_bwd_jnp``
    (nerficg_tpu/ops/hash_window.py:395): g (L*2, N) f32 -> (L, 2, rows,
    128), the f32 products g * w scatter-added at every corner."""
    lay = window_layout(config)
    levels = g.shape[0] // 2
    idx_l, vals_l = [], []
    for lv in range(levels):
        idx, w = _exact_corners(positions, lay, lv, lo, win)
        idx_l.append(idx.reshape(-1))
        vals_l.append((g[2 * lv:2 * lv + 2, :, None] * w[None]).reshape(2, -1))
    return scatter_planes(levels, rows, idx_l, vals_l, g)


def hash_window_bwd(g: torch.Tensor, positions: torch.Tensor,
                    lo: torch.Tensor, win: torch.Tensor,
                    config: HashGridConfig, rows: int) -> torch.Tensor:
    """Table gradient of the exact windowed encode (#2): g (L*2, N)
    feature-major cotangent -> (L, 2, rows, 128). The position cotangent is
    zero, as in the JAX package. The kernel takes ``window_bwd_path(rows)``.

    CUDA tensors launch the hand-written kernel; CPU tensors take
    ``hash_window_bwd_plain``."""
    if g.device.type == 'cpu':
        return hash_window_bwd_plain(g, positions, lo, win, config, rows)
    name = 'hash_window_bwd'
    _kernels.require_cuda(name, g, positions, lo, win,
                          dtypes=(torch.float32, torch.float32, torch.int32,
                                  torch.int32))
    levels = config.num_levels
    check_windows(name, positions, lo, win, levels, _SB_N)
    n = positions.shape[0]
    if g.shape != (levels * 2, n):
        raise KernelError(f'{name}: g must be ({levels * 2}, {n}), got '
                          f'{tuple(g.shape)}')
    if rows < window_layout(config).r_max:
        raise KernelError(f'{name}: {rows} rows, layout needs '
                          f'{window_layout(config).r_max}')
    res, dense, bscale, rpb = _layout_tensors(config, g.device)
    dtab = torch.empty((levels, 2, rows, LANES), dtype=torch.float32,
                       device=g.device)
    code = _kernels.load_library().nerficg_hash_window_bwd(
        g.data_ptr(), positions.data_ptr(), lo.data_ptr(), win.data_ptr(),
        res.data_ptr(), dense.data_ptr(), bscale.data_ptr(), rpb.data_ptr(),
        dtab.data_ptr(), levels, n, n // _SB_N, rows, _kernels.stream_of(g))
    _kernels.check(code, name)
    hash_window_bwd.launches += 1
    return dtab


hash_window_bwd.launches = 0


def hash_window_bwd_cached_plain(g: torch.Tensor, idx: torch.Tensor,
                                 w: torch.Tensor, rows: int) -> torch.Tensor:
    """Plain table gradient from saved corner streams: idx (L, nc, N) flat
    indices, w (L, nc, N) weights, g (L*2, N) -> (L, 2, rows, 128)."""
    levels, nc, n = idx.shape
    g3 = g.reshape(levels, 2, 1, n)
    idx_l = [idx[lv].reshape(-1).long() for lv in range(levels)]
    vals_l = [(g3[lv] * w[lv][None]).reshape(2, nc * n)
              for lv in range(levels)]
    return scatter_planes(levels, rows, idx_l, vals_l, g)


def hash_window_bwd_cached(g: torch.Tensor, idx: torch.Tensor,
                           w: torch.Tensor, rows: int) -> torch.Tensor:
    """Table gradient from the stochastic forward's saved streams (#3).

    CUDA tensors launch the hand-written kernel; CPU tensors take
    ``hash_window_bwd_cached_plain``."""
    if g.device.type == 'cpu':
        return hash_window_bwd_cached_plain(g, idx, w, rows)
    name = 'hash_window_bwd_cached'
    _kernels.require_cuda(name, g, idx, w,
                          dtypes=(torch.float32, torch.int32, torch.float32))
    levels, nc, n = idx.shape
    if w.shape != idx.shape or g.shape != (levels * 2, n):
        raise KernelError(f'{name}: need idx/w (L, nc, N) and g (2L, N), got '
                          f'{tuple(idx.shape)}, {tuple(w.shape)}, '
                          f'{tuple(g.shape)}')
    dtab = torch.empty((levels, 2, rows, LANES), dtype=torch.float32,
                       device=g.device)
    code = _kernels.load_library().nerficg_hash_window_bwd_cached(
        g.data_ptr(), idx.data_ptr(), w.data_ptr(), dtab.data_ptr(), levels,
        n, nc, rows, _kernels.stream_of(g))
    _kernels.check(code, name)
    hash_window_bwd_cached.launches += 1
    return dtab


hash_window_bwd_cached.launches = 0


# ---------------------------------------------------------------------------
# differentiable entry points
# ---------------------------------------------------------------------------

def _windows(positions: torch.Tensor, config: HashGridConfig,
             anchor_keys: Optional[torch.Tensor]):
    """(padded positions, real count, lo, win) of a sorted batch."""
    pos_p, n = pad_positions(positions.detach(), _SB_N)
    ak = pad_anchors(anchor_keys, n, pos_p.shape[0])
    lo, win = window_bases(pos_p, config, anchor_keys=ak)
    return pos_p, n, lo, win


class _HashEncodeWin(torch.autograd.Function):
    """Exact encode; backward is #2 (corners recomputed)."""

    @staticmethod
    def forward(ctx, table, positions, config, anchor_keys):
        pos_p, n, lo, win = _windows(positions, config, anchor_keys)
        ctx.save_for_backward(pos_p, lo, win)
        ctx.config, ctx.rows = config, table.shape[2]
        return hash_window_fwd(table, pos_p, lo, win, config)[:, :n]

    @staticmethod
    def backward(ctx, g):
        pos_p, lo, win = ctx.saved_tensors
        dtab = hash_window_bwd(pad_cotangent(g, pos_p.shape[0]), pos_p, lo,
                               win, ctx.config, ctx.rows)
        return dtab, None, None, None


class _HashEncodeWinStochastic(torch.autograd.Function):
    """Stochastic encode with saved corner streams; backward is #3."""

    @staticmethod
    def forward(ctx, table, positions, seed, config, n_corners, anchor_keys):
        pos_p, n, lo, win = _windows(positions, config, anchor_keys)
        out, idx, w = hash_window_fwd_stoch(table, pos_p, lo, win, config,
                                            n_corners, seed, save=True)
        ctx.save_for_backward(idx, w)
        ctx.rows = table.shape[2]
        return out[:, :n]

    @staticmethod
    def backward(ctx, g):
        idx, w = ctx.saved_tensors
        dtab = hash_window_bwd_cached(pad_cotangent(g, idx.shape[2]), idx, w,
                                      ctx.rows)
        return dtab, None, None, None, None, None


def hash_encode_win(table: torch.Tensor, positions: torch.Tensor,
                    config: HashGridConfig,
                    anchor_keys: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
    """Exact 8-corner windowed encode of morton-sorted positions in [0, 1)
    (nerficg_tpu/ops/hash_window.py:901). Returns feature-major (L*2, N);
    differentiable in ``table``."""
    return _HashEncodeWin.apply(table, positions, config, anchor_keys)


def hash_encode_win_stochastic(table: torch.Tensor, positions: torch.Tensor,
                               seed: int, config: HashGridConfig,
                               n_corners: int = 2,
                               anchor_keys: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """Stochastic-corner windowed encode (nerficg_tpu/ops/hash_window.py:
    949), the training path. A call that records no gradient (the occupancy
    update) skips the saved streams, as the JAX primal path does."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _HashEncodeWinStochastic.apply(table, positions, seed, config,
                                              n_corners, anchor_keys)
    pos_p, n, lo, win = _windows(positions, config, anchor_keys)
    return hash_window_fwd_stoch(table, pos_p, lo, win, config, n_corners,
                                 seed)[0][:, :n]
