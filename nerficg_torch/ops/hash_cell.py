"""Cell-packed windowed hash encode and its table gradient, ported from
nerficg_tpu/ops/hash_cell.py.

The hashed unit is the cell (its base vertex), not the corner vertex: all 8
corner features of a cell live at table rows ``base_row*8 + c`` of one lane,
so a sample computes one address per level. Coarse levels store cells
densely (linear index ``(x*side + y)*side + z``, side = res - 1); finer
levels take the brick-morton row (right-shifted by ``rsh`` when bricks
outnumber rows) times ``rpb`` plus hash bits, with mid levels that allow no
locality on a shrunk full-scan table. Each sample's base row is wrapped
into the window ``[lo, lo + win)`` of its 2048-sample sub-block
(``cell_window_bases``), and the table is read rounded to bf16.
Interpolation is always exact trilinear. The layout is part of the function
and is ported exactly; see the JAX module for why it looks like this.

Kernel wrappers (CUDA tensors launch the kernels of
``nerficg_torch/csrc/hash_cell.cu``; CPU tensors take the plain version):
  * ``hash_cell_fwd``: TPU kernel #8 ``_fwd_kernel``
    (nerficg_tpu/ops/hash_cell.py:380): a block per (sub-block, level)
    gathers its samples' corners from the table;
  * ``hash_cell_bwd``: the table gradient, #9 ``_bwd_kernel`` (:441): a
    block per (sub-block, level) keeps its window's gradient in shared
    memory where the window fits BWD_WIN_ROWS base rows, else adds to the
    table with global atomics (``cell_bwd_paths`` says which).
``hash_encode_cell`` is the differentiable entry point, gradients to the
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
from nerficg_torch.ops.hashgrid import HashGridConfig

__all__ = ['CELL_SUB_BLOCK', 'CellLayout', 'cell_layout', 'cell_window_bases',
           'hash_encode_cell', 'hash_cell_fwd', 'hash_cell_fwd_plain',
           'hash_cell_bwd', 'hash_cell_bwd_plain', 'cell_bwd_paths']

CELL_SUB_BLOCK = 16         # sublanes per window sub-block (16*128 = 2048)
_SB_N = CELL_SUB_BLOCK * LANES
_DENSE_CELL_MAX = 1 << 18
# Shared memory of one base row of a backward window: 8 rows x 128 lanes x
# 2 features of f32 (kWinRowBytes in csrc/hash_cell.cu).
WIN_ROW_BYTES = 8 * LANES * 2 * 4
# The widest window a backward block keeps in shared memory, in base rows
# (kWinRows in csrc/hash_cell.cu, which says how it was chosen): 64 KiB.
BWD_WIN_ROWS = 8


class CellLayout(NamedTuple):
    """Static per-level layout (python tuples). Rows count BASE rows: a
    level occupies ``base_rows * 8`` table rows (row = base_row*8 + c)."""
    res: tuple            # level resolution (vertex grid side)
    base_rows: tuple      # cell-slot rows (128 slots each)
    dense: tuple          # 1 = dense linear cell indexing, 0 = hashed
    bscale: tuple         # 2^b / (res-1): brick_d = floor(cell_d * bscale)
    rpb: tuple            # base rows per brick
    rsh: tuple            # brick-morton right shift onto rows
    r_pad: int            # padded table rows (multiple of 128, +128 margin)


@functools.lru_cache(maxsize=None)
def cell_layout(config: HashGridConfig) -> CellLayout:
    """Per-level cell layout (nerficg_tpu/ops/hash_cell.py:109-152)."""
    cap = config.table_size
    if cap % 1024 != 0:
        raise ValueError('cell layout needs table_size % 1024 == 0')
    res_l, brows_l, dense_l, bscale_l, rpb_l, rsh_l = [], [], [], [], [], []
    for r in config.level_resolutions():
        cells = (r - 1) ** 3 if r < 4096 else _DENSE_CELL_MAX
        if cells * 8 <= min(_DENSE_CELL_MAX, cap):
            brows = (cells + LANES - 1) // LANES
            res_l.append(r); brows_l.append(brows); dense_l.append(1)
            bscale_l.append(0.0); rpb_l.append(0); rsh_l.append(0)
        else:
            brows = cap // 1024
            brow_bits = int(math.log2(brows)) if brows > 1 else 0
            side = r - 1
            b = max(min(BRICK_BITS_MAX,
                        int(math.floor(math.log2(max(
                            DIV_MAX * side / 3.0, 1.0))))), 0)
            if b == 0:
                # Mid level: a full-scan hash level on a shrunk table.
                slots = min(cap // 8,
                            max(1 << 12, pow2_floor(cells // MID_LOAD)))
                brows = slots // LANES
            rsh = max(3 * b - brow_bits, 0) if b else 0
            rpb = max(brows >> (3 * b), 1) if b else brows
            res_l.append(r); brows_l.append(brows); dense_l.append(0)
            bscale_l.append((1 << b) / side)
            rpb_l.append(rpb); rsh_l.append(rsh)
    r_max = max(br * 8 for br in brows_l)
    r_pad = -(-r_max // LANES) * LANES + LANES
    return CellLayout(tuple(res_l), tuple(brows_l), tuple(dense_l),
                      tuple(bscale_l), tuple(rpb_l), tuple(rsh_l), r_pad)


def _cell_base_row_lane(vx, vy, vz, res: int, dense: int, bscale: float,
                        rpb: int, rsh: int):
    """Cell base-vertex coords (int64) -> (base_row, lane) for one level
    (nerficg_tpu/ops/hash_cell.py:189-216). The brick scale multiplies in
    f32, as JAX applies the Python float to an f32 array; the hash wraps as
    uint32 (the TPU kernel's int32 products give the same bits)."""
    if dense:
        side = res - 1
        lin = (vx * side + vy) * side + vz
        return lin >> 7, lin & (LANES - 1)
    bs = torch.tensor(bscale, dtype=torch.float32, device=vx.device)
    bx = (vx.float() * bs).long()
    by = (vy.float() * bs).long()
    bz = (vz.float() * bs).long()
    h = ngp_hash(vx, vy, vz)
    row = (morton3_static(bx, by, bz) >> rsh) * rpb + ((h >> 7) & (rpb - 1))
    return row, h & (LANES - 1)


def _level_args(lay: CellLayout, lv: int):
    return (lay.res[lv], lay.dense[lv], lay.bscale[lv], max(lay.rpb[lv], 1),
            lay.rsh[lv])


def cell_window_bases(positions: torch.Tensor, config: HashGridConfig,
                      anchor_keys: Optional[torch.Tensor] = None
                      ) -> tuple[torch.Tensor, torch.Tensor]:
    """Per (level, sub-block) base-row windows for a morton-sorted batch
    (nerficg_tpu/ops/hash_cell.py:219-278): hash levels take the
    sub-block's anchor-key range with a +-1-brick margin, dense levels the
    exact base-row range. positions: (N, 3) unit, N a multiple of 2048.
    Returns (lo, win), each (L, N/2048) int32, lo + win <= base rows."""
    lay = cell_layout(config)
    n = positions.shape[0]
    if n % _SB_N != 0:
        raise ValueError('positions must be padded to the sub-block size')
    nsb = n // _SB_N
    stride = max(int(getattr(config, 'anchor_stride', 1)), 1)
    if anchor_keys is not None and anchor_keys.shape[0] % nsb == 0:
        anchors = anchor_keys.reshape(nsb, -1).long()
    else:
        keys = morton_keys_xyz(positions[:, 0], positions[:, 1],
                               positions[:, 2]).long()
        if stride > 1 and _SB_N % stride == 0:
            anchors = keys.reshape(nsb, _SB_N // stride, stride)[:, :, 0]
        else:
            anchors = keys.reshape(nsb, _SB_N)
    kmin, kmax = anchors.amin(1), anchors.amax(1)
    lo_l, win_l = [], []
    for lv in range(len(lay.res)):
        side = lay.res[lv] - 1
        if lay.dense[lv]:
            v = torch.clamp((positions * side).long(), 0, side - 1)
            lin = (v[:, 0] * side + v[:, 1]) * side + v[:, 2]
            rb = (lin >> 7).reshape(nsb, _SB_N)
            lo, hi = rb.amin(1), rb.amax(1)
        else:
            rpb, rsh = lay.rpb[lv], lay.rsh[lv]
            b = round(math.log2(max(lay.bscale[lv] * side, 1.0)))
            shift = 3 * (10 - b)
            lo = (((kmin >> shift) - 1) >> rsh) * rpb
            hi = ((((kmax >> shift) + 2) >> rsh) + 1) * rpb - 1
        lo = torch.clamp(lo, min=0)
        win = torch.clamp(hi, max=lay.base_rows[lv] - 1) - lo + 1
        lo_l.append(lo)
        win_l.append(win)
    return (torch.stack(lo_l).to(torch.int32),
            torch.stack(win_l).to(torch.int32))


# ---------------------------------------------------------------------------
# plain versions (the oracle _fwd_jnp / _bwd_jnp, :316-356)
# ---------------------------------------------------------------------------

def _cell_corners(positions: torch.Tensor, lay: CellLayout, lv: int,
                  lo: torch.Tensor, win: torch.Tensor):
    """Flat indices (N, 8) int64 of one level's corners, at rows
    (wrapped base_row)*8 + c of the cell's lane, and their trilinear
    weights (N, 8) in ``CORNERS`` order."""
    cc, w = corner_set(positions, lay.res[lv], lv)
    base = cc[:, 0]
    row, lane = _cell_base_row_lane(base[:, 0], base[:, 1], base[:, 2],
                                    *_level_args(lay, lv))
    sb_of = torch.arange(positions.shape[0], device=positions.device) // _SB_N
    lo_s = lo[lv].long()[sb_of]
    win_s = win[lv].long()[sb_of]
    brow = lo_s + wrap_rel(row - lo_s, win_s)
    corner = torch.arange(8, device=positions.device)
    return ((brow * 8)[:, None] + corner[None]) * LANES + lane[:, None], w


def _check_rows(name: str, rows: int, config: HashGridConfig) -> None:
    need = max(br * 8 for br in cell_layout(config).base_rows)
    if rows < need:
        raise KernelError(f'{name}: table has {rows} rows, layout needs '
                          f'{need}')


@functools.lru_cache(maxsize=8)
def _layout_tensors(config: HashGridConfig, device: torch.device):
    lay = cell_layout(config)
    return (torch.tensor(lay.res, dtype=torch.int32, device=device),
            torch.tensor(lay.dense, dtype=torch.int32, device=device),
            torch.tensor(lay.bscale, dtype=torch.float32, device=device),
            torch.tensor([max(r, 1) for r in lay.rpb], dtype=torch.int32,
                         device=device),
            torch.tensor(lay.rsh, dtype=torch.int32, device=device))


def hash_cell_fwd_plain(table: torch.Tensor, positions: torch.Tensor,
                        lo: torch.Tensor, win: torch.Tensor,
                        config: HashGridConfig) -> torch.Tensor:
    """Plain cell encode: table (L, 2, R, 128) f32 read as bf16, positions
    (N, 3) sub-block padded, lo/win (L, N/2048) -> feature-major (L*2, N)."""
    lay = cell_layout(config)
    flat = bf16_planes(table)
    return torch.cat([gather_sum(flat[lv], *_cell_corners(
        positions, lay, lv, lo, win)) for lv in range(table.shape[0])], 0)


def hash_cell_fwd(table: torch.Tensor, positions: torch.Tensor,
                  lo: torch.Tensor, win: torch.Tensor,
                  config: HashGridConfig) -> torch.Tensor:
    """Cell encode, exact 8 corners (#8): (L*2, N) feature-major.

    CUDA tensors launch the hand-written kernel; CPU tensors take
    ``hash_cell_fwd_plain``."""
    if positions.device.type == 'cpu':
        return hash_cell_fwd_plain(table, positions, lo, win, config)
    out = _launch_fwd('hash_cell_fwd', table, positions, lo, win, config)
    hash_cell_fwd.launches += 1
    return out


hash_cell_fwd.launches = 0


def _launch_fwd(name: str, table: torch.Tensor, positions: torch.Tensor,
                lo: torch.Tensor, win: torch.Tensor,
                config: HashGridConfig) -> torch.Tensor:
    """Check, allocate and launch ``nerficg_hash_cell_fwd``."""
    _kernels.require_cuda(name, table, positions, lo, win,
                          dtypes=(torch.float32, torch.float32, torch.int32,
                                  torch.int32))
    levels, feats, rows, lanes = table.shape
    if feats != 2 or lanes != LANES or levels != config.num_levels:
        raise KernelError(f'{name}: table must be (L, 2, R, 128), got '
                          f'{tuple(table.shape)}')
    check_windows(name, positions, lo, win, levels, _SB_N)
    _check_rows(name, rows, config)
    n = positions.shape[0]
    res, dense, bscale, rpb, rsh = _layout_tensors(config, positions.device)
    out = torch.empty((levels * 2, n), dtype=torch.float32,
                      device=positions.device)
    code = _kernels.load_library().nerficg_hash_cell_fwd(
        table.data_ptr(), positions.data_ptr(), lo.data_ptr(),
        win.data_ptr(), res.data_ptr(), dense.data_ptr(), bscale.data_ptr(),
        rpb.data_ptr(), rsh.data_ptr(), out.data_ptr(), levels, n,
        n // _SB_N, rows, _kernels.stream_of(positions))
    _kernels.check(code, name)
    return out


def cell_bwd_paths(win: torch.Tensor,
                   global_levels: tuple = ()) -> torch.Tensor:
    """(L, N/2048) bool of ``win``: which (level, sub-block) blocks of the
    table gradient keep their window in shared memory, by the kernel's own
    test: a window of at most BWD_WIN_ROWS base rows, on a level not in
    ``global_levels`` (forced onto the global path)."""
    forced = torch.tensor([lv in global_levels for lv in range(win.shape[0])],
                          device=win.device)
    return (win <= BWD_WIN_ROWS) & ~forced[:, None]


def hash_cell_bwd_plain(g: torch.Tensor, positions: torch.Tensor,
                        lo: torch.Tensor, win: torch.Tensor,
                        config: HashGridConfig, rows: int) -> torch.Tensor:
    """Plain table gradient: g (L*2, N) f32 -> (L, 2, rows, 128), the f32
    products g * w scatter-added at every corner (the oracle sums in f32;
    the TPU kernel rounds g * w to bf16 for its MXU)."""
    lay = cell_layout(config)
    levels = g.shape[0] // 2
    idx_l, vals_l = [], []
    for lv in range(levels):
        idx, w = _cell_corners(positions, lay, lv, lo, win)
        idx_l.append(idx.reshape(-1))
        vals_l.append((g[2 * lv:2 * lv + 2, :, None] * w[None]).reshape(2, -1))
    return scatter_planes(levels, rows, idx_l, vals_l, g)


def hash_cell_bwd(g: torch.Tensor, positions: torch.Tensor,
                  lo: torch.Tensor, win: torch.Tensor,
                  config: HashGridConfig, rows: int,
                  global_levels: tuple = ()) -> torch.Tensor:
    """Table gradient of the cell encode (#9): g (L*2, N) feature-major
    cotangent -> (L, 2, rows, 128).

    CUDA tensors launch the hand-written kernel, with the levels of
    ``global_levels`` forced onto its global path (to test that path on
    levels whose windows fit); CPU tensors take ``hash_cell_bwd_plain``."""
    if g.device.type == 'cpu':
        return hash_cell_bwd_plain(g, positions, lo, win, config, rows)
    name = 'hash_cell_bwd'
    _kernels.require_cuda(name, g, positions, lo, win,
                          dtypes=(torch.float32, torch.float32, torch.int32,
                                  torch.int32))
    levels = config.num_levels
    check_windows(name, positions, lo, win, levels, _SB_N)
    n = positions.shape[0]
    if g.shape != (levels * 2, n):
        raise KernelError(f'{name}: g must be ({levels * 2}, {n}), got '
                          f'{tuple(g.shape)}')
    _check_rows(name, rows, config)
    if any(not 0 <= lv < min(levels, 32) for lv in global_levels):
        raise KernelError(f'{name}: global_levels {global_levels} outside '
                          f'the {levels} levels')
    global_mask = sum(1 << lv for lv in set(global_levels))
    res, dense, bscale, rpb, rsh = _layout_tensors(config, g.device)
    dtab = torch.empty((levels, 2, rows, LANES), dtype=torch.float32,
                       device=g.device)
    code = _kernels.load_library().nerficg_hash_cell_bwd(
        g.data_ptr(), positions.data_ptr(), lo.data_ptr(), win.data_ptr(),
        res.data_ptr(), dense.data_ptr(), bscale.data_ptr(), rpb.data_ptr(),
        rsh.data_ptr(), dtab.data_ptr(), levels, n, n // _SB_N, rows,
        global_mask, _kernels.stream_of(g))
    _kernels.check(code, name)
    hash_cell_bwd.launches += 1
    return dtab


hash_cell_bwd.launches = 0


# ---------------------------------------------------------------------------
# differentiable entry point
# ---------------------------------------------------------------------------

class _HashEncodeCell(torch.autograd.Function):
    """Exact cell encode; backward is #9 (corners recomputed)."""

    @staticmethod
    def forward(ctx, table, positions, config, anchor_keys):
        pos_p, n = pad_positions(positions.detach(), _SB_N)
        ak = pad_anchors(anchor_keys, n, pos_p.shape[0])
        lo, win = cell_window_bases(pos_p, config, anchor_keys=ak)
        ctx.save_for_backward(pos_p, lo, win)
        ctx.config, ctx.rows = config, table.shape[2]
        return hash_cell_fwd(table, pos_p, lo, win, config)[:, :n]

    @staticmethod
    def backward(ctx, g):
        pos_p, lo, win = ctx.saved_tensors
        dtab = hash_cell_bwd(pad_cotangent(g, pos_p.shape[0]), pos_p, lo,
                             win, ctx.config, ctx.rows)
        return dtab, None, None, None


def hash_encode_cell(table: torch.Tensor, positions: torch.Tensor,
                     config: HashGridConfig,
                     anchor_keys: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Exact 8-corner cell-packed encode of morton-sorted positions in
    [0, 1) (nerficg_tpu/ops/hash_cell.py:674; unsorted inputs stay correct,
    their windows just widen). ``anchor_keys``: the marcher's monotone
    per-block sort keys. Returns feature-major (L*2, N); differentiable in
    ``table``. The cell encode has no stochastic mode: the model ignores
    its encode seed."""
    return _HashEncodeCell.apply(table, positions, config, anchor_keys)
