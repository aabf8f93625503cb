"""Full-table ("crossbar") hash encode, ported from
nerficg_tpu/ops/hash_xbar.py; its corner math (shared with the window and
cell encodes) is in ``ops/_hash_common.py``.

The crossbar encode reads the whole (L, 2, R, 128) table. Its layout
(``level_layout`` :73-93): a level is dense when its (res+1)^3 vertices fit
the table, indexed ``x + y*(res+1) + z*(res+1)^2``; otherwise it takes the
Instant-NGP hash masked to ``rows*128 - 1``. Output is sample-major
(N, L*2). Kernel wrappers (CUDA tensors launch the kernels of
``nerficg_torch/csrc/hash_xbar.cu``; CPU tensors take the plain version):
  * ``hash_xbar_fwd``: exact 8 corners or 1/2/4 stochastic corners (TPU
    kernel #10 ``_fwd_kernel`` :303), optionally saving each corner's flat
    index and weight: a level-resident kernel (a block per (sample tile,
    two levels) with the levels' bf16x2 tables in shared memory) where
    they fit and the call is large enough to repay the staging, the gather
    kernel otherwise (``xbar_fwd_plan``); the two give the same bits;
  * ``hash_xbar_bwd``: the table gradient of either (#11 ``_bwd_kernel``
    :394), recomputing the corners from the same counter hash, so the
    gradient lands on the corners the forward read;
  * ``hash_xbar_bwd_pos``: the position gradient d(encode)/d(unit position)
    (#12 ``_bwd_pos_kernel`` :537), exact, or straight-through on the same
    stochastic corners (interpolated dims only);
  * ``hash_xbar_bwd_fused``: both gradients from one pass over the
    corners, one call (D-NeRF's backward).
All three reach one C entry: a level-resident kernel (a block per (sample
tile, level) with the level's table and gradient in shared memory) where
the largest level fits a block's shared memory, the gather kernels past
that; ``xbar_bwd_plan`` chooses from the shapes alone.
``hash_encode_xbar`` and ``hash_encode_xbar_stochastic`` are the
differentiable entry points with gradients to the table only;
``hash_encode_xbar_posgrad`` and ``hash_encode_xbar_stochastic_posgrad``
(:812, :842) also return the position gradient, for deformation fields
(D-NeRF).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import _kernels
from nerficg_torch.ops._hash_common import (LANES, bf16_planes,
                                            corner_factors, corner_set,
                                            gather_sum, ngp_hash,
                                            scatter_planes)
from nerficg_torch.ops.counter_rng import M32
from nerficg_torch.ops.hashgrid import HashGridConfig

__all__ = ['level_layout', 'hash_encode_xbar', 'hash_encode_xbar_stochastic',
           'hash_encode_xbar_posgrad', 'hash_encode_xbar_stochastic_posgrad',
           'hash_xbar_fwd', 'hash_xbar_fwd_plain', 'hash_xbar_bwd',
           'hash_xbar_bwd_plain', 'hash_xbar_bwd_pos',
           'hash_xbar_bwd_pos_plain',
           'hash_xbar_bwd_fused', 'hash_xbar_bwd_fused_plain',
           'xbar_bwd_plan', 'xbar_fwd_plan', 'xbar_corners']

# ---------------------------------------------------------------------------
# crossbar layout and corner indices
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def level_layout(config: HashGridConfig):
    """Per-level (res - 1 as float, rows, dense) and the largest row count
    (nerficg_tpu/ops/hash_xbar.py:73-93)."""
    cap = config.table_size
    res_m1, rows, dense = [], [], []
    for r in config.level_resolutions():
        pts = (r + 1) ** 3 if r < 2048 else cap + 1
        if pts <= cap:
            dense.append(1)
            rows.append((pts + LANES - 1) // LANES)
        else:
            dense.append(0)
            rows.append(cap // LANES)
        res_m1.append(float(r - 1))
    return tuple(res_m1), tuple(rows), tuple(dense), max(rows)


def xbar_corners(positions: torch.Tensor, config: HashGridConfig, level: int,
                 n_corners: int = 0, seed: int = 0):
    """Flat table indices (N, C) int64 and weights (N, C) of one level's
    corners (``_level_indices_jnp`` :683 for exact corners)."""
    res = int(level_layout(config)[0][level]) + 1
    cc, w = corner_set(positions, res, level, n_corners, seed)
    return _flat_index(cc, config, level), w


def _flat_index(verts: torch.Tensor, config: HashGridConfig,
                level: int) -> torch.Tensor:
    """Flat index into one level's plane of the vertices (..., 3)."""
    res_m1, rows, dense, _ = level_layout(config)
    x, y, z = verts.unbind(-1)
    if dense[level]:
        res1 = int(res_m1[level]) + 2
        return x + y * res1 + z * (res1 * res1)
    return ngp_hash(x, y, z) & (rows[level] * LANES - 1)


def _check_corners(n_corners: int) -> None:
    if n_corners not in (0, 1, 2, 4):
        raise ValueError(f'n_corners must be 0, 1, 2 or 4, got {n_corners}')


@functools.lru_cache(maxsize=8)
def _layout_tensors(config: HashGridConfig, device: torch.device):
    res_m1, rows, dense, _ = level_layout(config)
    return (torch.tensor(res_m1, dtype=torch.float32, device=device),
            torch.tensor(rows, dtype=torch.int32, device=device),
            torch.tensor(dense, dtype=torch.int32, device=device))


def _check_table(name: str, table_rows: int, levels: int, n_pos: tuple,
                 config: HashGridConfig) -> None:
    if levels != config.num_levels:
        raise KernelError(f'{name}: {levels} levels, config has '
                          f'{config.num_levels}')
    if len(n_pos) != 2 or n_pos[1] != 3:
        raise KernelError(f'{name}: positions must be (N, 3), got {n_pos}')
    r_max = level_layout(config)[3]
    if table_rows < r_max:
        raise KernelError(f'{name}: table has {table_rows} rows, layout '
                          f'needs {r_max}')


# ---------------------------------------------------------------------------
# #10 forward, #11 table gradient
# ---------------------------------------------------------------------------

def hash_xbar_fwd_plain(table: torch.Tensor, positions: torch.Tensor,
                        config: HashGridConfig, n_corners: int = 0,
                        seed: int = 0, save: bool = False):
    """Plain crossbar encode, the oracle ``_fwd_jnp`` (:708) for exact
    corners: table (L, 2, R, 128) f32 read as bf16, positions (N, 3) ->
    sample-major (N, L*2); with ``save`` also the corners' flat indices
    (L, C, N) int32 and weights (L, C, N) f32."""
    flat = bf16_planes(table)
    outs, idxs, ws = [], [], []
    for lv in range(table.shape[0]):
        idx, w = xbar_corners(positions, config, lv, n_corners, seed)
        outs.append(gather_sum(flat[lv], idx, w))
        idxs.append(idx.T)
        ws.append(w.T)
    out = torch.cat(outs, 0).T.contiguous()
    if not save:
        return out
    return (out, torch.stack(idxs).to(torch.int32).contiguous(),
            torch.stack(ws).contiguous())


@functools.lru_cache(maxsize=None)
def _card_limits(index: int) -> tuple[int, int]:
    """(SMs, shared-memory bytes a block may opt in to) of card ``index``."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


# The level-resident forward's block: its threads and the levels it owns
# (kFwdThreads and kFwdLevels in csrc/hash_xbar.cu).
FWD_THREADS = 1024
FWD_LEVELS = 2
# Calls of fewer samples take the forward's gather path: below this many, a
# block's staging of its levels costs more than the gathers it saves.
# Measured by `kernel_timing.py xbar-fwd` (its crossover lines, exact
# corners, 2^14 table) on an H100 80GB HBM3 at 700 W: 2,048 samples, gather
# 0.0043 ms against resident 0.0065; 4,096, 0.0063 against 0.0064 (a tie);
# 8,192, resident 0.0065 against 0.0162 (PERF.md section 6).
FWD_MIN_SAMPLES = 4096


class XbarFwdPlan(NamedTuple):
    """How the forward runs: ``path`` 'resident' or 'gather', the sample
    ``tiles`` of the resident grid (0 on the gather path), the largest
    level's ``level_rows`` and the dynamic ``smem_bytes`` a resident block
    asks for."""
    path: str
    tiles: int
    level_rows: int
    smem_bytes: int


def xbar_fwd_plan(config: HashGridConfig, n: int, sms: int = 132,
                  smem_per_block: int = 232_448, threads: int = FWD_THREADS,
                  group: int = FWD_LEVELS,
                  min_samples: int = FWD_MIN_SAMPLES) -> XbarFwdPlan:
    """The forward's launch plan, from the shapes and the card's limits (by
    default an H100's): the resident path when ``group`` levels' bf16x2
    tables (4 bytes per entry of the largest level) fit one block's shared
    memory and ``n`` is at least ``min_samples``, with one wave of blocks
    (as many as an SM holds by the kernel's launch bounds, times ``sms``)
    and
    no more tiles than chunks of ``threads`` samples; else the gather path.
    ``threads`` and ``group`` are the kernel's constants (a variant built
    with others passes its own)."""
    level_rows = level_layout(config)[3]
    smem = group * level_rows * LANES * 4
    levels = config.num_levels
    if smem > smem_per_block or n < min_samples or levels % group:
        return XbarFwdPlan('gather', 0, level_rows, 0)
    # An SM holds the opt-in maximum plus the 1 KiB each block reserves;
    # the kernel's launch bounds (kFwdMinBlocks) ask for no more blocks than
    # three levels' tables or 1536 threads.
    per_sm = max(1, min((smem_per_block + 1024) // (smem + 1024),
                        3 // group, 1536 // threads))
    tiles = max(1, min(sms * per_sm // (levels // group), -(-n // threads)))
    return XbarFwdPlan('resident', tiles, level_rows, smem)


def _launch_fwd(name: str, table: torch.Tensor, positions: torch.Tensor,
                config: HashGridConfig, n_corners: int, seed: int,
                save: bool, lib=None, plan=None):
    """Check, allocate and launch ``nerficg_hash_xbar_fwd`` (of ``lib``, by
    default the port's library) on ``plan`` (by default ``xbar_fwd_plan``'s
    for these shapes and this card): (out, save_idx or None, save_w or
    None)."""
    _kernels.require_cuda(name, table, positions,
                          dtypes=(torch.float32, torch.float32))
    levels, feats, rows, lanes = table.shape
    if feats != 2 or lanes != LANES:
        raise KernelError(f'{name}: table must be (L, 2, R, 128), got '
                          f'{tuple(table.shape)}')
    _check_table(name, rows, levels, tuple(positions.shape), config)
    n = positions.shape[0]
    if plan is None:
        plan = xbar_fwd_plan(config, n, *_card_limits(positions.get_device()))
    res_m1, lrows, dense = _layout_tensors(config, positions.device)
    out = positions.new_empty((n, levels * 2))
    idx = w = None
    if save:
        corners = n_corners or 8
        idx = torch.empty((levels, corners, n), dtype=torch.int32,
                          device=positions.device)
        w = positions.new_empty((levels, corners, n))
    lib = lib or _kernels.load_library()
    code = lib.nerficg_hash_xbar_fwd(
        table.data_ptr(), positions.data_ptr(), res_m1.data_ptr(),
        lrows.data_ptr(), dense.data_ptr(), out.data_ptr(), _kernels.ptr(idx),
        _kernels.ptr(w), levels, n, rows, plan.level_rows, plan.tiles,
        n_corners, seed, _kernels.stream_of(positions))
    _kernels.check(code, name)
    return out, idx, w


def hash_xbar_fwd(table: torch.Tensor, positions: torch.Tensor,
                  config: HashGridConfig, n_corners: int = 0,
                  seed: int = 0, save: bool = False):
    """Crossbar encode, exact (``n_corners`` 0) or with 1, 2 or 4
    stochastic corners drawn from the uint32 ``seed`` (#10): (N, L*2), and
    with ``save`` the corner streams of ``hash_xbar_fwd_plain``.

    CUDA tensors launch the hand-written kernel on the path
    ``xbar_fwd_plan`` chooses; CPU tensors take ``hash_xbar_fwd_plain``."""
    _check_corners(n_corners)
    seed = int(seed) & M32
    if positions.device.type == 'cpu':
        return hash_xbar_fwd_plain(table, positions, config, n_corners, seed,
                                   save)
    out = _launch_fwd('hash_xbar_fwd', table, positions, config, n_corners,
                      seed, save)
    hash_xbar_fwd.launches += 1
    return out if save else out[0]


hash_xbar_fwd.launches = 0


def hash_xbar_bwd_plain(g: torch.Tensor, positions: torch.Tensor,
                        config: HashGridConfig, rows: int,
                        n_corners: int = 0, seed: int = 0) -> torch.Tensor:
    """Plain table gradient, the oracle ``_bwd_jnp`` (:721) for exact
    corners: g (N, L*2) -> (L, 2, rows, 128), the f32 products g * w
    scatter-added at every corner the forward read."""
    levels = g.shape[1] // 2
    g3 = g.T.reshape(levels, 2, -1)
    idx_l, vals_l = [], []
    for lv in range(levels):
        idx, w = xbar_corners(positions, config, lv, n_corners, seed)
        idx_l.append(idx.reshape(-1))
        vals_l.append((g3[lv][:, :, None] * w[None]).reshape(2, -1))
    return scatter_planes(levels, rows, idx_l, vals_l, g)


def hash_xbar_bwd(g: torch.Tensor, positions: torch.Tensor,
                  config: HashGridConfig, rows: int, n_corners: int = 0,
                  seed: int = 0) -> torch.Tensor:
    """Table gradient of the crossbar encode (#11): g (N, L*2) sample-major
    cotangent -> (L, 2, rows, 128). The corners are recomputed from the
    positions and, when stochastic, from the same ``seed``.

    CUDA tensors launch the hand-written kernel; CPU tensors take
    ``hash_xbar_bwd_plain``."""
    _check_corners(n_corners)
    seed = int(seed) & M32
    if g.device.type == 'cpu':
        return hash_xbar_bwd_plain(g, positions, config, rows, n_corners,
                                   seed)
    dtab, _ = _launch_bwd('hash_xbar_bwd', g, positions, None, config, rows,
                          n_corners, seed, True, False)
    hash_xbar_bwd.launches += 1
    return dtab


hash_xbar_bwd.launches = 0


# ---------------------------------------------------------------------------
# #12 position gradient
# ---------------------------------------------------------------------------

def _dpos_levels(table: torch.Tensor, positions: torch.Tensor,
                 g: torch.Tensor, config: HashGridConfig, n_corners: int,
                 seed: int):
    """Each level's position-gradient sum (N, 3), in level order: over the
    corners in order, ((g . v_c) * dfactor_d) * (prod_{e != d} factor_e) *
    (res - 1), the kernels' order of operations."""
    flat = bf16_planes(table)
    res_m1 = level_layout(config)[0]
    for lv in range(table.shape[0]):
        verts, f, df = corner_factors(positions, int(res_m1[lv]) + 1, lv,
                                      n_corners, seed)
        vals = flat[lv][:, _flat_index(verts, config, lv)]      # (2, N, C)
        gp = g[:, 2 * lv, None] * vals[0] + g[:, 2 * lv + 1, None] * vals[1]
        other = torch.stack([f[..., 1] * f[..., 2], f[..., 0] * f[..., 2],
                             f[..., 0] * f[..., 1]], -1)
        terms = ((gp[..., None] * df) * other) * res_m1[lv]    # (N, C, 3)
        acc = torch.zeros_like(positions)
        for c in range(terms.shape[1]):
            acc = acc + terms[:, c]
        yield acc


def hash_xbar_bwd_pos_plain(table: torch.Tensor, positions: torch.Tensor,
                            g: torch.Tensor, config: HashGridConfig,
                            n_corners: int = 0, seed: int = 0
                            ) -> torch.Tensor:
    """Plain position gradient: g (N, L*2) -> dpos (N, 3), d/d(unit
    position) of the bf16 trilinear encode (the oracle ``_dpos_jnp`` :642
    for exact corners): the levels' sums (``_dpos_levels``) added in
    order."""
    dpos = torch.zeros_like(positions)
    for acc in _dpos_levels(table, positions, g, config, n_corners, seed):
        dpos = dpos + acc
    return dpos


def hash_xbar_bwd_pos(table: torch.Tensor, positions: torch.Tensor,
                      g: torch.Tensor, config: HashGridConfig,
                      n_corners: int = 0, seed: int = 0) -> torch.Tensor:
    """Position gradient of the crossbar encode (#12): g (N, L*2) -> (N, 3),
    exact (``n_corners`` 0) or straight-through on the stochastic corners
    drawn from ``seed``.

    CUDA tensors launch the hand-written kernel; CPU tensors take
    ``hash_xbar_bwd_pos_plain``."""
    _check_corners(n_corners)
    seed = int(seed) & M32
    if positions.device.type == 'cpu':
        return hash_xbar_bwd_pos_plain(table, positions, g, config, n_corners,
                                       seed)
    _, dpos = _launch_bwd('hash_xbar_bwd_pos', g, positions, table, config,
                          table.shape[2], n_corners, seed, False, True)
    hash_xbar_bwd_pos.launches += 1
    return dpos


hash_xbar_bwd_pos.launches = 0


# ---------------------------------------------------------------------------
# #11 and #12 from one pass; the backward's launch plan
# ---------------------------------------------------------------------------

# Threads of a level-resident block (kResThreads in csrc/hash_xbar.cu).
RESIDENT_THREADS = 1024


class XbarBwdPlan(NamedTuple):
    """How the backward runs: ``path`` 'resident' or 'gather', the sample
    ``tiles`` of the resident grid (0 on the gather path), the largest
    level's ``level_rows`` and the dynamic ``smem_bytes`` a resident block
    asks for."""
    path: str
    tiles: int
    level_rows: int
    smem_bytes: int


def xbar_bwd_plan(config: HashGridConfig, n: int, tab: bool = True,
                  pos: bool = True, sms: int = 132,
                  smem_per_block: int = 232_448) -> XbarBwdPlan:
    """The backward's launch plan, from the shapes and the card's limits
    (by default an H100's: 132 SMs, 232,448 bytes of shared memory a block
    may opt in to): the resident path when the largest level's staged
    gradient (8 bytes per entry, ``tab``) and bf16x2 table (4 bytes,
    ``pos``) fit one block's shared memory, with about one block per SM
    (``sms // levels`` tiles, no more than blocks of RESIDENT_THREADS
    samples); else the gather path. Corner counts do not enter: every mode
    stages the same level."""
    level_rows = level_layout(config)[3]
    smem = level_rows * LANES * ((8 if tab else 0) + (4 if pos else 0))
    if smem > smem_per_block:
        return XbarBwdPlan('gather', 0, level_rows, 0)
    tiles = max(1, min(sms // config.num_levels, -(-n // RESIDENT_THREADS)))
    return XbarBwdPlan('resident', tiles, level_rows, smem)


def _launch_bwd(name: str, g: torch.Tensor, positions: torch.Tensor,
                table, config: HashGridConfig, rows: int, n_corners: int,
                seed: int, want_tab: bool, want_pos: bool, lib=None):
    """Check, allocate and launch ``nerficg_hash_xbar_bwd_fused`` (of
    ``lib``, by default the port's library) for the table gradient
    (``want_tab``), the position gradient (``want_pos``, from ``table``) or
    both; (dtab or None, dpos or None)."""
    tensors = (g, positions) + ((table,) if want_pos else ())
    _kernels.require_cuda(name, *tensors, dtypes=(torch.float32,) * len(
        tensors))
    levels = config.num_levels
    if want_pos and (table.dim() != 4 or table.shape[0] != levels
                     or table.shape[1] != 2 or table.shape[3] != LANES):
        raise KernelError(f'{name}: table must be ({levels}, 2, R, 128), got '
                          f'{tuple(table.shape)}')
    _check_table(name, rows, levels, tuple(positions.shape), config)
    n = positions.shape[0]
    if g.shape != (n, levels * 2):
        raise KernelError(f'{name}: g must be ({n}, {levels * 2}), got '
                          f'{tuple(g.shape)}')
    plan = xbar_bwd_plan(config, n, want_tab, want_pos,
                         *_card_limits(g.get_device()))
    dtab = dpos = scratch = None
    if want_tab:
        dtab = g.new_empty((levels, 2, rows, LANES))
    if want_pos:
        dpos = g.new_empty((n, 3))
        if plan.tiles:
            scratch = g.new_empty((levels, n, 3))
    res_m1, lrows, dense = _layout_tensors(config, g.device)
    lib = lib or _kernels.load_library()
    code = lib.nerficg_hash_xbar_bwd_fused(
        g.data_ptr(), positions.data_ptr(), _kernels.ptr(table),
        res_m1.data_ptr(), lrows.data_ptr(), dense.data_ptr(),
        _kernels.ptr(dtab), _kernels.ptr(dpos), _kernels.ptr(scratch), levels,
        n, rows, plan.level_rows, plan.tiles, n_corners, seed,
        _kernels.stream_of(g))
    _kernels.check(code, name)
    return dtab, dpos


def hash_xbar_bwd_fused_plain(table: torch.Tensor, positions: torch.Tensor,
                              g: torch.Tensor, config: HashGridConfig,
                              n_corners: int = 0, seed: int = 0):
    """Plain table and position gradients of one backward:
    (``hash_xbar_bwd_plain``, ``hash_xbar_bwd_pos_plain``)."""
    return (hash_xbar_bwd_plain(g, positions, config, table.shape[2],
                                n_corners, seed),
            hash_xbar_bwd_pos_plain(table, positions, g, config, n_corners,
                                    seed))


def hash_xbar_bwd_fused(table: torch.Tensor, positions: torch.Tensor,
                        g: torch.Tensor, config: HashGridConfig,
                        n_corners: int = 0, seed: int = 0):
    """Both gradients of the crossbar encode from one call (#11 and #12):
    g (N, L*2) -> (dtab (L, 2, R, 128), dpos (N, 3)), each as
    ``hash_xbar_bwd`` and ``hash_xbar_bwd_pos`` give it: one pass of the
    level-resident kernel over the corners, then its level sum.

    CUDA tensors launch the hand-written kernel; CPU tensors take
    ``hash_xbar_bwd_fused_plain``."""
    _check_corners(n_corners)
    seed = int(seed) & M32
    if positions.device.type == 'cpu':
        return hash_xbar_bwd_fused_plain(table, positions, g, config,
                                         n_corners, seed)
    out = _launch_bwd('hash_xbar_bwd_fused', g, positions, table, config,
                      table.shape[2], n_corners, seed, True, True)
    hash_xbar_bwd_fused.launches += 1
    return out


hash_xbar_bwd_fused.launches = 0


# ---------------------------------------------------------------------------
# differentiable entry points
# ---------------------------------------------------------------------------

class _HashEncodeXbar(torch.autograd.Function):
    """Crossbar encode; backward is #11 on the same corners for the table
    and, with ``pos_grad``, #12 for the positions, each computed only when
    its input needs a gradient, both from one call when both do."""

    @staticmethod
    def forward(ctx, table, positions, config, n_corners, seed, pos_grad):
        pos = positions.detach().contiguous()
        ctx.save_for_backward(table if pos_grad else None, pos)
        ctx.config, ctx.rows = config, table.shape[2]
        ctx.n_corners, ctx.seed, ctx.pos_grad = n_corners, seed, pos_grad
        return hash_xbar_fwd(table, pos, config, n_corners, seed)

    @staticmethod
    def backward(ctx, g):
        table, pos = ctx.saved_tensors
        g = g.contiguous()
        want_tab = ctx.needs_input_grad[0]
        want_pos = ctx.pos_grad and ctx.needs_input_grad[1]
        dtab = dpos = None
        if want_tab and want_pos:
            dtab, dpos = hash_xbar_bwd_fused(table.detach(), pos, g,
                                             ctx.config, ctx.n_corners,
                                             ctx.seed)
        elif want_tab:
            dtab = hash_xbar_bwd(g, pos, ctx.config, ctx.rows, ctx.n_corners,
                                 ctx.seed)
        elif want_pos:
            dpos = hash_xbar_bwd_pos(table.detach(), pos, g, ctx.config,
                                     ctx.n_corners, ctx.seed)
        return dtab, dpos, None, None, None, None


def hash_encode_xbar(table: torch.Tensor, positions: torch.Tensor,
                     config: HashGridConfig) -> torch.Tensor:
    """Exact 8-corner crossbar encode of positions in [0, 1)
    (nerficg_tpu/ops/hash_xbar.py:744): (N, L*2), differentiable in
    ``table``."""
    return _HashEncodeXbar.apply(table, positions, config, 0, 0, False)


def hash_encode_xbar_stochastic(table: torch.Tensor, positions: torch.Tensor,
                                seed: int, config: HashGridConfig,
                                n_corners: int = 2) -> torch.Tensor:
    """Crossbar encode with ``n_corners`` in {1, 2, 4} stochastic corners
    drawn from the uint32 ``seed`` (nerficg_tpu/ops/hash_xbar.py:774), the
    training path; its table gradient lands on the drawn corners."""
    if n_corners not in (1, 2, 4):
        raise ValueError(f'n_corners must be 1, 2 or 4, got {n_corners}')
    return _HashEncodeXbar.apply(table, positions, config, n_corners,
                                 int(seed) & M32, False)


def hash_encode_xbar_posgrad(table: torch.Tensor, positions: torch.Tensor,
                             config: HashGridConfig) -> torch.Tensor:
    """Exact 8-corner crossbar encode differentiable in ``table`` and in
    ``positions`` (nerficg_tpu/ops/hash_xbar.py:812)."""
    return _HashEncodeXbar.apply(table, positions, config, 0, 0, True)


def hash_encode_xbar_stochastic_posgrad(table: torch.Tensor,
                                        positions: torch.Tensor, seed: int,
                                        config: HashGridConfig,
                                        n_corners: int = 2) -> torch.Tensor:
    """Stochastic crossbar encode with the straight-through position
    gradient: exact in the interpolated dims of each drawn corner, zero in
    the Bernoulli-sampled dims (nerficg_tpu/ops/hash_xbar.py:842; the JAX
    package draws stochastic corners only on the TPU and returns the exact
    encode and gradient elsewhere)."""
    if n_corners not in (1, 2, 4):
        raise ValueError(f'n_corners must be 1, 2 or 4, got {n_corners}')
    return _HashEncodeXbar.apply(table, positions, config, n_corners,
                                 int(seed) & M32, True)
