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
    index and weight;
  * ``hash_xbar_bwd``: the table gradient of either (#11 ``_bwd_kernel``
    :394), recomputing the corners from the same counter hash, so the
    gradient lands on the corners the forward read;
  * ``hash_xbar_bwd_pos``: the position gradient d(encode)/d(unit position)
    (#12 ``_bwd_pos_kernel`` :537), exact, or straight-through on the same
    stochastic corners (interpolated dims only).
``hash_encode_xbar`` and ``hash_encode_xbar_stochastic`` are the
differentiable entry points with gradients to the table only;
``hash_encode_xbar_posgrad`` and ``hash_encode_xbar_stochastic_posgrad``
(:812, :842) also return the position gradient, for deformation fields
(D-NeRF).
"""

from __future__ import annotations

import functools

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
           'hash_xbar_bwd_pos_plain', 'xbar_corners']

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


def hash_xbar_fwd(table: torch.Tensor, positions: torch.Tensor,
                  config: HashGridConfig, n_corners: int = 0,
                  seed: int = 0, save: bool = False):
    """Crossbar encode, exact (``n_corners`` 0) or with 1, 2 or 4
    stochastic corners drawn from the uint32 ``seed`` (#10): (N, L*2), and
    with ``save`` the corner streams of ``hash_xbar_fwd_plain``.

    CUDA tensors launch the hand-written kernel; CPU tensors take
    ``hash_xbar_fwd_plain``."""
    _check_corners(n_corners)
    seed = int(seed) & M32
    if positions.device.type == 'cpu':
        return hash_xbar_fwd_plain(table, positions, config, n_corners, seed,
                                   save)
    name = 'hash_xbar_fwd'
    _kernels.require_cuda(name, table, positions,
                          dtypes=(torch.float32, torch.float32))
    levels, feats, rows, lanes = table.shape
    if feats != 2 or lanes != LANES:
        raise KernelError(f'{name}: table must be (L, 2, R, 128), got '
                          f'{tuple(table.shape)}')
    _check_table(name, rows, levels, tuple(positions.shape), config)
    n = positions.shape[0]
    res_m1, lrows, dense = _layout_tensors(config, positions.device)
    device = positions.device
    out = torch.empty((n, levels * 2), dtype=torch.float32, device=device)
    idx = w = None
    if save:
        corners = n_corners or 8
        idx = torch.empty((levels, corners, n), dtype=torch.int32,
                          device=device)
        w = torch.empty((levels, corners, n), dtype=torch.float32,
                        device=device)
    code = _kernels.load_library().nerficg_hash_xbar_fwd(
        table.data_ptr(), positions.data_ptr(), res_m1.data_ptr(),
        lrows.data_ptr(), dense.data_ptr(), out.data_ptr(), _kernels.ptr(idx),
        _kernels.ptr(w), levels, n, rows, n_corners, seed,
        _kernels.stream_of(positions))
    _kernels.check(code, name)
    hash_xbar_fwd.launches += 1
    return (out, idx, w) if save else out


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
    name = 'hash_xbar_bwd'
    _kernels.require_cuda(name, g, positions,
                          dtypes=(torch.float32, torch.float32))
    levels = config.num_levels
    _check_table(name, rows, levels, tuple(positions.shape), config)
    n = positions.shape[0]
    if g.shape != (n, levels * 2):
        raise KernelError(f'{name}: g must be ({n}, {levels * 2}), got '
                          f'{tuple(g.shape)}')
    res_m1, lrows, dense = _layout_tensors(config, g.device)
    dtab = torch.empty((levels, 2, rows, LANES), dtype=torch.float32,
                       device=g.device)
    code = _kernels.load_library().nerficg_hash_xbar_bwd(
        g.data_ptr(), positions.data_ptr(), res_m1.data_ptr(),
        lrows.data_ptr(), dense.data_ptr(), dtab.data_ptr(), levels, n, rows,
        n_corners, seed, _kernels.stream_of(g))
    _kernels.check(code, name)
    hash_xbar_bwd.launches += 1
    return dtab


hash_xbar_bwd.launches = 0


# ---------------------------------------------------------------------------
# #12 position gradient
# ---------------------------------------------------------------------------

def hash_xbar_bwd_pos_plain(table: torch.Tensor, positions: torch.Tensor,
                            g: torch.Tensor, config: HashGridConfig,
                            n_corners: int = 0, seed: int = 0
                            ) -> torch.Tensor:
    """Plain position gradient: g (N, L*2) -> dpos (N, 3), d/d(unit
    position) of the bf16 trilinear encode (the oracle ``_dpos_jnp`` :642
    for exact corners). Per level, over the corners in order,
    ((g . v_c) * dfactor_d) * (prod_{e != d} factor_e) * (res - 1), the
    kernel's order of operations; the levels' sums added in order."""
    flat = bf16_planes(table)
    res_m1 = level_layout(config)[0]
    dpos = torch.zeros_like(positions)
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
    name = 'hash_xbar_bwd_pos'
    _kernels.require_cuda(name, table, positions, g,
                          dtypes=(torch.float32,) * 3)
    levels, feats, rows, lanes = table.shape
    if feats != 2 or lanes != LANES:
        raise KernelError(f'{name}: table must be (L, 2, R, 128), got '
                          f'{tuple(table.shape)}')
    _check_table(name, rows, levels, tuple(positions.shape), config)
    n = positions.shape[0]
    if g.shape != (n, levels * 2):
        raise KernelError(f'{name}: g must be ({n}, {levels * 2}), got '
                          f'{tuple(g.shape)}')
    res_m1, lrows, dense = _layout_tensors(config, g.device)
    dpos = torch.empty((n, 3), dtype=torch.float32, device=g.device)
    code = _kernels.load_library().nerficg_hash_xbar_bwd_pos(
        table.data_ptr(), positions.data_ptr(), g.data_ptr(),
        res_m1.data_ptr(), lrows.data_ptr(), dense.data_ptr(),
        dpos.data_ptr(), levels, n, rows, n_corners, seed,
        _kernels.stream_of(g))
    _kernels.check(code, name)
    hash_xbar_bwd_pos.launches += 1
    return dpos


hash_xbar_bwd_pos.launches = 0


# ---------------------------------------------------------------------------
# differentiable entry points
# ---------------------------------------------------------------------------

class _HashEncodeXbar(torch.autograd.Function):
    """Crossbar encode; backward is #11 on the same corners for the table
    and, with ``pos_grad``, #12 for the positions, each launched only when
    its input needs a gradient."""

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
        dtab = dpos = None
        if ctx.needs_input_grad[0]:
            dtab = hash_xbar_bwd(g, pos, ctx.config, ctx.rows, ctx.n_corners,
                                 ctx.seed)
        if ctx.pos_grad and ctx.needs_input_grad[1]:
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
