"""Two-level rank-compacted block bitfield and its occupancy probe: a port
of nerficg_tpu/ops/xbar_gather.py (:204-328).

The skip grid is split into 8^3-cell blocks; only occupied blocks keep their
16 fine words, packed in block-rank order. One (rows, 128) int32 table holds
[coarse | rank | compact]:

  coarse : 1 bit per block
  rank   : per coarse word, the number of occupied blocks in the words before
  compact: cap_blocks * 16 words of fine bits, rank-ordered

A block whose rank overflows ``cap_blocks`` probes as occupied (the skip
grid only has to be conservative).

``block_probe_cells`` is the kernel wrapper: for CUDA tensors it launches
``nerficg_torch/csrc/block_probe.cu``, which replaces the TPU crossbar gather
``_gather_kernel`` (nerficg_tpu/ops/xbar_gather.py:36) at its three calls in
the JAX probe; for CPU tensors it runs ``block_probe_cells_plain``.

``xbar_permute`` (:111) is the row permutation ``mat[idx]`` of a matrix of
32-bit words, bit-exact; on CUDA tensors it launches the kernel of the same
file that replaces ``_permute_kernel`` (:88). Nothing in the JAX methods
calls it: it is part of the op API.
"""

from __future__ import annotations

import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import _kernels

__all__ = ['build_block_bitfield', 'block_probe_cells',
           'block_probe_cells_plain', 'block_table_rows', 'xbar_permute',
           'xbar_permute_plain']

_LANES = 128
_BLOCK = 8                      # cells per block side (512 bits = 16 words)
_BLOCK_WORDS = _BLOCK ** 3 // 32
_M32 = 0xFFFFFFFF


def block_table_rows(resolution: int, cap_blocks: int,
                     num_grids: int = 1) -> tuple:
    """(coarse_rows, rank_rows, compact_rows) of the packed layout."""
    b = resolution // _BLOCK
    nb = num_grids * b ** 3
    nw = -(-nb // 32)
    cr = -(-nw // _LANES)
    return cr, cr, cap_blocks * _BLOCK_WORDS // _LANES


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """SWAR popcount of 32-bit values held in int64 (torch has no popcount)."""
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & _M32) >> 24


def _as_int32(words: torch.Tensor) -> torch.Tensor:
    """uint32 values held in int64 -> int32 with the same bits."""
    return torch.where(words >= 1 << 31, words - (1 << 32), words).to(
        torch.int32)


def build_block_bitfield(flags: torch.Tensor, resolution: int,
                         cap_blocks: int, num_grids: int = 1) -> torch.Tensor:
    """(num_grids * res^3,) bool flags -> packed (rows, 128) int32 table.
    ``cap_blocks`` must be a multiple of 8."""
    if resolution % _BLOCK or cap_blocks % (_LANES // _BLOCK_WORDS):
        raise ValueError('resolution and cap_blocks must be multiples of 8')
    b = resolution // _BLOCK
    nb = num_grids * b ** 3
    f = flags.reshape(num_grids, b, _BLOCK, b, _BLOCK, b, _BLOCK)
    f = f.permute(0, 1, 3, 5, 2, 4, 6).reshape(nb, _BLOCK ** 3).long()
    block_occ = f.amax(1) > 0                                  # (nb,)
    weights = torch.ones(32, dtype=torch.int64, device=f.device) << \
        torch.arange(32, device=f.device)
    words = (f.reshape(nb, _BLOCK_WORDS, 32) * weights).sum(-1)  # (nb, 16)

    nw = -(-nb // 32)
    occ_pad = torch.nn.functional.pad(block_occ.long(), (0, nw * 32 - nb))
    coarse_words = (occ_pad.reshape(nw, 32) * weights).sum(-1)  # (nw,)
    popc = _popcount32(coarse_words)
    rank_words = torch.cumsum(popc, 0) - popc                  # exclusive

    # Rank-ordered compaction; overflow blocks land on the dropped tail row.
    block_rank = torch.cumsum(block_occ.long(), 0) - 1
    dest = torch.where(block_occ & (block_rank < cap_blocks), block_rank,
                       cap_blocks)
    compact = torch.zeros((cap_blocks + 1, _BLOCK_WORDS), dtype=torch.int64,
                          device=f.device)
    compact[dest] = words
    compact = compact[:cap_blocks]

    cr, rr, fr = block_table_rows(resolution, cap_blocks, num_grids)

    def to_rows(x, rows):
        x = x.reshape(-1)
        x = torch.nn.functional.pad(x, (0, rows * _LANES - x.shape[0]))
        return x.reshape(rows, _LANES)

    return torch.cat([to_rows(_as_int32(coarse_words), cr),
                      to_rows(rank_words.to(torch.int32), rr),
                      to_rows(_as_int32(compact), fr)], 0)


def block_probe_cells_plain(table: torch.Tensor, cx: torch.Tensor,
                            cy: torch.Tensor, cz: torch.Tensor, grid_index,
                            resolution: int, cap_blocks: int,
                            num_grids: int = 1) -> torch.Tensor:
    """Plain-PyTorch probe, the JAX ``block_probe_cells`` with its gathers
    as indexing (nerficg_tpu/ops/xbar_gather.py:293-328)."""
    cr, rr, _ = block_table_rows(resolution, cap_blocks, num_grids)
    words = table.reshape(-1).long()
    coarse = words[:cr * _LANES] & _M32
    rank = words[cr * _LANES:(cr + rr) * _LANES]
    compact = words[(cr + rr) * _LANES:] & _M32
    cx, cy, cz = cx.long(), cy.long(), cz.long()
    if isinstance(grid_index, torch.Tensor):
        grid_index = grid_index.long()
    b = resolution // _BLOCK
    blk = grid_index * (b ** 3) + ((cx >> 3) * b + (cy >> 3)) * b + (cz >> 3)
    w = blk >> 5
    bit = blk & 31
    cw = coarse[w]
    occ_blk = ((cw >> bit) & 1) == 1
    below = (torch.ones_like(bit) << bit) - 1
    rank_blk = rank[w] + _popcount32(cw & below)
    overflow = rank_blk >= cap_blocks
    within = ((cx & 7) * _BLOCK + (cy & 7)) * _BLOCK + (cz & 7)
    safe = torch.clamp(rank_blk, max=cap_blocks - 1) * _BLOCK_WORDS + \
        (within >> 5)
    fine = ((compact[safe] >> (within & 31)) & 1) == 1
    return occ_blk & (fine | overflow)


def block_probe_cells(table: torch.Tensor, cx: torch.Tensor,
                      cy: torch.Tensor, cz: torch.Tensor, grid_index,
                      resolution: int, cap_blocks: int,
                      num_grids: int = 1) -> torch.Tensor:
    """Occupancy (bool, shape of ``cx``) of integer cell coords already
    clipped to [0, res). ``grid_index``: per-probe grid/cascade (int32
    tensor of ``cx``'s shape) or the int 0.

    CUDA tensors launch the hand-written kernel; CPU tensors take
    ``block_probe_cells_plain``."""
    if cx.device.type == 'cpu':
        return block_probe_cells_plain(table, cx, cy, cz, grid_index,
                                       resolution, cap_blocks, num_grids)
    name = 'block_probe'
    shape = cx.shape
    cx, cy, cz = (t.reshape(-1) for t in (cx, cy, cz))
    if isinstance(grid_index, torch.Tensor):
        grid_index = grid_index.reshape(-1)
        _kernels.require_cuda(name, table, cx, cy, cz, grid_index,
                              dtypes=(torch.int32,) * 5)
        if grid_index.shape != cx.shape:
            raise KernelError(f'{name}: grid_index must match the coords')
    elif grid_index == 0:
        _kernels.require_cuda(name, table, cx, cy, cz,
                              dtypes=(torch.int32,) * 4)
        grid_index = None
    else:
        raise KernelError(f'{name}: grid_index must be a tensor or 0')
    if cy.shape != cx.shape or cz.shape != cx.shape:
        raise KernelError(f'{name}: coordinate planes differ in shape')
    cr, rr, fr = block_table_rows(resolution, cap_blocks, num_grids)
    if table.shape != (cr + rr + fr, _LANES):
        raise KernelError(f'{name}: table must be ({cr + rr + fr}, 128), got '
                          f'{tuple(table.shape)}')
    n = cx.shape[0]
    out = torch.empty(n, dtype=torch.uint8, device=cx.device)
    code = _kernels.load_library().nerficg_block_probe(
        table.data_ptr(), cx.data_ptr(), cy.data_ptr(), cz.data_ptr(),
        _kernels.ptr(grid_index), out.data_ptr(), n, resolution, cap_blocks,
        cr, rr, _kernels.stream_of(cx))
    _kernels.check(code, name)
    block_probe_cells.launches += 1
    return out.view(torch.bool).reshape(shape)


block_probe_cells.launches = 0


def xbar_permute_plain(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``mat[idx]``: rows of an (N, C) matrix picked by idx (M,)."""
    return mat[idx.long()]


def xbar_permute(mat: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Row permutation or gather ``mat[idx]`` of an (N, C) matrix of any
    32-bit dtype by int32 indices (M,) in [0, N) -> (M, C), the bits moved
    exactly (nerficg_tpu/ops/xbar_gather.py:111, #5).

    CUDA tensors launch the hand-written kernel; CPU tensors take
    ``xbar_permute_plain``."""
    if mat.device.type == 'cpu':
        return xbar_permute_plain(mat, idx)
    name = 'xbar_permute'
    if mat.ndim != 2 or idx.ndim != 1 or mat.element_size() != 4:
        raise KernelError(f'{name}: mat must be (N, C) of a 32-bit dtype and '
                          f'idx (M,), got {tuple(mat.shape)} {mat.dtype} and '
                          f'{tuple(idx.shape)}')
    _kernels.require_cuda(name, mat, idx, dtypes=(mat.dtype, torch.int32))
    out = torch.empty((idx.shape[0], mat.shape[1]), dtype=mat.dtype,
                      device=mat.device)
    code = _kernels.load_library().nerficg_xbar_permute(
        mat.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
        mat.shape[1], _kernels.stream_of(mat))
    _kernels.check(code, name)
    xbar_permute.launches += 1
    return out


xbar_permute.launches = 0
