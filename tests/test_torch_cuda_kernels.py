"""The port's CUDA kernels against their plain PyTorch versions, on a
card. Marked ``cuda``: without a card every test here skips. On a machine
with one: ``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``
(chip_smoke.py runs the same comparisons at the serving path's shapes)."""

import numpy as np
import pytest
import torch

from nerficg_torch.ops import (hash_cell, hash_mxu, hash_window, hash_xbar,
                               xbar_gather)
from nerficg_torch.ops.hashgrid import HashGridConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


CFG = HashGridConfig(num_levels=16, features_per_level=2, log2_table_size=14,
                     base_resolution=16, target_resolution=2048,
                     anchor_stride=8)


def _encode_inputs(cuda, seed=0):
    """Library-width table and 16,384 morton-sorted samples with windows."""
    rng = np.random.default_rng(seed)
    table = torch.tensor(rng.uniform(-1, 1, (16, 2, 128, 128)),
                         dtype=torch.float32, device=cuda)
    pos = torch.tensor(rng.uniform(0, 1, (16384, 3)), dtype=torch.float32,
                       device=cuda)
    pos = pos[torch.sort(hash_window.morton_sort_keys(pos)).indices]
    pos = pos.contiguous()
    lo, win = hash_window.window_bases(pos, CFG)
    g = torch.tensor(rng.normal(size=(32, 16384)), dtype=torch.float32,
                     device=cuda)
    return table, pos, lo, win, g


def _close_to_scatter(got, want):
    """rtol 1e-4, atol 1e-5 * max|want|: atomic adds in another order."""
    torch.testing.assert_close(got, want, rtol=1e-4,
                               atol=1e-5 * float(want.abs().max()))


def test_hash_window_fwd(cuda):
    """atol 1e-5: f32 FMA contraction and sum order in the kernel."""
    table, pos, lo, win, _ = _encode_inputs(cuda)
    cfg = CFG
    got = hash_window.hash_window_fwd(table, pos, lo, win, cfg)
    want = hash_window.hash_window_fwd_plain(table, pos, lo, win, cfg)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize('grids', [1, 2])
def test_block_probe(cuda, grids):
    rng = np.random.default_rng(1)
    res, cap = 64, 256
    flags = torch.tensor(rng.uniform(size=grids * res ** 3) < 0.01,
                         device=cuda)
    table = xbar_gather.build_block_bitfield(flags, res, cap, grids)
    c = [torch.tensor(rng.integers(0, res, 50000), dtype=torch.int32,
                      device=cuda) for _ in range(3)]
    g = torch.tensor(rng.integers(0, grids, 50000), dtype=torch.int32,
                     device=cuda) if grids > 1 else 0
    args = (table, *c, g, res, cap, grids)
    assert torch.equal(xbar_gather.block_probe_cells(*args),
                       xbar_gather.block_probe_cells_plain(*args))


def test_seg_gather_and_scatter_add(cuda):
    """Gather exact; scatter rtol 1e-5 / atol 1e-6 (atomic order)."""
    rng = np.random.default_rng(2)
    idx = torch.tensor(np.sort(rng.integers(0, 1537, (1, 24576))),
                       dtype=torch.int32, device=cuda)
    table = torch.tensor(rng.normal(size=(1, 1, 13, 128)),
                         dtype=torch.float32, device=cuda)
    assert torch.equal(hash_mxu.seg_gather(idx, table),
                       hash_mxu.seg_gather_plain(idx, table))
    g = torch.tensor(rng.uniform(size=(1, 5, 24576)), dtype=torch.float32,
                     device=cuda)
    torch.testing.assert_close(hash_mxu.seg_scatter_add(idx, g, 13),
                               hash_mxu.seg_scatter_add_plain(idx, g, 13),
                               rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize('n_corners', [1, 2, 4])
def test_hash_window_fwd_stoch(cuda, n_corners):
    """Corners and weights exact (same counter words, _rn arithmetic);
    features atol 1e-5."""
    table, pos, lo, win, _ = _encode_inputs(cuda, seed=3)
    args = (table, pos, lo, win, CFG, n_corners, 0xDEADBEEF)
    out, idx, w = hash_window.hash_window_fwd_stoch(*args, save=True)
    out_p, idx_p, w_p = hash_window.hash_window_fwd_stoch_plain(*args,
                                                                save=True)
    assert torch.equal(idx, idx_p)
    assert torch.equal(w, w_p)
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-5)
    alone, none_idx, none_w = hash_window.hash_window_fwd_stoch(*args)
    assert none_idx is None and none_w is None
    assert torch.equal(alone, out)


def test_hash_window_bwd(cuda):
    table, pos, lo, win, g = _encode_inputs(cuda, seed=4)
    _close_to_scatter(
        hash_window.hash_window_bwd(g, pos, lo, win, CFG, 128),
        hash_window.hash_window_bwd_plain(g, pos, lo, win, CFG, 128))


def test_hash_window_bwd_cached(cuda):
    table, pos, lo, win, g = _encode_inputs(cuda, seed=5)
    _, idx, w = hash_window.hash_window_fwd_stoch(table, pos, lo, win, CFG,
                                                  4, 7, save=True)
    _close_to_scatter(hash_window.hash_window_bwd_cached(g, idx, w, 128),
                      hash_window.hash_window_bwd_cached_plain(g, idx, w,
                                                               128))


# The cell encode at the reference's 2^19 entries (configs/ingp_parity.yaml)
# and the crossbar at the library's 2^14.
CELL_CFG = HashGridConfig(num_levels=16, features_per_level=2,
                          log2_table_size=19, base_resolution=16,
                          target_resolution=2048, anchor_stride=8)


def _cell_inputs(cuda, seed=0):
    """(16, 2, 4096, 128) table and 16,384 morton-sorted samples."""
    rng = np.random.default_rng(seed)
    table = torch.tensor(rng.uniform(-1, 1, (16, 2, 4096, 128)),
                         dtype=torch.float32, device=cuda)
    pos = torch.tensor(rng.uniform(0.1, 0.9, (16384, 3)),
                       dtype=torch.float32, device=cuda)
    pos = pos[torch.sort(hash_window.morton_sort_keys(pos)).indices]
    pos = pos.contiguous()
    lo, win = hash_cell.cell_window_bases(pos, CELL_CFG)
    g = torch.tensor(rng.normal(size=(32, 16384)), dtype=torch.float32,
                     device=cuda)
    return table, pos, lo, win, g


def test_hash_cell_fwd(cuda):
    """atol 1e-5: f32 FMA contraction of the weighted sum."""
    table, pos, lo, win, _ = _cell_inputs(cuda)
    torch.testing.assert_close(
        hash_cell.hash_cell_fwd(table, pos, lo, win, CELL_CFG),
        hash_cell.hash_cell_fwd_plain(table, pos, lo, win, CELL_CFG),
        rtol=0, atol=1e-5)


def test_hash_cell_bwd(cuda):
    _, pos, lo, win, g = _cell_inputs(cuda, seed=1)
    _close_to_scatter(
        hash_cell.hash_cell_bwd(g, pos, lo, win, CELL_CFG, 4096),
        hash_cell.hash_cell_bwd_plain(g, pos, lo, win, CELL_CFG, 4096))


def _xbar_inputs(cuda, seed=0):
    rng = np.random.default_rng(seed)
    table = torch.tensor(rng.uniform(-1, 1, (16, 2, 128, 128)),
                         dtype=torch.float32, device=cuda)
    pos = torch.tensor(rng.uniform(0, 1 - 1e-6, (16384, 3)),
                       dtype=torch.float32, device=cuda)
    g = torch.tensor(rng.normal(size=(16384, 32)), dtype=torch.float32,
                     device=cuda)
    return table, pos, g


@pytest.mark.parametrize('n_corners', [0, 1, 2, 4])
def test_hash_xbar_fwd(cuda, n_corners):
    """Corner indices and weights exact (same counter words, _rn
    arithmetic); features atol 1e-5."""
    table, pos, _ = _xbar_inputs(cuda, seed=2)
    args = (table, pos, CFG, n_corners, 0xDEADBEEF)
    out, idx, w = hash_xbar.hash_xbar_fwd(*args, save=True)
    out_p, idx_p, w_p = hash_xbar.hash_xbar_fwd_plain(*args, save=True)
    assert torch.equal(idx, idx_p)
    assert torch.equal(w, w_p)
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-5)
    assert torch.equal(hash_xbar.hash_xbar_fwd(*args), out)


@pytest.mark.parametrize('n_corners', [0, 4])
def test_hash_xbar_bwd(cuda, n_corners):
    _, pos, g = _xbar_inputs(cuda, seed=3)
    _close_to_scatter(
        hash_xbar.hash_xbar_bwd(g, pos, CFG, 128, n_corners, 99),
        hash_xbar.hash_xbar_bwd_plain(g, pos, CFG, 128, n_corners, 99))
