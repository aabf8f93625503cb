"""The port's CUDA kernels against their plain PyTorch versions, on a
card. Marked ``cuda``: without a card every test here skips. On a machine
with one: ``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``
(chip_smoke.py runs the same comparisons at the serving path's shapes)."""

import functools
from pathlib import Path

import numpy as np
import pytest
import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import (gs_rasterize, gs_tiles_kernel, hash_cell,
                               hash_mxu, hash_window, hash_xbar, xbar_gather)
from nerficg_torch.ops.hashgrid import HashGridConfig
from nerficg_torch.scripts.kernel_timing import boundary_values

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


def _scatter_ids(cuda, rng, m, rays, sort, out_of_range):
    rows = (rays + 1 + 127) // 128
    ids = rng.integers(0, rays + 1, m)
    if sort:
        ids = np.sort(ids)
    bad = rng.uniform(size=m) < out_of_range
    ids[bad] = rng.choice([-1, -1000, rows * 128, rows * 128 + 7],
                          int(bad.sum()))
    return torch.tensor(ids[None], dtype=torch.int32, device=cuda), rows


def _scatter_close(got, idx, g, rows):
    """Within 1e-5 of the sum of |g| per entry, plus 1e-6 (atomics add in
    another order): rtol 1e-5 / atol 1e-6 where the values share a sign,
    as the compositor's channels do, and scaled to the input where signed
    values (the gather's backward) cancel."""
    want = hash_mxu.seg_scatter_add_plain(idx, g, rows)
    scale = hash_mxu.seg_scatter_add_plain(idx, g.abs(), rows)
    err = (got - want).abs()
    assert bool((err <= 1e-5 * scale + 1e-6).all()), float(err.max())


# (rays, M, path at F = 1 and 5): the serving chunk; a training step's
# call and a short one, under SCATTER_FUSED_MIN_M; 65,536 elements; and
# 262,144 rays' planes, past SCATTER_FUSED_MAX_BYTES.
@pytest.mark.parametrize('feats', [1, 5])
@pytest.mark.parametrize('low', [0.0, -1.0])
@pytest.mark.parametrize('sort, out_of_range', [(True, 0.0), (False, 0.0),
                                                (False, 0.1)])
@pytest.mark.parametrize('rays, m, path', [
    (1536, 24576, 'fused'), (1536, 101, 'atomic'), (512, 8192, 'atomic'),
    (4096, 65536, 'fused'), (262144, 24576, 'atomic')])
def test_seg_scatter_add_paths(cuda, feats, low, sort, out_of_range, rays, m,
                               path):
    """#7 on the path its plan takes for the shape, values in [low, 1),
    against the plain version."""
    rng = np.random.default_rng(3)
    idx, rows = _scatter_ids(cuda, rng, m, rays, sort, out_of_range)
    g = torch.tensor(rng.uniform(low, 1, (1, feats, m)), dtype=torch.float32,
                     device=cuda)
    assert hash_mxu.seg_scatter_plan(feats, m, rows) == path
    _scatter_close(hash_mxu.seg_scatter_add(idx, g, rows), idx, g, rows)


def test_seg_scatter_add_unaligned_rows(cuda):
    """Index and value rows 4 bytes past a 16-byte boundary take the
    fused kernel's scalar loads."""
    rng = np.random.default_rng(5)
    ids = torch.tensor(np.sort(rng.integers(0, 1537, (1, 24577))),
                       dtype=torch.int32, device=cuda)
    idx = ids[:, 1:]
    g = torch.tensor(rng.uniform(0, 1, (5 * 24576 + 1,)), dtype=torch.float32,
                     device=cuda)[1:].reshape(1, 5, 24576)
    assert idx.is_contiguous() and idx.data_ptr() % 16 == 4
    assert g.is_contiguous() and g.data_ptr() % 16 == 4
    assert hash_mxu.seg_scatter_plan(5, 24576, 13) == 'fused'
    _scatter_close(hash_mxu.seg_scatter_add(idx, g, 13), idx, g, 13)


@pytest.mark.parametrize('m, path', [(5000, 'atomic'), (20000, 'fused')])
def test_seg_scatter_add_levels(cuda, m, path):
    """Several levels of one call, each its own cluster (fused) or its
    own planes (atomic), signed values."""
    rng = np.random.default_rng(4)
    idx = torch.tensor(np.sort(rng.integers(-5, 3 * 128 + 5, (3, m))),
                       dtype=torch.int32, device=cuda)
    g = torch.tensor(rng.uniform(-1, 1, (3, 2, m)), dtype=torch.float32,
                     device=cuda)
    assert hash_mxu.seg_scatter_plan(2, m, 3) == path
    _scatter_close(hash_mxu.seg_scatter_add(idx, g, 3), idx, g, 3)


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


def _cached_streams(cuda, n, nc, rows, sort, seed):
    """The stochastic forward's saved (16, nc, n) streams on a (16, 2, rows,
    128) table (rows 128: the library's 2^14, each level in one block's
    shared memory; 512: 2^16, the global path), samples morton-sorted or
    not, nc 8 as two 4-corner streams stacked (the run-time corner count),
    and a cotangent with its last 3000 samples and a random tenth of the
    others zero (padding)."""
    cfg = HashGridConfig(num_levels=16, features_per_level=2,
                         log2_table_size={128: 14, 512: 16}[rows],
                         base_resolution=16, target_resolution=2048,
                         anchor_stride=8)
    rng = np.random.default_rng(seed)
    table = torch.tensor(rng.uniform(-1, 1, (16, 2, rows, 128)),
                         dtype=torch.float32, device=cuda)
    pos = torch.tensor(rng.uniform(0.2, 0.8, (n, 3)), dtype=torch.float32,
                       device=cuda)
    if sort:
        pos = pos[torch.sort(hash_window.morton_sort_keys(pos)).indices]
    pos = pos.contiguous()
    lo, win = hash_window.window_bases(pos, cfg)
    streams = [hash_window.hash_window_fwd_stoch(
        table, pos, lo, win, cfg, min(nc, 4), seed + k, save=True)[1:]
        for k in range(max(nc // 4, 1))]
    idx = torch.cat([i for i, _ in streams], 1).contiguous()
    w = torch.cat([wt for _, wt in streams], 1).contiguous()
    g = rng.normal(size=(32, n)).astype(np.float32)
    g[:, n - 3000:] = 0.0
    g[:, rng.uniform(size=n) < 0.1] = 0.0
    return torch.from_numpy(g).to(cuda), idx, w


@pytest.mark.parametrize('n, nc, rows, sort', [
    *[(n, nc, 128, True) for n in (8192, 65536, 262144) for nc in (1, 2, 4)],
    (65536, 1, 512, True), (65536, 4, 512, True), (65536, 4, 128, False),
    (65536, 4, 512, False), (65536, 8, 128, True), (65536, 8, 512, True)])
def test_hash_window_bwd_cached_paths(cuda, n, nc, rows, sort):
    """#3 on the level-resident path (128 rows) and the global one (512),
    against its plain version: atomics in another order."""
    g, idx, w = _cached_streams(cuda, n, nc, rows, sort, seed=n + nc + rows)
    _close_to_scatter(hash_window.hash_window_bwd_cached(g, idx, w, rows),
                      hash_window.hash_window_bwd_cached_plain(g, idx, w,
                                                               rows))


def _probe_points(cuda, center, half, res, cascades, n=60000, seed=0):
    """World planes on the card as (rays, 8): random points within 1.3 half
    of the center (some outside the box), then one axis set to every
    cascade boundary and cell boundary (of each cascade) +-1 ulp."""
    rng = np.random.default_rng(seed)
    center = np.asarray(center, np.float32)
    edges = [boundary_values(half, cascades, res, c) for c in center]
    m = -(-(n + sum(map(len, edges))) // 8) * 8
    p = (center[:, None] + rng.uniform(-1.3 * half, 1.3 * half, (3, m))
         ).astype(np.float32)
    at = n
    for d, vals in enumerate(edges):
        p[d, at:at + len(vals)] = vals
        at += len(vals)
    return [torch.from_numpy(a).to(cuda).reshape(-1, 8) for a in p]


@pytest.mark.parametrize('cascades, scale', [(1, 1.0), (2, 1.0), (2, 0.7),
                                             (3, 1.5), (4, 3.0), (0, 0.5),
                                             (0, 0.7)])
def test_block_probe_xyz(cuda, cascades, scale):
    """The world-plane probe (one launch) bit-equal to its plain version on
    the card, cascaded (cascades > 0) and single-grid (0), at cascade and
    cell boundaries +-1 ulp and outside the box."""
    from nerficg_torch.ops import occupancy
    res, cap, grids = 32, 256, max(cascades, 1)
    rng = np.random.default_rng(cascades)
    flags = torch.tensor(rng.uniform(size=grids * res ** 3) < 0.4,
                         device=cuda)
    table = xbar_gather.build_block_bitfield(flags, res, cap, grids)
    center = torch.tensor([0.1, -0.2, 0.05], device=cuda)
    launches = occupancy.block_probe_xyz.launches
    if cascades > 0:
        p = _probe_points(cuda, center.cpu().numpy(), scale, res, cascades)
        args = (table, *p, center, scale, res, cascades, cap)
        got = occupancy.occupancy_probe_block_cascaded_xyz(*args)
        want = occupancy.occupancy_probe_block_cascaded_xyz_plain(*args)
    else:
        amin, amax = center - scale, center + scale
        p = _probe_points(cuda, center.cpu().numpy(), scale, res, 1)
        args = (table, *p, amin, amax, res, cap)
        got = occupancy.occupancy_probe_block_aabb_xyz(*args)
        want = occupancy.occupancy_probe_block_aabb_xyz_plain(*args)
    assert occupancy.block_probe_xyz.launches == launches + 1
    assert got.shape == p[0].shape and got.dtype == torch.bool
    assert torch.equal(got, want)


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


def _dense_cell_inputs(cuda, seed=5):
    """65,536 morton-sorted samples in [0.4, 0.6]^3 on CELL_CFG's table: a
    sub-block's windows span 1-9 base rows on the coarse levels and 1-59
    on the fine ones, so they fall on both sides of BWD_WIN_ROWS."""
    rng = np.random.default_rng(seed)
    pos = torch.tensor(rng.uniform(0.4, 0.6, (65536, 3)),
                       dtype=torch.float32, device=cuda)
    pos = pos[torch.sort(hash_window.morton_sort_keys(pos)).indices]
    pos = pos.contiguous()
    lo, win = hash_cell.cell_window_bases(pos, CELL_CFG)
    g = torch.tensor(rng.normal(size=(32, 65536)), dtype=torch.float32,
                     device=cuda)
    return pos, lo, win, g


def test_hash_cell_bwd_budget_edges(cuda):
    """#9 with windows just under, at and just over the shared budget
    (BWD_WIN_ROWS base rows), so that blocks of one level take both
    paths, and with every level forced onto the global path."""
    pos, lo, win, g = _dense_cell_inputs(cuda)
    want = hash_cell.hash_cell_bwd_plain(g, pos, lo, win, CELL_CFG, 4096)
    budget = hash_cell.BWD_WIN_ROWS
    for width in (budget - 1, budget, budget + 1):
        assert bool((win == width).any())
    resident = hash_cell.cell_bwd_paths(win)
    assert bool((resident.any(1) & ~resident.all(1)).any())
    _close_to_scatter(hash_cell.hash_cell_bwd(g, pos, lo, win, CELL_CFG,
                                              4096), want)
    every = tuple(range(16))
    assert not bool(hash_cell.cell_bwd_paths(win, every).any())
    _close_to_scatter(hash_cell.hash_cell_bwd(g, pos, lo, win, CELL_CFG,
                                              4096, global_levels=every),
                      want)


@pytest.mark.parametrize('level', [0, 1, 12, 15])
def test_hash_cell_bwd_forced_global_level(cuda, level):
    """One level that keeps some windows resident forced onto the global
    path, the others as the wrapper runs them."""
    pos, lo, win, g = _dense_cell_inputs(cuda, seed=6)
    assert bool(hash_cell.cell_bwd_paths(win)[level].any())
    _close_to_scatter(
        hash_cell.hash_cell_bwd(g, pos, lo, win, CELL_CFG, 4096,
                                global_levels=(level,)),
        hash_cell.hash_cell_bwd_plain(g, pos, lo, win, CELL_CFG, 4096))


def test_hash_cell_bwd_unsorted(cuda):
    """Unsorted samples: wide windows, most blocks on the global path."""
    _, pos, _, _, g = _cell_inputs(cuda, seed=4)
    pos = pos[torch.randperm(pos.shape[0], device=cuda)].contiguous()
    lo, win = hash_cell.cell_window_bases(pos, CELL_CFG)
    _close_to_scatter(
        hash_cell.hash_cell_bwd(g, pos, lo, win, CELL_CFG, 4096),
        hash_cell.hash_cell_bwd_plain(g, pos, lo, win, CELL_CFG, 4096))


@functools.lru_cache(maxsize=None)
def _window_fwd_global_build():
    """csrc/hash_window.cu built alone with its exact forward's
    shared-memory budget at 0 rows: every block gathers (the parent's
    arithmetic)."""
    from nerficg_torch.ops import _kernels
    csrc = Path(hash_window.__file__).resolve().parents[1] / 'csrc'
    lib, _ = _kernels.build_variant('test_window_fwd_global',
                                    csrc / 'hash_window.cu',
                                    ('nerficg_hash_window_fwd',),
                                    {'kFwdWinRows': 0})
    return lib


def _cell_fwd_inputs(cuda, n, seed, sort=True):
    """chip_smoke.py's #8 inputs: a (16, 2, 4096, 128) table U(-1, 1) and
    ``n`` samples uniform in [0.2, 0.8]^3, morton-sorted or not."""
    rng = np.random.default_rng(seed)
    table = torch.tensor(rng.uniform(-1, 1, (16, 2, 4096, 128)),
                         dtype=torch.float32, device=cuda)
    pos = torch.tensor(rng.uniform(0.2, 0.8, (n, 3)), dtype=torch.float32,
                       device=cuda)
    if sort:
        pos = pos[torch.sort(hash_window.morton_sort_keys(pos)).indices]
    pos = pos.contiguous()
    return (table, pos, *hash_cell.cell_window_bases(pos, CELL_CFG))


@pytest.mark.parametrize('n, sort', [(65536, True), (196608, True),
                                     (65536, False)])
def test_hash_cell_fwd_at_path_shapes(cuda, n, sort):
    """#8, a block per (sub-block, level), on chip_smoke.py's table: within
    atol 1e-5 of the plain version (FMA contraction) on sorted and
    unsorted samples, and the same bits from call to call."""
    table, pos, lo, win = _cell_fwd_inputs(cuda, n, seed=7, sort=sort)
    got = hash_cell.hash_cell_fwd(table, pos, lo, win, CELL_CFG)
    torch.testing.assert_close(
        got, hash_cell.hash_cell_fwd_plain(table, pos, lo, win, CELL_CFG),
        rtol=0, atol=1e-5)
    assert torch.equal(got, hash_cell.hash_cell_fwd(table, pos, lo, win,
                                                    CELL_CFG))


@pytest.mark.parametrize('n, sort', [(196608, True), (24576, True),
                                     (65536, False)])
def test_hash_window_fwd_resident_equals_global_path(cuda, n, sort):
    """#1 exact: the wrapper's kernel against a build with every block on
    the global path (the parent's gather) bit for bit, both within atol
    1e-5 of the plain version; a serving chunk's sorted windows all
    staged (large tiles), a smaller call's partly (small tiles), unsorted
    ones none past level 0."""
    rng = np.random.default_rng(8)
    table = torch.tensor(rng.uniform(-1, 1, (16, 2, 128, 128)),
                         dtype=torch.float32, device=cuda)
    pos = torch.tensor(rng.uniform(0.2, 0.8, (n, 3)), dtype=torch.float32,
                       device=cuda)
    if sort:
        pos = pos[torch.sort(hash_window.morton_sort_keys(pos)).indices]
    pos = pos.contiguous()
    lo, win = hash_window.window_bases(pos, CFG)
    paths = hash_window.window_fwd_paths(win)
    assert bool(paths.all()) == (sort and n == 196608)
    got = hash_window.hash_window_fwd(table, pos, lo, win, CFG)
    assert torch.equal(got, hash_window._launch_fwd(
        'hash_window_fwd', table, pos, lo, win, CFG,
        _window_fwd_global_build()))
    torch.testing.assert_close(
        got, hash_window.hash_window_fwd_plain(table, pos, lo, win, CFG),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize('n_corners', [1, 2, 4])
def test_hash_window_fwd_stoch_streams_at_a_training_step(cuda, n_corners):
    """#1's stochastic forward (the parent's kernel, one thread per
    (sample, level)) at a training step's 65,536 samples: saved corners
    and weights bit-equal to the plain version's, output within atol 1e-5
    and the same bits from call to call."""
    rng = np.random.default_rng(9)
    table = torch.tensor(rng.uniform(-1, 1, (16, 2, 128, 128)),
                         dtype=torch.float32, device=cuda)
    pos = torch.tensor(rng.uniform(0.2, 0.8, (65536, 3)),
                       dtype=torch.float32, device=cuda)
    pos = pos[torch.sort(hash_window.morton_sort_keys(pos)).indices]
    pos = pos.contiguous()
    lo, win = hash_window.window_bases(pos, CFG)
    args = (table, pos, lo, win, CFG, n_corners, 0x9E3779B9)
    out, idx, w = hash_window.hash_window_fwd_stoch(*args, save=True)
    out_p, idx_p, w_p = hash_window.hash_window_fwd_stoch_plain(*args,
                                                                save=True)
    assert torch.equal(idx, idx_p) and torch.equal(w, w_p)
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-5)
    again = hash_window.hash_window_fwd_stoch(*args, save=True)
    assert all(torch.equal(a, b) for a, b in zip(again, (out, idx, w)))


def test_seg_gather_negative_and_out_of_range_ids(cuda):
    """#6 on ids in [-2 size, 2 size): from the end in [-size, -1], clamped
    past that, bit-exact against the plain version."""
    rng = np.random.default_rng(10)
    rows = 13
    size = rows * 128
    ids = rng.integers(-2 * size, 2 * size, (2, 24576))
    ids[0, :6] = [-1, -size, -size - 1, size - 1, size, -2 * size]
    idx = torch.tensor(ids, dtype=torch.int32, device=cuda)
    table = torch.tensor(rng.normal(size=(2, 5, rows, 128)),
                         dtype=torch.float32, device=cuda)
    assert torch.equal(hash_mxu.seg_gather(idx, table),
                       hash_mxu.seg_gather_plain(idx, table))


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


def _xbar_fwd_paths(table, pos, cfg, n_corners, seed):
    """The forward on the level-resident path (whatever the call's size)
    and on the gather path, with saves: two (out, idx, w)."""
    resident = hash_xbar.xbar_fwd_plan(cfg, pos.shape[0], min_samples=0)
    assert resident.path == 'resident'
    gather = hash_xbar.XbarFwdPlan('gather', 0, resident.level_rows, 0)
    args = ('hash_xbar_fwd', table, pos, cfg, n_corners, seed, True)
    return (hash_xbar._launch_fwd(*args, plan=resident),
            hash_xbar._launch_fwd(*args, plan=gather))


@pytest.mark.parametrize('n_corners', [0, 1, 2, 4])
def test_hash_xbar_fwd_resident_equals_gather(cuda, n_corners):
    """The level-resident forward against the gather path bit for bit,
    output and saved corner streams (the same corners, the same explicit
    sum in corner order), on ray-ordered positions; both within atol 1e-5
    of the plain version, the streams equal to its."""
    table, pos, _ = _xbar_inputs(cuda, seed=15)
    pos = pos[torch.argsort(pos[:, 0])].contiguous()
    resident, gather = _xbar_fwd_paths(table, pos, CFG, n_corners, 0xFACE)
    for a, b in zip(resident, gather):
        assert torch.equal(a, b)
    out_p, idx_p, w_p = hash_xbar.hash_xbar_fwd_plain(
        table, pos, CFG, n_corners, 0xFACE, save=True)
    assert torch.equal(resident[1], idx_p)
    assert torch.equal(resident[2], w_p)
    torch.testing.assert_close(resident[0], out_p, rtol=0, atol=1e-5)


@pytest.mark.parametrize('n', [1, 1000, 70000])
def test_hash_xbar_fwd_ragged(cuda, n):
    """Sample counts that leave the last chunk ragged, one tile, and more
    chunks than the tiles divide evenly: both paths bit-equal and close to
    the plain version; the wrapper takes the gather path under
    FWD_MIN_SAMPLES and counts one launch."""
    rng = np.random.default_rng(n + 1)
    table = torch.tensor(rng.uniform(-1, 1, (16, 2, 128, 128)),
                         dtype=torch.float32, device=cuda)
    pos = torch.tensor(rng.uniform(0, 1 - 1e-6, (n, 3)), dtype=torch.float32,
                       device=cuda)
    resident, gather = _xbar_fwd_paths(table, pos, CFG, 4, 21)
    for a, b in zip(resident, gather):
        assert torch.equal(a, b)
    want = hash_xbar.hash_xbar_fwd_plain(table, pos, CFG)
    before = hash_xbar.hash_xbar_fwd.launches
    got = hash_xbar.hash_xbar_fwd(table, pos, CFG)
    assert hash_xbar.hash_xbar_fwd.launches == before + 1
    assert hash_xbar.xbar_fwd_plan(CFG, n).path == (
        'gather' if n < hash_xbar.FWD_MIN_SAMPLES else 'resident')
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)


def test_hash_xbar_fwd_gather_path(cuda):
    """A 2^16-entry table's level does not fit a block's shared memory:
    the wrapper takes the gather kernel, within atol 1e-5 of the plain
    version."""
    cfg = HashGridConfig(num_levels=16, features_per_level=2,
                         log2_table_size=16, base_resolution=16,
                         target_resolution=2048)
    assert hash_xbar.xbar_fwd_plan(cfg, 262144).path == 'gather'
    rng = np.random.default_rng(16)
    table = torch.tensor(rng.uniform(-1, 1, (16, 2, 512, 128)),
                         dtype=torch.float32, device=cuda)
    _, pos, _ = _xbar_inputs(cuda, seed=17)
    torch.testing.assert_close(hash_xbar.hash_xbar_fwd(table, pos, cfg),
                               hash_xbar.hash_xbar_fwd_plain(table, pos, cfg),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize('n_corners', [0, 4])
def test_hash_xbar_bwd(cuda, n_corners):
    _, pos, g = _xbar_inputs(cuda, seed=3)
    _close_to_scatter(
        hash_xbar.hash_xbar_bwd(g, pos, CFG, 128, n_corners, 99),
        hash_xbar.hash_xbar_bwd_plain(g, pos, CFG, 128, n_corners, 99))


def _gs_stream(cuda, packed, seed=4):
    """The rasterizer's stream of 6000 projected Gaussians over a 160x120
    frame (many tiles past k = 256), either layout."""
    rng = np.random.default_rng(seed)
    n = 6000

    def t(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=cuda)

    stream = gs_rasterize.entry_stream(
        t(np.stack([rng.uniform(-20, 180, n), rng.uniform(-20, 140, n)], -1)),
        t(rng.uniform(0.5, 5.0, n)),
        t(np.stack([rng.uniform(0.01, 0.3, n), rng.uniform(-0.01, 0.01, n),
                    rng.uniform(0.01, 0.3, n)], -1)),
        t(np.ceil(rng.uniform(1, 30, n))), t(rng.uniform(0, 1, (n, 3))),
        t(rng.uniform(0.05, 0.99, n)), t(rng.random(n) > 0.05, torch.bool),
        160, 120, 6, 256, packed_inference=packed)
    args = (stream['sorted_mat'], stream['starts'], stream['counts'],
            stream['tiles_x'], stream['num_tiles'], 256)
    assert int(stream['counts'].max()) > 256
    return args


def test_gs_composite_fwd(cuda):
    """Composite and saved transmittance (the chunks each tile composites,
    the only ones the kernel writes) atol 1e-5: the alpha test sees the
    plain version's bits; sums run in another order."""
    args = _gs_stream(cuda, packed=False)
    out, tacc = gs_tiles_kernel.gs_composite_fwd(*args)
    out_p, tacc_p = gs_tiles_kernel.gs_composite_fwd_plain(*args)
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-5)
    live = gs_tiles_kernel.live_chunks(args[2], args[5])
    torch.testing.assert_close(tacc[live], tacc_p[live], rtol=0, atol=1e-5)


def test_gs_composite_fwd_packed(cuda):
    args = _gs_stream(cuda, packed=True)
    torch.testing.assert_close(
        gs_tiles_kernel.gs_composite_fwd_packed(*args),
        gs_tiles_kernel.gs_composite_fwd_plain(*args, save_tacc=False),
        rtol=0, atol=1e-5)
    with pytest.raises(KernelError):
        gs_tiles_kernel.gs_composite_fwd(*args)


def test_gs_composite_bwd(cuda):
    """Within the JAX package's 2e-3 / 1e-3 of autograd of the plain
    version, and bit-equal between two launches (no atomics)."""
    args = _gs_stream(cuda, packed=False, seed=5)
    _, tacc = gs_tiles_kernel.gs_composite_fwd(*args)
    dout = torch.tensor(np.random.default_rng(6).normal(
        size=(args[4], 5, 256)), dtype=torch.float32, device=cuda)
    got = gs_tiles_kernel.gs_composite_bwd(*args[:3], tacc, dout, *args[3:])
    want = gs_tiles_kernel.gs_composite_bwd_plain(*args[:3], dout, *args[3:])
    torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-3)
    assert torch.equal(got, gs_tiles_kernel.gs_composite_bwd(
        *args[:3], tacc, dout, *args[3:]))


def _edge_tiles(device, k=64, seed=11):
    """A hand-built 16-wide stream over a 32x32 frame (2 x 2 tiles) whose
    tiles hold 0 entries, 45 (not a multiple of the 32-entry chunk), 100
    (above k) and 32 small Gaussians in the tile's top two pixel rows, so
    that only the first warps' pixels are reached."""
    rng = np.random.default_rng(seed)
    counts = np.array([0, 45, 100, 32])
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    origins = [(0, 0), (16, 0), (0, 16), (16, 16)]
    entries = []
    for (ox, oy), n, small in zip(origins, counts, (False, False, False,
                                                    True)):
        mx = ox + rng.uniform(0, 16, n)
        my = oy + (rng.uniform(0, 2, n) if small else rng.uniform(0, 16, n))
        inv = rng.uniform(1.5, 3.0, n) if small else rng.uniform(0.05, 0.5, n)
        cb = rng.uniform(-0.02, 0.02, n)
        entries.append(np.stack([mx, my, inv, cb, inv, rng.uniform(0.05, 0.99, n),
                                 *rng.uniform(0, 1, (3, n)),
                                 rng.uniform(1, 5, n)], 0))
    mat = np.zeros((16, int(counts.sum()) + 3 * k), np.float32)
    mat[:10, :int(counts.sum())] = np.concatenate(entries, 1)

    def t(a, dtype=torch.float32):
        return torch.tensor(a, dtype=dtype, device=device)
    return (t(mat), t(starts, torch.int32), t(counts, torch.int32), 2, 4, k)


@pytest.mark.parametrize('layout', ['stream', 'slots'])
def test_gs_bwd_edge_tiles(cuda, layout):
    """#16 (stream) and #14 (slots) on tiles with 0, 45, 100 > k and 32
    entries, the last reaching only its first warps' pixels: within the
    JAX package's 2e-3 / 1e-3 of autograd of the plain version, zero past
    each tile's min(count, k), bit-equal between two launches."""
    args = _edge_tiles(cuda)
    mat, starts, counts, tiles_x, num_tiles, k = args
    dout = torch.tensor(np.random.default_rng(12).normal(
        size=(num_tiles, 5, 256)), dtype=torch.float32, device=cuda)
    if layout == 'stream':
        _, tacc = gs_tiles_kernel.gs_composite_fwd(*args)

        def run():
            return gs_tiles_kernel.gs_composite_bwd(*args[:3], tacc, dout,
                                                    *args[3:])
        want = gs_tiles_kernel.gs_composite_bwd_plain(*args[:3], dout,
                                                      *args[3:])
        got = run()
        composited = torch.zeros(mat.shape[1], dtype=torch.bool,
                                 device=cuda)
        for start, count in zip(starts.tolist(), counts.tolist()):
            composited[start:start + min(count, k)] = True
        assert not got[:, ~composited].any()
        assert bool(got[:10, composited].abs().sum(1).gt(0).all())
    else:
        slots, _ = gs_tiles_kernel._slots(mat, starts, tiles_x, k, 0,
                                          num_tiles)
        slots = slots.contiguous()
        origins = gs_tiles_kernel._tile_origins(num_tiles, tiles_x, cuda)
        dout8 = torch.nn.functional.pad(dout, (0, 0, 0, 3))

        def run():
            return gs_tiles_kernel.gs_tiles_bwd(slots, counts, origins,
                                                dout8)
        want = gs_tiles_kernel.gs_tiles_bwd_plain(slots, counts, origins,
                                                  dout8)
        got = run()
        past = torch.arange(k, device=cuda)[None] >= counts[:, None].long()
        assert not got[past].any()
    torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-3)
    assert torch.equal(got, run())


@pytest.mark.parametrize('layout', ['stream', 'slots'])
def test_gs_fwd_edge_tiles(cuda, layout):
    """The culled forwards (#15 with its saved transmittance, #13) on the
    edge tiles above: 0, 45, 100 > k and 32 entries, the last reaching only
    its first warps' pixels; within atol 1e-5 of the plain version, equal
    between two launches."""
    args = _edge_tiles(cuda)
    mat, starts, counts, tiles_x, num_tiles, k = args
    if layout == 'stream':
        out, tacc = gs_tiles_kernel.gs_composite_fwd(*args)
        out_p, tacc_p = gs_tiles_kernel.gs_composite_fwd_plain(*args)
        live = gs_tiles_kernel.live_chunks(counts, k)
        torch.testing.assert_close(tacc[live], tacc_p[live], rtol=0,
                                   atol=1e-5)
        again, _ = gs_tiles_kernel.gs_composite_fwd(*args)
    else:
        slots, _ = gs_tiles_kernel._slots(mat, starts, tiles_x, k, 0,
                                          num_tiles)
        slots = slots.contiguous()
        origins = gs_tiles_kernel._tile_origins(num_tiles, tiles_x, cuda)
        out = gs_tiles_kernel.gs_tiles_fwd(slots, counts, origins)
        out_p = gs_tiles_kernel.gs_tiles_fwd_plain(slots, counts, origins)
        again = gs_tiles_kernel.gs_tiles_fwd(slots, counts, origins)
    torch.testing.assert_close(out, out_p, rtol=0, atol=1e-5)
    assert torch.equal(out, again)
    # The last tile's Gaussians lie in its top two pixel rows.
    assert float(out[3, 3, 128:].abs().max()) < float(out[3, 3, :32].max())


@pytest.mark.parametrize('n_corners', [0, 1, 2, 4])
def test_hash_xbar_bwd_pos(cuda, n_corners):
    """The position gradient against its plain version on the same bits:
    equal (the kernel keeps the plain version's order of operations with
    _rn intrinsics and sums the levels in order), and equal between two
    launches (no atomics in the sums)."""
    table, pos, g = _xbar_inputs(cuda, seed=7)
    args = (table, pos, g, CFG, n_corners, 0x5EED)
    got = hash_xbar.hash_xbar_bwd_pos(*args)
    want = hash_xbar.hash_xbar_bwd_pos_plain(*args)
    assert torch.equal(got, want)
    assert torch.equal(got, hash_xbar.hash_xbar_bwd_pos(*args))
    if n_corners != 1:
        assert float(got.abs().max()) > 1.0


def _sparse_cotangent(g, seed):
    """g with a quarter of its (sample, level) pairs zeroed, both features:
    the kernels skip those pairs."""
    rng = np.random.default_rng(seed)
    keep = rng.random((g.shape[0], g.shape[1] // 2)) >= 0.25
    mask = torch.tensor(np.repeat(keep, 2, axis=1), device=g.device)
    return torch.where(mask, g, torch.zeros_like(g))


@pytest.mark.parametrize('n_corners', [0, 1, 2, 4])
def test_hash_xbar_bwd_fused(cuda, n_corners):
    """Both gradients from one call of the level-resident kernel: the
    table gradient as the atomics allow, the position gradient bit for bit,
    on ray-ordered positions (neighbours share the coarse levels' corners)
    and a cotangent with zero pairs."""
    table, pos, g = _xbar_inputs(cuda, seed=11)
    pos = pos[torch.argsort(pos[:, 0])].contiguous()
    g = _sparse_cotangent(g, 12)
    args = (table, pos, g, CFG, n_corners, 0xC0FFEE)
    assert hash_xbar.xbar_bwd_plan(CFG, pos.shape[0]).path == 'resident'
    before = (hash_xbar.hash_xbar_bwd_fused.launches,
              hash_xbar.hash_xbar_bwd.launches,
              hash_xbar.hash_xbar_bwd_pos.launches)
    dtab, dpos = hash_xbar.hash_xbar_bwd_fused(*args)
    after = (hash_xbar.hash_xbar_bwd_fused.launches,
             hash_xbar.hash_xbar_bwd.launches,
             hash_xbar.hash_xbar_bwd_pos.launches)
    assert after == (before[0] + 1, before[1], before[2])
    want_tab = hash_xbar.hash_xbar_bwd_plain(g, pos, CFG, 128, n_corners,
                                             0xC0FFEE)
    _close_to_scatter(dtab, want_tab)
    assert torch.equal(dpos, hash_xbar.hash_xbar_bwd_pos_plain(*args))
    _close_to_scatter(hash_xbar.hash_xbar_bwd(g, pos, CFG, 128, n_corners,
                                              0xC0FFEE), want_tab)


@pytest.mark.parametrize('n', [1, 1000, 70000])
def test_hash_xbar_bwd_fused_ragged(cuda, n):
    """Sample counts that leave the last chunk of 1024 ragged, one tile, or
    more chunks than a tile count divides evenly."""
    rng = np.random.default_rng(n)
    table = torch.tensor(rng.uniform(-1, 1, (16, 2, 128, 128)),
                         dtype=torch.float32, device=cuda)
    pos = torch.tensor(rng.uniform(0, 1 - 1e-6, (n, 3)), dtype=torch.float32,
                       device=cuda)
    g = torch.tensor(rng.normal(size=(n, 32)), dtype=torch.float32,
                     device=cuda)
    dtab, dpos = hash_xbar.hash_xbar_bwd_fused(table, pos, g, CFG)
    _close_to_scatter(dtab, hash_xbar.hash_xbar_bwd_plain(g, pos, CFG, 128))
    assert torch.equal(dpos, hash_xbar.hash_xbar_bwd_pos_plain(table, pos, g,
                                                               CFG))


def test_hash_xbar_bwd_gather_path(cuda):
    """A 2^16-entry table does not fit a block's shared memory: the same
    wrappers take the gather kernels, checked the same way."""
    cfg = HashGridConfig(num_levels=16, features_per_level=2,
                         log2_table_size=16, base_resolution=16,
                         target_resolution=2048)
    assert hash_xbar.xbar_bwd_plan(cfg, 16384).path == 'gather'
    rng = np.random.default_rng(13)
    table = torch.tensor(rng.uniform(-1, 1, (16, 2, 512, 128)),
                         dtype=torch.float32, device=cuda)
    _, pos, g = _xbar_inputs(cuda, seed=14)
    dtab, dpos = hash_xbar.hash_xbar_bwd_fused(table, pos, g, cfg, 4, 5)
    _close_to_scatter(dtab, hash_xbar.hash_xbar_bwd_plain(g, pos, cfg, 512,
                                                          4, 5))
    assert torch.equal(dpos, hash_xbar.hash_xbar_bwd_pos_plain(table, pos, g,
                                                               cfg, 4, 5))


def _slot_inputs(cuda):
    """Slots of the rasterizer's 160x120 stream (``_slots``), k = 256."""
    args = _gs_stream(cuda, packed=False, seed=8)
    mat, starts, counts, tiles_x, num_tiles, k = args
    slots, _ = gs_tiles_kernel._slots(mat, starts, tiles_x, k, 0, num_tiles)
    origins = gs_tiles_kernel._tile_origins(num_tiles, tiles_x, cuda)
    return args, slots.contiguous(), counts, origins


def test_gs_tiles_fwd_and_bwd(cuda):
    """#13 atol 1e-5 against its plain version and, in rows 0-4, against
    #15 on the same tiles (two kernels of one function); #14 within the JAX
    package's 2e-3 / 1e-3 of autograd of the plain version, zero past each
    count, and equal between two launches."""
    args, slots, counts, origins = _slot_inputs(cuda)
    out = gs_tiles_kernel.gs_tiles_fwd(slots, counts, origins)
    torch.testing.assert_close(
        out, gs_tiles_kernel.gs_tiles_fwd_plain(slots, counts, origins),
        rtol=0, atol=1e-5)
    stream_out, _ = gs_tiles_kernel.gs_composite_fwd(*args)
    torch.testing.assert_close(out[:, :5], stream_out, rtol=0, atol=1e-5)
    assert not out[:, 5:].any()
    dout = torch.tensor(np.random.default_rng(9).normal(
        size=(args[4], 8, 256)), dtype=torch.float32, device=cuda)
    got = gs_tiles_kernel.gs_tiles_bwd(slots, counts, origins, dout)
    want = gs_tiles_kernel.gs_tiles_bwd_plain(slots, counts, origins, dout)
    torch.testing.assert_close(got, want, rtol=1e-3, atol=2e-3)
    past = torch.arange(slots.shape[1], device=cuda)[None] >= \
        counts[:, None].long()
    assert not got[past].any()
    assert torch.equal(got, gs_tiles_kernel.gs_tiles_bwd(slots, counts,
                                                         origins, dout))


@pytest.mark.parametrize('dtype', [torch.float32, torch.int32])
def test_xbar_permute(cuda, dtype):
    rng = np.random.default_rng(10)
    bits = rng.integers(-2 ** 31, 2 ** 31, (65536, 4), dtype=np.int64)
    mat = torch.tensor(bits.astype(np.int32), device=cuda).view(dtype)
    idx = torch.tensor(rng.permutation(65536), dtype=torch.int32, device=cuda)
    got = xbar_gather.xbar_permute(mat, idx)
    want = xbar_gather.xbar_permute_plain(mat, idx)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
