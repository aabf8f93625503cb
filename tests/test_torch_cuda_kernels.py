"""The port's CUDA kernels against their plain PyTorch versions, on a
card. Marked ``cuda``: without a card every test here skips. On a machine
with one: ``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``
(chip_smoke.py runs the same comparisons at the serving path's shapes)."""

import numpy as np
import pytest
import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import (gs_rasterize, gs_tiles_kernel, hash_cell,
                               hash_mxu, hash_window, hash_xbar, xbar_gather)
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


@pytest.mark.parametrize('n_corners', [0, 1, 2, 4])
def test_hash_xbar_bwd_pos(cuda, n_corners):
    """The position gradient against its plain version on the same bits:
    rtol 1e-5 (the kernel keeps the plain version's order of operations
    with _rn intrinsics), and equal between two launches (no atomics)."""
    table, pos, g = _xbar_inputs(cuda, seed=7)
    args = (table, pos, g, CFG, n_corners, 0x5EED)
    got = hash_xbar.hash_xbar_bwd_pos(*args)
    want = hash_xbar.hash_xbar_bwd_pos_plain(*args)
    torch.testing.assert_close(got, want, rtol=1e-5,
                               atol=1e-6 * float(want.abs().max()))
    assert torch.equal(got, hash_xbar.hash_xbar_bwd_pos(*args))
    if n_corners != 1:
        assert float(got.abs().max()) > 1.0


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
