"""The port's four CUDA kernels against their plain PyTorch versions, on a
card. Marked ``cuda``: without a card every test here skips. On a machine
with one: ``python -m pytest tests/test_torch_cuda_kernels.py -m cuda``
(chip_smoke.py runs the same comparisons at the serving path's shapes)."""

import numpy as np
import pytest
import torch

from nerficg_torch.ops import hash_mxu, hash_window, xbar_gather
from nerficg_torch.ops.hashgrid import HashGridConfig

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    return torch.device('cuda')


def test_hash_window_fwd(cuda):
    """atol 1e-5: f32 FMA contraction and sum order in the kernel."""
    cfg = HashGridConfig(num_levels=16, features_per_level=2,
                         log2_table_size=14, base_resolution=16,
                         target_resolution=2048, anchor_stride=8)
    rng = np.random.default_rng(0)
    table = torch.tensor(rng.uniform(-1, 1, (16, 2, 128, 128)),
                         dtype=torch.float32, device=cuda)
    pos = torch.tensor(rng.uniform(0, 1, (16384, 3)), dtype=torch.float32,
                       device=cuda)
    pos = pos[torch.sort(hash_window.morton_sort_keys(pos)).indices]
    pos = pos.contiguous()
    lo, win = hash_window.window_bases(pos, cfg)
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
