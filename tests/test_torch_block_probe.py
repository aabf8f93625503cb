"""Parity of the port's block bitfield and probe (nerficg_torch/ops/
xbar_gather.py) with the JAX package's (nerficg_tpu/ops/xbar_gather.py) on
the CPU, where the JAX probe's crossbar gathers are ``table.reshape(-1)[idx]``.
Both are integer functions and must agree exactly, including overflow blocks
and two grids (cascades). The row permutation ``xbar_permute`` (#5) moves
bits and must agree exactly too, with JAX's CPU path and with the TPU
kernel ``_permute_kernel`` run in interpret mode."""

from unittest import mock

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import occupancy as tocc
from nerficg_torch.ops import xbar_gather as txg
from nerficg_tpu.ops import occupancy as jocc
from nerficg_tpu.ops import xbar_gather as jxg
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _flags(res, grids, seed=0, shell=True):
    """Shell-shaped occupancy (a few occupied blocks) or random noise (every
    block occupied, so a small cap overflows)."""
    rng = np.random.default_rng(seed)
    if not shell:
        return rng.uniform(size=grids * res ** 3) < 0.05
    idx = (np.arange(res) + 0.5) / res - 0.5
    x, y, z = np.meshgrid(idx, idx, idx, indexing='ij')
    r = np.sqrt(x * x + y * y + z * z)
    one = np.abs(r - 0.3) < 1.5 / res
    return np.concatenate([np.roll(one, g, axis=0).reshape(-1)
                           for g in range(grids)])


CASES = [  # (res, grids, cap_blocks, shell)
    (32, 1, 64, True), (32, 2, 64, True), (32, 2, 16, True),
    (16, 2, 8, False), (64, 2, 256, True)]


@pytest.mark.parametrize('res,grids,cap,shell', CASES)
def test_bitfield_matches(res, grids, cap, shell):
    flags = _flags(res, grids, shell=shell)
    want = np.asarray(jxg.build_block_bitfield(jnp.asarray(flags), res, cap,
                                               num_grids=grids))
    got = txg.build_block_bitfield(torch.from_numpy(flags), res, cap,
                                   num_grids=grids)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    assert txg.block_table_rows(res, cap, grids) == \
        jxg.block_table_rows(res, cap, grids)


@pytest.mark.parametrize('res,grids,cap,shell', CASES)
def test_probe_matches(res, grids, cap, shell):
    flags = _flags(res, grids, shell=shell)
    table = np.array(jxg.build_block_bitfield(jnp.asarray(flags), res, cap,
                                              num_grids=grids))
    rng = np.random.default_rng(1)
    m = 20000
    cells = np.concatenate([rng.choice(np.flatnonzero(flags), m // 2),
                            rng.integers(0, grids * res ** 3, m - m // 2)])
    g = (cells // res ** 3).astype(np.int32)
    local = cells % res ** 3
    cxyz = [(local // (res * res)).astype(np.int32),
            ((local // res) % res).astype(np.int32),
            (local % res).astype(np.int32)]
    gi_j = jnp.asarray(g) if grids > 1 else 0
    gi_t = torch.from_numpy(g) if grids > 1 else 0
    want = np.asarray(jxg.block_probe_cells(
        jnp.asarray(table), *map(jnp.asarray, cxyz), gi_j, res, cap,
        num_grids=grids))
    got = txg.block_probe_cells(torch.from_numpy(table),
                                *map(torch.from_numpy, cxyz), gi_t, res, cap,
                                num_grids=grids)
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), want)
    # conservative: every occupied cell probes occupied
    assert got.numpy()[:m // 2].all()


def test_popcount_matches_numpy():
    rng = np.random.default_rng(0)
    words = np.concatenate([rng.integers(0, 1 << 32, 4096, dtype=np.int64),
                            [0, 1, (1 << 32) - 1, 1 << 31]])
    want = np.array([bin(int(w)).count('1') for w in words])
    np.testing.assert_array_equal(
        txg._popcount32(torch.from_numpy(words)).numpy(), want)


@pytest.mark.parametrize('cascades', [1, 2])
def test_downsampled_block_grid_matches(cascades):
    rng = np.random.default_rng(2)
    res, mres, cap = 32, 16, 64
    grid = (rng.uniform(size=cascades * res ** 3) ** 8 * 50).astype(np.float32)
    if cascades > 1:
        want = jocc.downsample_occupancy_cascaded_block(
            jnp.asarray(grid), res, mres, 10.0, cascades, cap)
        got = tocc.downsample_occupancy_cascaded_block(
            torch.from_numpy(grid), res, mres, 10.0, cascades, cap)
    else:
        want = jocc.downsample_occupancy_block(jnp.asarray(grid), res, mres,
                                               10.0, cap)
        got = tocc.downsample_occupancy_block(torch.from_numpy(grid), res,
                                              mres, 10.0, cap)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_wrapper_refuses_non_cpu_tensors_without_a_kernel():
    table = torch.empty((10, 128), dtype=torch.int32, device='meta')
    c = torch.empty(64, dtype=torch.int32, device='meta')
    with pytest.raises(KernelError):
        txg.block_probe_cells(table, c, c, c, 0, 32, 64)


def _permute_inputs(dtype, n=3000, cols=4, seed=0):
    rng = np.random.default_rng(seed)
    if dtype == np.int32:
        mat = rng.integers(-2 ** 31, 2 ** 31, (n, cols), dtype=np.int64
                           ).astype(np.int32)
    else:
        # Every bit pattern, NaNs and infinities included.
        mat = rng.integers(0, 2 ** 32, (n, cols), dtype=np.uint64).astype(
            np.uint32).view(np.float32)
    return mat, rng.permutation(n).astype(np.int32)


@pytest.mark.parametrize('dtype', [np.float32, np.int32])
def test_xbar_permute_moves_the_bits(dtype):
    """Against the JAX entry point's CPU path (``mat[idx]``) and against
    ``_permute_kernel`` in interpret mode: ``pallas_call`` patched as
    tests/test_hash_xbar.py patches it and the backend check (:122) made to
    see a TPU. Bit for bit, over an (N, 4) matrix, N not a multiple of the
    TPU's 1024-row padding."""
    mat, idx = _permute_inputs(dtype)
    got = txg.xbar_permute(torch.from_numpy(mat), torch.from_numpy(idx))
    got = got.numpy().view(np.uint32)
    want = np.asarray(jxg.xbar_permute(jnp.asarray(mat), jnp.asarray(idx)))
    np.testing.assert_array_equal(got, want.view(np.uint32))
    orig = jxg.pl.pallas_call

    def call(*a, **kw):
        kw['interpret'] = True
        kw.pop('compiler_params', None)
        return orig(*a, **kw)
    with mock.patch.object(jxg.pl, 'pallas_call', call), \
            mock.patch.object(jxg.jax, 'default_backend', lambda: 'tpu'):
        kernel = np.asarray(jxg.xbar_permute(jnp.asarray(mat),
                                             jnp.asarray(idx)))
    np.testing.assert_array_equal(got, kernel.view(np.uint32))


def test_xbar_permute_refuses_non_cpu_tensors_without_a_kernel():
    mat = torch.empty((100, 4), device='meta')
    idx = torch.empty(100, dtype=torch.int32, device='meta')
    with pytest.raises(KernelError):
        txg.xbar_permute(mat, idx)
    with pytest.raises(KernelError):
        txg.xbar_permute(torch.empty((100, 4), dtype=torch.float64,
                                     device='meta'), idx)
