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
from nerficg_torch.scripts.kernel_timing import boundary_values
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


# ---------------------------------------------------------------------------
# the probe from world planes (block_probe_xyz): cascaded and single grid
# ---------------------------------------------------------------------------

def _edge_points(edges, center, spread, n_random, seed):
    """(3, N) f32 planes: random points within ``spread`` of ``center``
    (some outside the box), then copies with one axis set to each of
    ``edges`` (that axis's boundary values)."""
    rng = np.random.default_rng(seed)
    center = np.asarray(center, np.float32)
    pts = (center[:, None] + rng.uniform(-spread, spread, (3, n_random))
           ).astype(np.float32)
    vals = np.concatenate(edges)
    axis = np.concatenate([np.full(len(e), d) for d, e in enumerate(edges)])
    on_edge = (center[:, None] + rng.uniform(-spread, spread, (3, len(vals)))
               ).astype(np.float32)
    on_edge[axis, np.arange(len(vals))] = vals
    return np.concatenate([pts, on_edge], axis=1)


def _random_table(res, grids, cap, seed):
    flags = np.random.default_rng(seed).uniform(size=grids * res ** 3) < 0.4
    return np.array(jxg.build_block_bitfield(jnp.asarray(flags), res, cap,
                                             num_grids=grids))


def _interpret_gathers():
    """The JAX probe's crossbar gathers through the TPU kernel
    ``_gather_kernel`` in interpret mode, as test_xbar_permute_moves_the_bits
    runs ``_permute_kernel``."""
    orig = jxg.pl.pallas_call

    def call(*a, **kw):
        kw['interpret'] = True
        kw.pop('compiler_params', None)
        return orig(*a, **kw)
    return (mock.patch.object(jxg.pl, 'pallas_call', call),
            mock.patch.object(jxg.jax, 'default_backend', lambda: 'tpu'))


CASCADE_CASES = [(c, s) for c in (1, 2, 3, 4) for s in (0.7, 1.0, 1.5, 3.0)]


@pytest.mark.parametrize('cascades,scale', CASCADE_CASES)
def test_cascaded_probe_plain_matches_jax(cascades, scale):
    """The cascaded probe's plain version (what a CPU tensor runs) against
    the JAX package's ``occupancy_probe_block_cascaded_xyz``, bit for bit,
    on points on every cascade and cell boundary +-1 ulp, off-center, and
    outside the outermost cascade; the cascade and cells too."""
    res, cap = 16, 64
    center = np.array([0.1, -0.2, 0.05], np.float32)
    edges = [boundary_values(scale, cascades, res, c) for c in center]
    p = _edge_points(edges, center, 1.3 * scale, 4000, seed=cascades)
    table = _random_table(res, cascades, cap, seed=cascades)
    want = np.asarray(jocc.occupancy_probe_block_cascaded_xyz(
        jnp.asarray(table), *map(jnp.asarray, p), jnp.asarray(center),
        scale, res, cascades, cap))
    pt = [torch.from_numpy(a) for a in p]
    args = (torch.from_numpy(table), *pt, torch.from_numpy(center), scale,
            res, cascades, cap)
    got = tocc.occupancy_probe_block_cascaded_xyz(*args)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tocc.occupancy_probe_block_cascaded_xyz_plain(*args).numpy(), want)
    for a, b in zip(tocc._cascade_cell_coords(*pt, torch.from_numpy(center),
                                              scale, res, cascades),
                    jocc._cascade_cell_coords(*map(jnp.asarray, p),
                                              jnp.asarray(center), scale,
                                              res, cascades)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    if (cascades, scale) == (2, 1.0):
        patches = _interpret_gathers()
        with patches[0], patches[1]:
            kernel = np.asarray(jocc.occupancy_probe_block_cascaded_xyz(
                jnp.asarray(table), *map(jnp.asarray, p),
                jnp.asarray(center), scale, res, cascades, cap))
        np.testing.assert_array_equal(got.numpy(), kernel)


@pytest.mark.parametrize('lo,hi', [((-0.5,) * 3, (0.5,) * 3),
                                   ((-0.6, -0.9, -0.8), (0.8, 0.5, 0.6)),
                                   ((-0.7,) * 3, (0.7,) * 3)])
def test_aabb_probe_plain_matches_jax(lo, hi):
    """The single-grid probe's plain version against the JAX renderer's
    composition (``occupancy_probe_block_xyz`` of the unit coordinates,
    nerficg_tpu/methods/instant_ngp/renderer.py:178-183) and the port's,
    bit for bit, on cell boundaries +-1 ulp and outside the box."""
    res, cap = 32, 128
    amin, amax = np.array(lo, np.float32), np.array(hi, np.float32)
    mid = (amin + amax) / 2
    edges = [boundary_values(float(amax[d] - amin[d]) / 2, 1, res,
                             float(mid[d])) for d in range(3)]
    p = _edge_points(edges, mid, 0.8 * float((amax - amin).max()), 4000,
                     seed=7)
    table = _random_table(res, 1, cap, seed=3)
    jl, jh = jnp.asarray(amin), jnp.asarray(amax)

    def units(q, a, b):
        return [(q[d] - a[d]) / (b[d] - a[d]) for d in range(3)]
    want = np.asarray(jocc.occupancy_probe_block_xyz(
        jnp.asarray(table), *units(list(map(jnp.asarray, p)), jl, jh),
        res, cap))
    pt = [torch.from_numpy(a) for a in p]
    tl, th = torch.from_numpy(amin), torch.from_numpy(amax)
    got = tocc.occupancy_probe_block_aabb_xyz(torch.from_numpy(table), *pt,
                                              tl, th, res, cap)
    np.testing.assert_array_equal(got.numpy(), want)
    renderer = tocc.occupancy_probe_block_xyz(
        torch.from_numpy(table), *units(pt, tl, th), res, cap)
    np.testing.assert_array_equal(renderer.numpy(), want)
    if lo == (-0.5,) * 3:
        patches = _interpret_gathers()
        with patches[0], patches[1]:
            kernel = np.asarray(jocc.occupancy_probe_block_xyz(
                jnp.asarray(table),
                *units(list(map(jnp.asarray, p)), jl, jh), res, cap))
        np.testing.assert_array_equal(got.numpy(), kernel)


def test_probe_xyz_refuses_non_cpu_tensors_without_a_kernel():
    table = torch.empty((10, 128), dtype=torch.int32, device='meta')
    p = torch.empty((64, 8), device='meta')
    box = torch.empty(3, device='meta')
    with pytest.raises(KernelError):
        tocc.occupancy_probe_block_cascaded_xyz(table, p, p, p, box, 1.0, 32,
                                                2, 64)
    with pytest.raises(KernelError):
        tocc.occupancy_probe_block_aabb_xyz(table, p, p, p, box, box, 32, 64)
