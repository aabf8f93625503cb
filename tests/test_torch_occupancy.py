"""Parity of the port's marcher and compositor (nerficg_torch/ops/occupancy.py)
with the JAX package's (nerficg_tpu/ops/occupancy.py) on the CPU.

The same rays and occupancy grid go through both. The marcher's integer
outputs (which blocks survive compaction, in which order, the permutations
between ray and morton order, sample validity) must agree exactly; its float
outputs are the same f32 expressions and agree to 1e-6 relative.
``composite_packed`` agrees to 1e-5 (f32 prefix sums in another order). Its
transmittance is a difference of global prefix sums of log(1 - alpha), so
f32 rounding grows with the batch's total optical depth: the densities here
keep that total near 100, where one ulp is 8e-6.

Training adds the jittered marcher (the port is handed the uint32 seed that
``jax.random.bits`` draws from the JAX marcher's key), the composite's
gradients, and the density-grid update given the draws JAX makes from its
key.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.ops import occupancy as tocc
from nerficg_tpu.ops import occupancy as jocc
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL_COMPOSITE = 1e-5


def _rays(n, seed=0):
    """Rays from a ring of cameras at distance 2.5 toward the unit box."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    origins = np.stack([2.5 * np.sin(ang), rng.uniform(-0.5, 0.5, n),
                        2.5 * np.cos(ang)], -1)
    target = rng.uniform(-0.6, 0.6, (n, 3))
    d = target - origins
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    origins, d = origins.astype(np.float32), d.astype(np.float32)
    d[-3:] = 0.0     # padding rays (zero directions) are misses
    return origins, d


def _grid(res, cascades, scale, seed=0):
    """Occupancy: a shell of radius 0.6 * scale plus sparse noise."""
    rng = np.random.default_rng(seed)
    grids = []
    for c in range(cascades):
        half = scale / 2 ** (cascades - 1) * 2 ** c
        ax = ((np.arange(res) + 0.5) / res - 0.5) * 2 * half
        x, y, z = np.meshgrid(ax, ax, ax, indexing='ij')
        r = np.sqrt(x * x + y * y + z * z)
        g = (np.abs(r - 0.6 * scale) < 2.5 * half / res) | \
            (rng.uniform(size=r.shape) < 0.002)
        grids.append(g.reshape(-1))
    return np.concatenate(grids)


@functools.lru_cache(maxsize=None)
def _march_both(scale, num_rays, max_steps, budget, probes, key=None,
                morton=True):
    cascades = jocc.num_cascades(scale)
    assert tocc.num_cascades(scale) == cascades
    res, cap = 32, 128
    flags = _grid(res, cascades, scale)
    grid = flags.astype(np.float32) * 100.0
    origins, dirs = _rays(num_rays)
    exponential = cascades > 1
    amin = np.full(3, -scale, np.float32)
    amax = np.full(3, scale, np.float32)
    center = np.zeros(3, np.float32)

    def run(mod, tensor, table):
        if cascades > 1:
            probe = lambda px, py, pz: mod.occupancy_probe_block_cascaded_xyz(
                table, px, py, pz, tensor(center), scale, res, cascades, cap)
        else:
            lo, hi = tensor(amin), tensor(amax)
            probe = lambda px, py, pz: mod.occupancy_probe_block_xyz(
                table, (px - lo[0]) / (hi[0] - lo[0]),
                (py - lo[1]) / (hi[1] - lo[1]),
                (pz - lo[2]) / (hi[2] - lo[2]), res, cap)
        kw = dict(max_steps=max_steps, sample_budget=budget, block=8,
                  exponential=exponential, morton=morton,
                  probes_per_block=probes)
        rng = None if key is None else jax.random.PRNGKey(key)
        if mod is jocc:
            # Eager, op by op: under jit XLA may contract the step and
            # probe arithmetic into FMAs and move a probe across a cell
            # boundary, so only the unfused function is an exact reference.
            return mod.march_rays(tensor(origins), tensor(dirs), tensor(amin),
                                  tensor(amax), table, res, probe_fn=probe,
                                  rng=rng, **kw)
        seed = None if rng is None else int(jax.random.bits(rng, dtype=jnp.uint32))
        return mod.march_rays(tensor(origins), tensor(dirs), tensor(amin),
                              tensor(amax), probe, seed=seed, **kw)

    if cascades > 1:
        jt = jocc.downsample_occupancy_cascaded_block(
            jnp.asarray(grid), res, res, 1.0, cascades, cap)
        tt = tocc.downsample_occupancy_cascaded_block(
            torch.from_numpy(grid), res, res, 1.0, cascades, cap)
    else:
        jt = jocc.downsample_occupancy_block(jnp.asarray(grid), res, res, 1.0,
                                             cap)
        tt = tocc.downsample_occupancy_block(torch.from_numpy(grid), res, res,
                                             1.0, cap)
    jm = run(jocc, jnp.asarray, jt)
    tm = run(tocc, torch.from_numpy, tt)
    return jm, tm


# (scale, rays, max steps, sample budget, probes per block): one cascade
# with linear steps, two cascades with exponential steps, and a budget that
# truncates so the stable-sort tie order decides which blocks survive.
MARCH_CASES = [(0.5, 256, 64, 256 * 16, 7), (1.0, 256, 64, 256 * 16, 7),
               (1.0, 256, 64, 256 * 2, 7)]


@pytest.mark.parametrize('key', [None, 3])
@pytest.mark.parametrize('case', MARCH_CASES)
def test_march_rays_matches(case, key):
    """``key`` set: jittered samples (training), the port handed the seed
    ``jax.random.bits(key, uint32)`` that the JAX marcher draws."""
    jm, tm = _march_both(*case, key=key)
    assert int(jm.num_blocks) > 0
    exact = ('ray_ids', 'valid', 'num_valid', 'ray_complete', 'num_blocks',
             'ray_ids_m', 'perm_to_ray', 'perm_to_morton', 'block_keys_m')
    for name in exact:
        np.testing.assert_array_equal(
            getattr(tm, name).numpy(), np.asarray(getattr(jm, name)),
            err_msg=name)
    for name in ('positions', 'directions', 'ts', 'deltas', 'positions_m',
                 'directions_m'):
        np.testing.assert_allclose(
            getattr(tm, name).numpy(), np.asarray(getattr(jm, name)),
            rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize('case', MARCH_CASES)
def test_march_rays_ray_order_matches(case):
    """``morton=False``, the crossbar encode's marcher: the ray-ordered
    stream equals JAX's, jittered, and no morton view is built."""
    jm, tm = _march_both(*case, key=5, morton=False)
    assert tm.positions_m is None and jm.positions_m is None
    for name in ('ray_ids', 'valid', 'num_valid', 'ray_complete',
                 'num_blocks'):
        np.testing.assert_array_equal(
            getattr(tm, name).numpy(), np.asarray(getattr(jm, name)),
            err_msg=name)
    for name in ('positions', 'directions', 'ts', 'deltas'):
        np.testing.assert_allclose(
            getattr(tm, name).numpy(), np.asarray(getattr(jm, name)),
            rtol=1e-6, atol=1e-6, err_msg=name)


@pytest.mark.parametrize('case', MARCH_CASES[:3])
def test_composite_packed_matches(case):
    jm, tm = _march_both(*case)
    num_rays = case[1]
    rng = np.random.default_rng(5)
    b = jm.valid.shape[0]
    sigma = rng.uniform(0, 4, b).astype(np.float32)
    rgb = rng.uniform(0, 1, (3, b)).astype(np.float32)
    bg = np.array([1.0, 0.5, 0.0], np.float32)
    want = jocc.composite_packed(jnp.asarray(sigma), jnp.asarray(rgb), jm,
                                 num_rays, background=jnp.asarray(bg),
                                 block=8)
    got = tocc.composite_packed(torch.from_numpy(sigma),
                                torch.from_numpy(rgb), tm, num_rays,
                                background=torch.from_numpy(bg), block=8)
    assert float(np.asarray(want['alpha']).mean()) > 0.05
    for key in ('rgb', 'alpha', 'depth', 'weights'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=ATOL_COMPOSITE, err_msg=key)


def test_composite_packed_sample_granularity_matches():
    """block=1 (arbitrary sample streams) takes the per-sample prefix path."""
    jm, tm = _march_both(*MARCH_CASES[0])
    rng = np.random.default_rng(6)
    b = jm.valid.shape[0]
    sigma = rng.uniform(0, 4, b).astype(np.float32)
    rgb = rng.uniform(0, 1, (b, 3)).astype(np.float32)
    want = jocc.composite_packed(jnp.asarray(sigma), jnp.asarray(rgb), jm,
                                 256, block=1)
    got = tocc.composite_packed(torch.from_numpy(sigma),
                                torch.from_numpy(rgb), tm, 256, block=1)
    for key in ('rgb', 'alpha', 'depth'):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   rtol=0, atol=ATOL_COMPOSITE, err_msg=key)


def test_cascade_cell_positions_match():
    rng = np.random.default_rng(7)
    cells = rng.integers(0, 2 * 16 ** 3, 1000).astype(np.int32)
    offs = rng.uniform(size=(1000, 3)).astype(np.float32)
    center = np.array([0.1, -0.2, 0.0], np.float32)
    want = jocc.cascade_cell_positions(jnp.asarray(cells), jnp.asarray(offs),
                                       jnp.asarray(center), 1.0, 16, 2)
    got = tocc.cascade_cell_positions(torch.from_numpy(cells).long(),
                                      torch.from_numpy(offs),
                                      torch.from_numpy(center), 1.0, 16, 2)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def test_hash_jitter_matches():
    ids = np.arange(0, 1 << 20, 37, dtype=np.uint32)
    want = np.asarray(jocc._hash_jitter(jnp.asarray(ids),
                                        jnp.uint32(0xC0FFEE11)))
    got = tocc._hash_jitter(torch.from_numpy(ids.astype(np.int64)),
                            0xC0FFEE11)
    np.testing.assert_array_equal(got.numpy(), want)


def test_composite_packed_grads_match():
    """Gradients of the composite (through the segment gather and
    scatter-add Functions) against jax.grad, on jittered samples."""
    case = MARCH_CASES[1]
    jm, tm = _march_both(*case, key=5)
    num_rays = case[1]
    rng = np.random.default_rng(8)
    b = jm.valid.shape[0]
    sigma = rng.uniform(0, 4, b).astype(np.float32)
    rgb = rng.uniform(0, 1, (3, b)).astype(np.float32)
    bg = np.array([1.0, 0.5, 0.0], np.float32)
    cot = rng.normal(size=(num_rays, 3)).astype(np.float32)

    def loss(s, c):
        out = jocc.composite_packed(s, c, jm, num_rays,
                                    background=jnp.asarray(bg), block=8)
        return jnp.sum(out['rgb'] * cot) + jnp.sum(out['depth'])
    want = jax.grad(loss, argnums=(0, 1))(jnp.asarray(sigma),
                                          jnp.asarray(rgb))
    s_t = torch.from_numpy(sigma).requires_grad_()
    c_t = torch.from_numpy(rgb).requires_grad_()
    out = tocc.composite_packed(s_t, c_t, tm, num_rays,
                                background=torch.from_numpy(bg), block=8)
    ((out['rgb'] * torch.from_numpy(cot)).sum() + out['depth'].sum()
     ).backward()
    for got, ref in zip((s_t.grad, c_t.grad), want):
        ref = np.asarray(ref)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4,
                                   atol=1e-5 * float(np.abs(ref).max()))


def _jax_grid_draws(key, total, num, warmup, bias, grid, threshold):
    """The draws nerficg_tpu's update_density_grid makes from ``key``
    (occupancy.py:516-550), as the port's GridDraws. The categorical's bin
    becomes the uniform at the middle of that bin's probability interval."""
    k_cells, k_jitter, k_stream, k_bin = jax.random.split(key, 4)
    num = total if warmup else min(num, total)
    start = int(jax.random.randint(k_cells, (), 0, total, jnp.int32))
    offsets = np.array(jax.random.uniform(k_jitter, (num, 3)))
    biased, bin_u, shift = False, 0.0, 0
    if bias > 0.0 and not warmup:
        bins = 256
        bin_size = -(-total // bins)
        occ = (np.pad(grid, (0, bins * bin_size - total)) > threshold
               ).reshape(bins, bin_size).sum(1)
        logits = jnp.log(jnp.asarray(occ, jnp.float32) + 1e-3)
        chosen = int(jax.random.categorical(k_bin, logits))
        shift = int(jax.random.randint(k_bin, (), -(num // 2),
                                       num // 2 + 1, jnp.int32))
        biased = bool(jax.random.uniform(k_stream) < bias)
        cdf = np.cumsum(occ.astype(np.float64) + 1e-3)
        lo = cdf[chosen - 1] if chosen else 0.0
        bin_u = 0.5 * (lo + cdf[chosen]) / cdf[-1]
    return tocc.GridDraws(start, biased, bin_u, shift,
                          torch.from_numpy(offsets))


@pytest.mark.parametrize('warmup,key', [(True, 0), (False, 1), (False, 3)])
@pytest.mark.parametrize('cascades', [1, 2])
def test_update_density_grid_matches(warmup, key, cascades):
    """Warm-up (every cell) and later updates (key 1 takes the uniform
    start, key 3 the occupancy-biased one) with a carve mask, given the JAX
    draws: grids agree to 1e-6."""
    res, scale = 16, 1.0
    total = cascades * res ** 3
    rng = np.random.default_rng(10 + key)
    grid = np.where(rng.uniform(size=total) < 0.3,
                    rng.uniform(0, 2, total), 0.0).astype(np.float32)
    carve = (rng.uniform(size=total) < 0.9).astype(np.float32)
    center = np.zeros(3, np.float32)
    amin, amax = np.full(3, -scale, np.float32), np.full(3, scale, np.float32)

    def density(p, mod):
        return 3.0 * mod.exp(-4.0 * ((p - 0.2) ** 2).sum(-1))

    def position_fn(mod, tensor):
        if cascades == 1:
            return None
        return lambda cells, offs: mod.cascade_cell_positions(
            cells, offs, tensor(center), scale, res, cascades)

    jkey = jax.random.PRNGKey(key)
    want = jocc.update_density_grid(
        jnp.asarray(grid), lambda p: density(p, jnp), jnp.asarray(amin),
        jnp.asarray(amax), res, jkey, num_samples=1000, decay=0.95,
        warmup=warmup, position_fn=position_fn(jocc, jnp.asarray),
        carve_mask=jnp.asarray(carve), occupied_bias=0.5,
        occupied_threshold=0.5)
    draws = _jax_grid_draws(jkey, total, 1000, warmup, 0.5, grid, 0.5)
    assert draws.biased == (key == 3)
    got = tocc.update_density_grid(
        torch.from_numpy(grid), lambda p: density(p, torch),
        torch.from_numpy(amin), torch.from_numpy(amax), res, draws,
        decay=0.95, position_fn=position_fn(tocc, torch.from_numpy),
        carve_mask=torch.from_numpy(carve), occupied_threshold=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    assert not np.array_equal(np.asarray(want), grid * 0.95)


@pytest.mark.parametrize('scale', [0.5, 1.0])
def test_march_rays_through_the_probe_op_matches_its_composition(scale):
    """``march_rays`` with the renderer's probe op (one
    ``block_probe_xyz`` per probe on a card) against the same march with
    the composition the renderer called before it (cells computed by
    PyTorch operations, then ``block_probe_cells``): every field of the
    ``MarchResults`` equal. One grid at scale 0.5, two cascades at 1.0."""
    cascades = tocc.num_cascades(scale)
    res, cap = 32, 128
    flags = torch.from_numpy(_grid(res, cascades, scale))
    if cascades > 1:
        table = tocc.downsample_occupancy_cascaded_block(
            flags.float() * 100.0, res, res, 1.0, cascades, cap)
    else:
        table = tocc.downsample_occupancy_block(flags.float() * 100.0, res,
                                                res, 1.0, cap)
    origins, dirs = map(torch.from_numpy, _rays(256))
    amin = torch.full((3,), -scale)
    amax = torch.full((3,), scale)
    center = torch.zeros(3)

    def composition(px, py, pz):
        if cascades > 1:
            c, cx, cy, cz = tocc._cascade_cell_coords(px, py, pz, center,
                                                      scale, res, cascades)
            return tocc.block_probe_cells(table, cx, cy, cz, c, res, cap,
                                          num_grids=cascades)
        return tocc.occupancy_probe_block_xyz(
            table, (px - amin[0]) / (amax[0] - amin[0]),
            (py - amin[1]) / (amax[1] - amin[1]),
            (pz - amin[2]) / (amax[2] - amin[2]), res, cap)

    def op(px, py, pz):
        if cascades > 1:
            return tocc.occupancy_probe_block_cascaded_xyz(
                table, px, py, pz, center, scale, res, cascades, cap)
        return tocc.occupancy_probe_block_aabb_xyz(table, px, py, pz, amin,
                                                   amax, res, cap)

    kw = dict(max_steps=64, sample_budget=256 * 16, block=8,
              exponential=cascades > 1, morton=True, probes_per_block=7,
              seed=11)
    want = tocc.march_rays(origins, dirs, amin, amax, composition, **kw)
    got = tocc.march_rays(origins, dirs, amin, amax, op, **kw)
    assert int(got.num_blocks) > 0
    for name, a, b in zip(got._fields, got, want):
        assert torch.equal(a, b), name
