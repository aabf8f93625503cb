"""The segment scatter-add's launch plan and function (nerficg_torch/ops/
hash_mxu.py ``seg_scatter_plan``, ``seg_scatter_add_plain``) on the CPU.

The plan picks #7's path from the shapes alone: fused (one launch, a
cluster of blocks per level zeroes the output and adds) or atomic (a
memset, then one atomic per element). The plain version is held to the JAX
package's oracle ``_mxu_scatter_jnp`` (nerficg_tpu/ops/hash_mxu.py:205) for
ids in any order, repeated and out of range (atol 1e-5: sums in another
order), and the fused kernel's order of summation, emulated here, to the
same oracle: within rtol 1e-5 for values of one sign, and within 1e-5 of
the sum of |g| per entry for signed ones, whose sums cancel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.ops import hash_mxu as tmx
from nerficg_tpu.ops import hash_mxu as jmx
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL_SCATTER = 1e-5


def _rows(rays):
    """The composite's segment rows for ``rays`` rays (occupancy.py)."""
    return (rays + 1 + 127) // 128


# (F, M, rays, path) of the port's calls: a serving chunk's 24,576 blocks
# of 8 over 1,536 rays, its offsets (F = 1) and sums (F = 5), fused; a
# training step's 8,192 blocks over 256-8,192 rays, atomic; larger calls.
@pytest.mark.parametrize('feats, m, rays, path', [
    (5, 24576, 1536, 'fused'), (1, 24576, 1536, 'fused'),
    (5, 8192, 256, 'atomic'), (1, 8192, 8192, 'atomic'),
    (5, 65536, 4096, 'fused'), (5, 65536, 8192, 'fused'),
    (1, 65536, 8192, 'fused')])
def test_plan_on_the_ports_calls(feats, m, rays, path):
    assert tmx.seg_scatter_plan(feats, m, _rows(rays)) == path
    assert feats * _rows(rays) * 128 * 4 <= tmx.SCATTER_FUSED_MAX_BYTES


LIMIT = tmx.SCATTER_FUSED_MAX_BYTES


@pytest.mark.parametrize('feats, rows, path', [
    (5, LIMIT // 2560, 'fused'),                # exactly at the limit
    (5, LIMIT // 2560 + 1, 'atomic'),           # one row past it
    (1, LIMIT // 512, 'fused'),
    (1, LIMIT // 512 + 1, 'atomic'),
    (8, LIMIT // 4096, 'fused'),
    (8, LIMIT // 4096 + 1, 'atomic'),
    (8, 1, 'fused'),                            # SCATTER_MAX_FEATS
    (9, 1, 'atomic')])
def test_plan_size_edges(feats, rows, path):
    assert tmx.seg_scatter_plan(feats, 1 << 15, rows) == path


@pytest.mark.parametrize('m, path', [
    (0, 'atomic'), (tmx.SCATTER_FUSED_MIN_M - 1, 'atomic'),
    (tmx.SCATTER_FUSED_MIN_M, 'fused'), (24576, 'fused'), (1 << 22, 'fused')])
def test_plan_element_edges(m, path):
    assert tmx.seg_scatter_plan(5, m, 13) == path


@pytest.mark.parametrize('m', [0, 1, 4096])
def test_cpu_wrapper_is_the_plain_version(m):
    """On CPU tensors the wrapper returns the plain version's result,
    whatever path the plan would take on the card."""
    rng = np.random.default_rng(m)
    idx = torch.from_numpy(rng.integers(-10, 13 * 128 + 10, (2, m)).astype(
        np.int32))
    g = torch.from_numpy(rng.uniform(-1, 1, (2, 3, m)).astype(np.float32))
    assert torch.equal(tmx.seg_scatter_add(idx, g, 13),
                       tmx.seg_scatter_add_plain(idx, g, 13))


def test_plan_lookup_is_the_plan():
    assert tmx._scatter_plan(5, 24576, 13) == tmx.seg_scatter_plan(
        5, 24576, 13) == 'fused'


def _ids(kind, levels, m, size, rng):
    if kind == 'sorted':
        return np.sort(rng.integers(0, size, (levels, m)), axis=1)
    if kind == 'unsorted':
        return rng.integers(0, size, (levels, m))
    if kind == 'repeated':       # a few ids, each many times, in any order
        return rng.choice(rng.integers(0, size, 5), (levels, m))
    # out of range: negatives that count from the end ([-size, -1]) and
    # ids past either end (dropped), mixed with valid ones
    ids = rng.integers(0, size, (levels, m))
    bad = rng.uniform(size=ids.shape) < 0.3
    ids[bad] = rng.choice([-1, -7, -size, -size - 1, -100000, size,
                           size + 3, 1 << 30], int(bad.sum()))
    return ids


@pytest.mark.parametrize('kind', ['sorted', 'unsorted', 'repeated',
                                  'out_of_range'])
@pytest.mark.parametrize('levels, feats, rows, m', [(1, 5, 13, 24576),
                                                    (1, 1, 13, 3000),
                                                    (3, 2, 2, 777)])
def test_plain_matches_jax_oracle(kind, levels, feats, rows, m):
    rng = np.random.default_rng(11)
    idx = _ids(kind, levels, m, rows * 128, rng).astype(np.int32)
    g = rng.uniform(-1, 1, (levels, feats, m)).astype(np.float32)
    want = np.asarray(jmx._mxu_scatter_jnp(jnp.asarray(idx), jnp.asarray(g),
                                           rows))
    got = tmx.seg_scatter_add_plain(torch.from_numpy(idx),
                                    torch.from_numpy(g), rows)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL_SCATTER)


def _fused_emulation(idx, g, rows, per_thread=4, max_runs=24):
    """The fused kernel's order on the CPU: each thread sums the runs of
    equal ids among its ``per_thread`` neighbouring elements and adds every
    run but its last; in each warp of 32 threads, runs of equal adjacent
    last runs sum first (when the warp has at most ``max_runs`` of them)
    and add once. (Which block of the cluster adds a chunk does not change
    the sums.)"""
    levels, feats, m = g.shape
    size = rows * 128
    out = np.zeros((levels, feats, size), np.float32)
    lane_n = 32 * per_thread
    for lv in range(levels):
        ind = idx[lv].astype(np.int64)
        ind = np.where(ind < 0, ind + size, ind)
        ind = np.where((ind >= 0) & (ind < size), ind, -1)

        def add(key, total):
            if key >= 0:
                out[lv, :, key] += total
        for w in range(0, m, lane_n):
            tails = []
            for t in range(w, w + lane_n, per_thread):
                keys = [ind[i] if i < m else -1
                        for i in range(t, t + per_thread)]
                vals = [g[lv, :, i] if i < m else np.zeros(feats, np.float32)
                        for i in range(t, t + per_thread)]
                key, total = keys[0], vals[0].copy()
                for k, v in zip(keys[1:], vals[1:]):
                    if k == key:
                        total += v
                    else:
                        add(key, total)
                        key, total = k, v.copy()
                tails.append((key, total))
            keys = np.array([k for k, _ in tails])
            heads = np.flatnonzero(np.r_[True, keys[1:] != keys[:-1]])
            if len(heads) > max_runs:
                heads = np.arange(len(keys))
            for h, e in zip(heads, np.r_[heads[1:], len(keys)]):
                add(keys[h], sum(t for _, t in tails[h:e]))
    return out.reshape(levels, feats, rows, 128)


@pytest.mark.parametrize('kind', ['sorted', 'unsorted', 'repeated',
                                  'out_of_range'])
@pytest.mark.parametrize('m', [30000, 30002])
def test_fused_order_matches_jax_oracle(kind, m):
    rng = np.random.default_rng(12)
    rows = 13
    idx = _ids(kind, 1, m, 1537, rng).astype(np.int32)
    g = rng.uniform(0, 1, (1, 5, m)).astype(np.float32)
    want = np.asarray(jmx._mxu_scatter_jnp(jnp.asarray(idx), jnp.asarray(g),
                                           rows))
    got = _fused_emulation(idx, g, rows)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=ATOL_SCATTER)


@pytest.mark.parametrize('kind', ['sorted', 'unsorted', 'repeated',
                                  'out_of_range'])
@pytest.mark.parametrize('m', [30000, 30002])
def test_fused_order_matches_jax_oracle_signed(kind, m):
    """Signed values (the gather's backward passes them): the emulated
    order within 1e-5 of the sum of |g| per entry, plus 1e-6."""
    rng = np.random.default_rng(13)
    rows = 13
    idx = _ids(kind, 1, m, 1537, rng).astype(np.int32)
    g = rng.uniform(-1, 1, (1, 5, m)).astype(np.float32)
    want = np.asarray(jmx._mxu_scatter_jnp(jnp.asarray(idx), jnp.asarray(g),
                                           rows))
    scale = np.asarray(jmx._mxu_scatter_jnp(jnp.asarray(idx),
                                            jnp.asarray(np.abs(g)), rows))
    got = _fused_emulation(idx, g, rows)
    assert (np.abs(got - want) <= 1e-5 * scale + 1e-6).all()
