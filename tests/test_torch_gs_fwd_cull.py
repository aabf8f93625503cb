"""The per-strip cull of the 3DGS forwards (#15 ``gs_composite_fwd`` and
``gs_composite_fwd_packed``, #13 ``gs_tiles_fwd``), on the CPU.

The CUDA forward walks, per warp, only the entries whose bound
(``strip_reach`` in nerficg_torch/csrc/gs_tiles.cu, mirrored op for op by
``_strip_reach_plain``) reaches the warp's two pixel rows. That keeps the
parent kernel's bits only if the bound is conservative:

* (b) over random and degenerate conics (det <= 0, op <= 1/255, extents
  past any tile, means far off the tile, fractional origins) the bound
  never excludes a strip where the plain alpha passes 1/255;
* (c) the plain forward with the cull applied (alpha zeroed wherever the
  bound excludes the pixel's strip) equals the plain forward bit for bit,
  composite and transmittance, on both stream layouts, and agrees with the
  JAX package's oracle ``_cs_jnp`` within the forward's atol 1e-5.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.ops import gs_tiles_kernel as tk
from nerficg_tpu.ops import gs_tiles_kernel as gtk
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TILES, K = 48, 128


def _origins(rng, fractional=False):
    xy = rng.integers(0, 40, (TILES, 2)).astype(np.float32) * tk.TILE
    if fractional:
        xy += rng.uniform(0, 1, (TILES, 2)).astype(np.float32)
    return xy


def _slots(case, seed):
    """(T, K, 10) slots and (T, 2) origins of one family of conics."""
    rng = np.random.default_rng(seed)
    origins = _origins(rng, fractional=case == 'fractional origins')
    size = (TILES, K)
    spread = {'far means': 400.0, 'huge extents': 200.0}.get(case, 24.0)
    mean = origins[:, None, :] + 8.0 + rng.uniform(-spread, spread,
                                                   size + (2,))
    ca = rng.uniform(0.01, 2.0, size)
    cc = rng.uniform(0.01, 2.0, size)
    cb = rng.uniform(-0.9, 0.9, size) * np.sqrt(ca * cc)
    op = rng.uniform(0.0, 1.0, size)
    if case == 'near threshold':
        op = rng.uniform(1.0 / 255.0, 3.0 / 255.0, size)
    elif case == 'op at most 1/255':
        op = rng.uniform(0.0, 1.0 / 255.0, size)
    elif case == 'huge extents':
        ca = 10.0 ** rng.uniform(-9, -3, size)
        cc = 10.0 ** rng.uniform(-9, -3, size)
        cb = rng.uniform(-0.9999, 0.9999, size) * np.sqrt(ca * cc)
    elif case == 'degenerate':
        pick = rng.integers(0, 4, size)
        cb = np.where(pick == 0, np.sqrt(ca * cc), cb)              # det = 0
        cb = np.where(pick == 1, 1.5 * np.sqrt(ca * cc), cb)        # det < 0
        ca = np.where(pick == 2, -ca, ca)                           # ca < 0
        cc = np.where(pick == 3, 0.0, cc)                           # cc = 0
    elif case == 'ill-conditioned':
        cb = rng.uniform(0.999, 0.99999, size) * np.sqrt(ca * cc) * \
            rng.choice([-1.0, 1.0], size)
    rest = rng.uniform(0.0, 1.0, size + (4,))
    slots = np.concatenate([mean, np.stack([ca, cb, cc, op], -1), rest],
                           -1).astype(np.float32)
    return torch.from_numpy(slots), torch.from_numpy(origins)


CASES = ['random', 'near threshold', 'op at most 1/255', 'huge extents',
         'degenerate', 'ill-conditioned', 'far means', 'fractional origins']


@pytest.mark.parametrize('case', CASES)
def test_strip_reach_never_drops_a_passing_pixel(case):
    """(b): wherever _alpha_plain passes 1/255, the bound reaches the
    pixel's strip (pixel p lies in strip p // 32)."""
    slots, origins = _slots(case, seed=CASES.index(case))
    counts = torch.full((TILES,), K, dtype=torch.int32)
    alpha = tk._alpha_plain(slots, counts, origins)              # (T, K, P)
    reach = tk._strip_reach_plain(slots, origins)                # (T, K)
    strip = torch.arange(tk.P) // 32
    reached = ((reach[..., None] >> strip) & 1).bool()
    assert not bool(((alpha > 0) & ~reached).any())
    if case == 'op at most 1/255':
        assert not bool(alpha.any()) and not bool(reach.any())
    if case in ('random', 'near threshold', 'far means'):
        # The bound culls: most (entry, strip) pairs are excluded.
        assert float(reached.float().mean()) < 0.5
        assert bool((alpha > 0).any())


def _stream(seed, packed):
    """A 16-wide or packed stream over 4x3 tiles (one with count > k, one
    empty) with means over the frame and around it, and its arguments."""
    rng = np.random.default_rng(seed)
    tiles_x, k = 4, 64
    counts = np.array([90, 17, 0, 64, 5, 40, 64, 33, 1, 64, 12, 70], np.int32)
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    e = int(counts.sum())
    e_pad = e + 3 * k
    tile = np.searchsorted(np.cumsum(counts), np.arange(e_pad),
                           side='right').clip(0, len(counts) - 1)
    origin = np.stack([(tile % tiles_x) * 16.0, (tile // tiles_x) * 16.0],
                      -1)
    mean = origin + rng.uniform(-12.0, 28.0, (e_pad, 2))
    ca = rng.uniform(0.02, 0.6, e_pad)
    cc = rng.uniform(0.02, 0.6, e_pad)
    cb = rng.uniform(-0.5, 0.5, e_pad) * np.sqrt(ca * cc)
    attrs = np.concatenate([mean, np.stack([ca, cb, cc, rng.uniform(
        0.0, 0.99, e_pad)], -1), rng.uniform(0, 1, (e_pad, 3)),
        rng.uniform(1, 5, (e_pad, 1))], -1).astype(np.float32)
    if not packed:
        mat = np.zeros((16, e_pad), np.float32)
        mat[:10] = attrs.T
    else:
        q = np.clip(np.round((attrs[:, :2] - origin) * 32.0 + 1024.0 * 32.0),
                    0, 65535).astype(np.uint32)

        def bf16(a):
            return (a.astype(np.float32).view(np.uint32) + 0x8000) >> 16

        words = [(q[:, 0] << 16) | q[:, 1]] + [
            (bf16(attrs[:, 2 * i]) << 16) | bf16(attrs[:, 2 * i + 1])
            for i in range(1, 5)]
        mat = np.zeros((8, e_pad), np.uint32)
        mat[:5] = np.stack(words)
        mat = mat.view(np.float32)
    return mat, starts, counts, tiles_x, len(counts), k


@pytest.mark.parametrize('packed', [False, True])
def test_culled_plain_forward_equals_the_plain_forward(packed):
    """(c): alpha zeroed where the bound excludes the strip changes no bit
    of the composite or the transmittance; both agree with _cs_jnp."""
    mat, starts, counts, tiles_x, num_tiles, k = _stream(3 + packed, packed)
    t_mat, t_starts = torch.from_numpy(mat), torch.from_numpy(starts)
    t_counts = torch.from_numpy(counts)
    slots, _ = tk._slots(t_mat, t_starts, tiles_x, k, 0, num_tiles)
    origins = tk._tile_origins(num_tiles, tiles_x, t_mat.device)
    clamped = torch.clamp(t_counts, max=k)
    alpha = tk._alpha_plain(slots, clamped, origins)
    reach = tk._strip_reach_plain(slots, origins)
    strip = torch.arange(tk.P) // 32
    culled = torch.where(((reach[..., None] >> strip) & 1).bool(), alpha,
                         torch.zeros_like(alpha))
    assert bool((alpha != culled).sum() == 0)
    assert float(((reach[..., None] >> strip) & 1).float().mean()) < 0.6
    out, trans = tk._composite_plain(slots, clamped, origins)
    out_c, trans_c = tk._composite_alpha(culled, slots)
    assert torch.equal(out.view(torch.int32), out_c.view(torch.int32))
    assert torch.equal(trans.view(torch.int32), trans_c.view(torch.int32))
    got = tk.gs_composite_fwd_plain(t_mat, t_starts, t_counts, tiles_x,
                                    num_tiles, k, save_tacc=False)
    assert torch.equal(got, out)
    want = np.asarray(gtk._cs_jnp(jnp.asarray(mat), jnp.asarray(starts),
                                  jnp.asarray(counts), tiles_x, num_tiles,
                                  k))
    np.testing.assert_allclose(out_c.numpy(), want[:, :tk.OUT_ROWS], rtol=0,
                               atol=1e-5)
