"""The port's 3DGS tile rasterizer against the JAX package on the CPU.

The stream both packages hand their compositor is captured (the JAX one by
patching ``composite_sorted`` where ``rasterize_gaussians`` imports it):
sorted entries, segment starts and counts and the overflow counters must be
EQUAL, in both layouts, with depth ties (which the packed key's 19-32 depth
bits make common). Images within atol 1e-5; gradients to means2d, conics,
colors, opacities and depths within JAX's 2e-3 / 1e-3.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerficg_tpu.ops.gs_tiles_kernel as jtk
from nerficg_torch.ops import gs_rasterize as tr
from nerficg_tpu.ops import gs_rasterize as jr
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

W, H, D, K = 70, 50, 6, 64


@pytest.fixture(scope='module')
def gaussians():
    """600 projected Gaussians over a 70x50 frame and around it; a fifth
    share another's depth, some rects exceed D tiles, some tiles exceed k."""
    rng = np.random.default_rng(0)
    n = 600
    depths = rng.uniform(0.5, 5.0, n).astype(np.float32)
    depths[:120] = depths[120:240]
    return {
        'means2d': np.stack([rng.uniform(-10, 80, n), rng.uniform(-10, 60, n)],
                            -1).astype(np.float32),
        'depths': depths,
        'conics': np.stack([rng.uniform(0.05, 0.3, n),
                            rng.uniform(-0.02, 0.02, n),
                            rng.uniform(0.05, 0.3, n)], -1).astype(np.float32),
        'radii': np.ceil(rng.uniform(1, 20, n)).astype(np.float32),
        'colors': rng.uniform(0, 1, (n, 3)).astype(np.float32),
        'opacities': rng.uniform(0.05, 0.9, n).astype(np.float32),
        'visible': rng.random(n) > 0.1,
    }


KEYS = ('means2d', 'depths', 'conics', 'radii', 'colors', 'opacities',
        'visible')
BG = np.array([0.2, 0.3, 0.4], np.float32)


def _jax(g, packed):
    """JAX's image dict and the (sorted_mat, starts, counts) it composited."""
    seen = {}
    orig = jtk.composite_sorted

    def capture(sorted_mat, starts, counts, *rest):
        seen.update(mat=np.asarray(sorted_mat), starts=np.asarray(starts),
                    counts=np.asarray(counts))
        return orig(sorted_mat, starts, counts, *rest)

    with mock.patch.object(jtk, 'composite_sorted', capture):
        out = jr.rasterize_gaussians(
            *(jnp.asarray(g[k]) for k in KEYS), W, H, jnp.asarray(BG),
            max_tiles_per_gaussian=D, max_per_tile=K,
            packed_inference=packed)
    return out, seen


def _port(g, packed):
    seen = {}
    orig = tr.composite_sorted

    def capture(sorted_mat, starts, counts, *rest):
        seen.update(mat=sorted_mat.detach().numpy(), starts=starts.numpy(),
                    counts=counts.numpy())
        return orig(sorted_mat, starts, counts, *rest)

    with mock.patch.object(tr, 'composite_sorted', capture):
        out = tr.rasterize_gaussians(
            *(torch.tensor(g[k]) for k in KEYS), W, H, torch.tensor(BG),
            max_tiles_per_gaussian=D, max_per_tile=K,
            packed_inference=packed)
    return out, seen


@pytest.mark.parametrize('packed', [False, True])
def test_stream_equals_jax(gaussians, packed):
    """The same entries in the same order: equal bit patterns (packed
    words) or values (16-wide), equal starts, counts and counters."""
    j_out, j_seen = _jax(gaussians, packed)
    t_out, t_seen = _port(gaussians, packed)
    assert t_seen['mat'].shape == j_seen['mat'].shape
    np.testing.assert_array_equal(t_seen['mat'].view(np.uint32),
                                  j_seen['mat'].view(np.uint32))
    np.testing.assert_array_equal(t_seen['starts'], j_seen['starts'])
    np.testing.assert_array_equal(t_seen['counts'], j_seen['counts'])
    assert int(t_out['overflow_gaussians']) == \
        int(j_out['overflow_gaussians']) > 0
    assert int(t_out['overflow_entries']) == \
        int(j_out['overflow_entries']) > 0


@pytest.mark.parametrize('packed', [False, True])
def test_images_match_jax(gaussians, packed):
    """rgb, alpha and depth within atol 1e-5 (depth relative 1e-5)."""
    j_out, _ = _jax(gaussians, packed)
    t_out, _ = _port(gaussians, packed)
    for key in ('rgb', 'alpha'):
        np.testing.assert_allclose(t_out[key].numpy(),
                                   np.asarray(j_out[key]), rtol=0,
                                   atol=1e-5, err_msg=key)
    np.testing.assert_allclose(t_out['depth'].numpy(),
                               np.asarray(j_out['depth']), rtol=1e-5,
                               atol=1e-5)


def test_gradients_match_jax(gaussians):
    """d(sum(rgb * w) + sum(depth-weighted alpha)) / d inputs within 2e-3 /
    1e-3, for means2d, conics, colors, opacities and depths."""
    g = gaussians
    diff = ('means2d', 'depths', 'conics', 'colors', 'opacities')
    w_rgb = np.random.default_rng(5).normal(size=(H, W, 3)).astype(
        np.float32)

    def j_loss(means2d, depths, conics, colors, opacities):
        out = jr.rasterize_gaussians(
            means2d, depths, conics, jnp.asarray(g['radii']), colors,
            opacities, jnp.asarray(g['visible']), W, H, jnp.asarray(BG),
            max_tiles_per_gaussian=D, max_per_tile=K)
        return jnp.sum(out['rgb'] * w_rgb) + jnp.sum(out['depth'] *
                                                     out['alpha'])

    want = jax.grad(j_loss, argnums=tuple(range(5)))(
        *(jnp.asarray(g[k]) for k in diff))
    inputs = {k: torch.tensor(g[k], requires_grad=True) for k in diff}
    out = tr.rasterize_gaussians(
        inputs['means2d'], inputs['depths'], inputs['conics'],
        torch.tensor(g['radii']), inputs['colors'], inputs['opacities'],
        torch.tensor(g['visible']), W, H, torch.tensor(BG),
        max_tiles_per_gaussian=D, max_per_tile=K)
    loss = (out['rgb'] * torch.tensor(w_rgb)).sum() + \
        (out['depth'] * out['alpha']).sum()
    loss.backward()
    for key, grad in zip(diff, want):
        assert np.abs(np.asarray(grad)).max() > 0, key
        np.testing.assert_allclose(inputs[key].grad.numpy(),
                                   np.asarray(grad), atol=2e-3, rtol=1e-3,
                                   err_msg=key)
