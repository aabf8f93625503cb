"""The port's 3DGS tile rasterizer against the JAX package on the CPU.

The stream both packages hand their compositor is captured (the JAX one by
patching ``composite_sorted`` where ``rasterize_gaussians`` imports it):
sorted entries, segment starts and counts and the overflow counters must be
EQUAL, in both layouts, with depth ties (which the packed key's 19-32 depth
bits make common). Images within atol 1e-5; gradients to means2d, conics,
colors, opacities and depths within JAX's 2e-3 / 1e-3. The entry gather
(``ops/gs_gather.py``) against the stack, expand, gather and pad it
replaced, and its backward against autograd through that composition.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import nerficg_tpu.ops.gs_tiles_kernel as jtk
from nerficg_torch.core.errors import KernelError
from nerficg_torch.ops import gs_gather
from nerficg_torch.ops import gs_rasterize as tr
from nerficg_torch.ops import gs_tiles_kernel as gtk
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


# -- the entry gather (ops/gs_gather.py) ---------------------------------------

ATTRS = ('means2d', 'conics', 'opacities', 'colors', 'depths')


def _gather_args(g, requires_grad=False):
    """The port's 16-wide stream of the fixture and the arguments
    ``entry_stream`` handed ``stream_gather``."""
    seen = {}
    orig = tr.stream_gather

    def capture(*args):
        seen['args'] = args
        return orig(*args)

    inputs = {k: torch.tensor(g[k], requires_grad=requires_grad
                              and k in ATTRS) for k in KEYS}
    with mock.patch.object(tr, 'stream_gather', capture):
        stream = tr.entry_stream(*(inputs[k] for k in KEYS), W, H,
                                 max_tiles_per_gaussian=D, max_per_tile=K)
    return stream, dict(zip(ATTRS + ('perm', 'sorted_tile', 'starts', 'k',
                                     'e_pad'), seen['args']))


def _composition(a):
    """The stream as stack, expand, gather by perm and pad composed it."""
    attrs = torch.stack([
        a['means2d'][:, 0], a['means2d'][:, 1], a['conics'][:, 0],
        a['conics'][:, 1], a['conics'][:, 2], a['opacities'],
        a['colors'][:, 0], a['colors'][:, 1], a['colors'][:, 2],
        a['depths']], dim=0)
    dup = a['perm'].shape[0] // attrs.shape[1]
    channels = attrs[:, None, :].expand(-1, dup, -1).reshape(10, -1)
    e = a['perm'].shape[0]
    return torch.nn.functional.pad(channels[:, a['perm']],
                                   (0, a['e_pad'] - e, 0, 6))


def _live(args, num_tiles):
    """(E,) bool: the sorted columns in a tile and within its first k."""
    tile = args['sorted_tile'].long()
    first = torch.cat([args['starts'].long(),
                       torch.zeros(1, dtype=torch.long)])
    return (tile < num_tiles) & (torch.arange(tile.shape[0]) - first[tile]
                                 < K)


@pytest.mark.parametrize('requires_grad,grad_mode,inv_built', [
    (True, True, True), (True, False, False), (False, True, False)])
def test_gather_equals_composition(gaussians, requires_grad, grad_mode,
                                   inv_built):
    """The gathered stream has the composition's bits, with gradients
    enabled or not; inv is built only when autograd will need it."""
    built = []
    orig = gs_gather.gs_stream_gather

    def spy(*args):
        out = orig(*args)
        built.append(out[1] is not None)
        return out

    with mock.patch.object(gs_gather, 'gs_stream_gather', spy), \
            torch.set_grad_enabled(grad_mode):
        stream, args = _gather_args(gaussians, requires_grad)
    want = _composition(args).detach()
    assert stream['sorted_mat'].shape == want.shape == (16, args['e_pad'])
    assert torch.equal(stream['sorted_mat'].detach().view(torch.int32),
                       want.view(torch.int32))
    assert built == [inv_built]
    assert stream['sorted_mat'].requires_grad == inv_built


def test_gather_inv_is_the_inverse_over_live_entries(gaussians):
    """inv[perm[e]] = e at the live columns, -1 at every other entry; the
    live columns number the tiles' counts clamped to k."""
    stream, args = _gather_args(gaussians)
    _, inv = gs_gather.gs_stream_gather_plain(
        *(args[k] for k in ATTRS), args['perm'], args['e_pad'],
        args['sorted_tile'], args['starts'], K)
    live = _live(args, stream['num_tiles'])
    assert int(live.sum()) == int(torch.clamp(stream['counts'], max=K).sum())
    assert 0 < int(live.sum()) < live.shape[0]
    cols = torch.arange(live.shape[0], dtype=torch.int32)
    assert torch.equal(inv[args['perm'][live]], cols[live])
    assert bool((inv[args['perm'][~live]] == -1).all())


def _stream_grad(stream, seed=3):
    """The compositor's plain backward of the stream for a random d out."""
    num_tiles = stream['num_tiles']
    dout = torch.tensor(np.random.default_rng(seed).normal(
        size=(num_tiles, 5, 256)), dtype=torch.float32)
    return gtk.gs_composite_bwd_plain(
        stream['sorted_mat'].detach(), stream['starts'], stream['counts'],
        dout, stream['tiles_x'], num_tiles, K)


def test_gather_backward_matches_autograd(gaussians):
    """Given the compositor's stream gradient, the plain backward (and the
    Function through it) is within 1e-6 relative Frobenius of autograd
    through the composition, for each of the five attributes."""
    stream, args = _gather_args(gaussians, requires_grad=True)
    d_sorted = _stream_grad(stream)
    leaves = [args[k] for k in ATTRS]
    want = torch.autograd.grad(_composition(args), leaves, d_sorted)
    _, inv = gs_gather.gs_stream_gather_plain(
        *(t.detach() for t in leaves), args['perm'], args['e_pad'],
        args['sorted_tile'], args['starts'], K)
    got = gs_gather.gs_stream_gather_bwd_plain(d_sorted, inv,
                                               leaves[0].shape[0])
    through = torch.autograd.grad(stream['sorted_mat'], leaves, d_sorted)
    for key, g, w, f in zip(ATTRS, got, want, through):
        assert g.shape == w.shape, key
        assert float(w.norm()) > 0, key
        assert float((g - w).norm()) <= 1e-6 * float(w.norm()), key
        assert torch.equal(f, g), key


def test_composite_bwd_zero_where_the_gather_skips(gaussians):
    """The skip's contract: the compositor's plain backward is zero at
    entries of no tile, at entries past k of their tile's segment, in the
    guard columns and in rows 10-15, and not zero everywhere else."""
    stream, args = _gather_args(gaussians)
    d_sorted = _stream_grad(stream)
    e = args['perm'].shape[0]
    invalid = args['sorted_tile'] == stream['num_tiles']
    live = _live(args, stream['num_tiles'])
    assert int(invalid.sum()) > 0 and int((~invalid & ~live).sum()) > 0
    assert not bool(d_sorted[:10, :e][:, ~live].any())
    assert not bool(d_sorted[:, e:].any()) and not bool(d_sorted[10:].any())
    assert bool(d_sorted[:10, :e][:, live].any())


def test_gather_refuses_2_31_entries():
    """D x N >= 2^31 raises before anything is read or allocated."""
    n = 2 ** 28
    attrs = [torch.zeros(1, c).expand(n, c) for c in (2, 3)] + \
        [torch.zeros(1).expand(n)]
    perm = torch.zeros(1, dtype=torch.long).expand(8 * n)
    with pytest.raises(KernelError, match='int32'):
        gs_gather.gs_stream_gather(attrs[0], attrs[1], attrs[2], attrs[1],
                                   attrs[2], perm, 8 * n + 768)
    inv = torch.zeros(1, dtype=torch.int32).expand(8 * n)
    with pytest.raises(KernelError, match='int32'):
        gs_gather.gs_stream_gather_bwd(torch.zeros(16, 1), inv, n)


def test_gather_without_gaussians():
    """No Gaussians: a background frame, and empty gradients in the
    attributes' shapes through the gather's backward."""
    shapes = {'means2d': (0, 2), 'depths': (0,), 'conics': (0, 3),
              'radii': (0,), 'colors': (0, 3), 'opacities': (0,)}
    inputs = {k: torch.zeros(s, requires_grad=k != 'radii')
              for k, s in shapes.items()}
    inputs['visible'] = torch.zeros(0, dtype=torch.bool)
    out = tr.rasterize_gaussians(**inputs, width=W, height=H,
                                 background=torch.tensor(BG),
                                 max_tiles_per_gaussian=D, max_per_tile=K)
    assert torch.equal(out['rgb'], torch.tensor(BG).expand(H, W, 3))
    out['rgb'].sum().backward()
    for key in ATTRS:
        assert inputs[key].grad.shape == shapes[key], key
