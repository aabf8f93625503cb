"""Parity of the port's dense occupancy probe (PROBE_MODE 'dense') with the
JAX package's on the CPU, where the JAX gather ``xbar_gather`` is
``table.reshape(-1)[idx]``.

Integer functions agree exactly: ``pack_bits`` at lengths that are not
whole 4096-bit rows, the downsampled grids (one and cascaded) and both
probes at a march resolution whose res^3 fills whole rows (16^3 = 4096)
and one whose res^3 does not (12^3 = 1728), where a cascade's word offset
(packed.shape[1] * 128) differs from (c * res^3) >> 5. Probe points lie
along rays and on every cascade and cell boundary +-1 ulp. The JAX probes
run eagerly, op by op, as the port does. Instant-NGP with PROBE_MODE
'dense' renders a test view within 45 dB of JAX's (one grid and two
cascades), and one training step agrees as the block probe's does
(tests/test_torch_training.py's tolerances).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.core.config import ConfigNode as TConfigNode
from nerficg_torch.core.registry import Datasets as TDatasets
from nerficg_torch.core.registry import Methods as TMethods
from nerficg_torch.data.synthetic import make_textured_scene
from nerficg_torch.ops import occupancy as tocc
from nerficg_torch.ops import xbar_gather as txg
from nerficg_torch.scripts.kernel_timing import boundary_values
from nerficg_tpu.core.config import ConfigNode as JConfigNode
from nerficg_tpu.core.registry import Datasets as JDatasets
from nerficg_tpu.core.registry import Methods as JMethods
from nerficg_tpu.ops import occupancy as jocc
from nerficg_tpu.ops import xbar_gather as jxg
from test_torch_instant_ngp import MIN_PSNR_DB, _jax_model
from test_torch_instant_ngp import _config as ingp_config
from test_torch_training import check_one_step
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


@pytest.mark.parametrize('m', [1, 31, 4095, 4097, 3 * 12 ** 3, 2 * 4096])
def test_pack_bits(m):
    flags = np.random.default_rng(m).uniform(size=m) < 0.3
    want = np.asarray(jxg.pack_bits(jnp.asarray(flags)))
    got = txg.pack_bits(torch.from_numpy(flags))
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('dtype', [np.int32, np.float32])
def test_xbar_gather_plain(dtype):
    rng = np.random.default_rng(0)
    rows = 5
    table = rng.integers(-2 ** 31, 2 ** 31, (rows, 128), np.int64).astype(
        np.int32)
    if dtype == np.float32:
        table = rng.normal(size=(rows, 128)).astype(np.float32)
    idx = np.concatenate([[0, rows * 128 - 1],
                          rng.integers(0, rows * 128, 5000)]).astype(np.int32)
    want = np.asarray(jxg.xbar_gather(jnp.asarray(table), jnp.asarray(idx)))
    got = txg.xbar_gather(torch.from_numpy(table), torch.from_numpy(idx))
    assert got.dtype == torch.from_numpy(table).dtype
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  want.view(np.int32))


def _density(res, cascades, seed=0):
    """Sparse densities in [0, 2): about 2% of the cells above 1."""
    rng = np.random.default_rng(seed)
    d = rng.uniform(0, 1, cascades * res ** 3)
    d[rng.uniform(size=d.shape) < 0.02] += 1.0
    return d.astype(np.float32)


# (grid res, march res): 32 -> 16 fills whole 4096-bit rows, 24 -> 12 not.
RESOLUTIONS = [(32, 16), (24, 12)]


@pytest.mark.parametrize('res,mres', RESOLUTIONS)
def test_downsample_occupancy(res, mres):
    d = _density(res, 1)
    want = np.asarray(jocc.downsample_occupancy(jnp.asarray(d), res, mres,
                                                1.0))
    got = tocc.downsample_occupancy(torch.from_numpy(d), res, mres, 1.0)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize('res,mres', RESOLUTIONS)
def test_downsample_occupancy_cascaded(res, mres):
    d = _density(res, 2)
    want = np.asarray(jocc.downsample_occupancy_cascaded(
        jnp.asarray(d), res, mres, 1.0, 2))
    got = tocc.downsample_occupancy_cascaded(torch.from_numpy(d), res, mres,
                                             1.0, 2)
    assert got.shape == want.shape and got.shape[0] == 2
    np.testing.assert_array_equal(got.numpy(), want)


def _points(n, scale, center, edges, seed=0):
    """(n // 8, 8) world planes along rays toward the box about ``center``;
    the last 3 * len(edges[0]) points each take one boundary value
    ``edges[axis]`` on one axis (cycling x, y, z)."""
    rng = np.random.default_rng(seed)
    rays = n // 8
    ang = rng.uniform(0, 2 * np.pi, rays)
    origins = np.stack([2.5 * scale * np.sin(ang),
                        rng.uniform(-0.5, 0.5, rays) * scale,
                        2.5 * scale * np.cos(ang)], -1)
    d = rng.uniform(-0.6, 0.6, (rays, 3)) * scale - origins
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = 1.5 * scale + np.sort(rng.uniform(0, 2.0 * scale, (rays, 8)), 1)
    p = (origins[:, None] + d[:, None] * t[..., None] + center).astype(
        np.float32).reshape(-1, 3)
    k = np.arange(3 * len(edges[0]))
    p[len(p) - len(k) + k, k % 3] = np.stack(edges, -1).reshape(-1)
    return [np.ascontiguousarray(p[:, i].reshape(rays, 8)) for i in range(3)]


@pytest.mark.parametrize('res,mres', RESOLUTIONS)
def test_occupancy_probe_xyz(res, mres):
    """One grid over [-0.5, 0.5]^3, probed at unit coordinates."""
    packed = jocc.downsample_occupancy(jnp.asarray(_density(res, 1)), res,
                                       mres, 1.0)
    planes = _points(16384, 0.5, np.zeros(3),
                     [boundary_values(0.5, 1, mres)] * 3)
    units = [p + np.float32(0.5) for p in planes]
    want = np.asarray(jxg.occupancy_probe_xyz(
        packed, *(jnp.asarray(u) for u in units), mres))
    got = txg.occupancy_probe_xyz(torch.from_numpy(np.array(packed)),
                                  *(torch.from_numpy(u) for u in units), mres)
    assert got.dtype == torch.bool and 0 < int(got.sum()) < got.numel()
    np.testing.assert_array_equal(got.numpy(), want)
    pos = np.stack(units, -1)
    np.testing.assert_array_equal(
        txg.occupancy_probe(torch.from_numpy(np.array(packed)),
                            torch.from_numpy(pos), mres).numpy(),
        np.asarray(jxg.occupancy_probe(packed, jnp.asarray(pos), mres)))


@pytest.mark.parametrize('res,mres', RESOLUTIONS)
def test_occupancy_probe_cascaded_xyz(res, mres):
    """Two cascades at SCALE 1.0 about a centre off the origin."""
    cascades, scale = 2, 1.0
    center = np.asarray([0.1, -0.2, 0.05], np.float32)
    packed = jocc.downsample_occupancy_cascaded(
        jnp.asarray(_density(res, cascades)), res, mres, 1.0, cascades)
    planes = _points(16384, scale, center,
                     [boundary_values(scale, cascades, mres, c)
                      for c in center], seed=1)
    want = np.asarray(jocc.occupancy_probe_cascaded_xyz(
        packed, *(jnp.asarray(p) for p in planes), jnp.asarray(center),
        scale, mres))
    got = tocc.occupancy_probe_cascaded_xyz(
        torch.from_numpy(np.array(packed)),
        *(torch.from_numpy(p) for p in planes), torch.from_numpy(center),
        scale, mres)
    assert 0 < int(got.sum()) < got.numel()
    np.testing.assert_array_equal(got.numpy(), want)
    pos = np.stack(planes, -1)
    np.testing.assert_array_equal(
        tocc.occupancy_probe_cascaded(
            torch.from_numpy(np.array(packed)), torch.from_numpy(pos),
            torch.from_numpy(center), scale, mres).numpy(),
        np.asarray(jocc.occupancy_probe_cascaded(
            packed, jnp.asarray(pos), jnp.asarray(center), scale, mres)))
    np.testing.assert_array_equal(
        tocc.cascade_of_positions(torch.from_numpy(pos),
                                  torch.from_numpy(center), scale,
                                  cascades).numpy(),
        np.asarray(jocc.cascade_of_positions(jnp.asarray(pos),
                                             jnp.asarray(center), scale,
                                             cascades)))


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp('textured24_dense')
    return make_textured_scene(root, image_size=24, n_train=2, n_test=2)


@pytest.mark.parametrize('scale', [0.5, 1.0])
def test_dense_render_matches_jax(scene, tmp_path, scale):
    """PROBE_MODE 'dense': one grid (SCALE 0.5) probed by the marcher
    itself, two cascades (SCALE 1.0) through occupancy_probe_cascaded_xyz;
    rgb and alpha >= 45 dB against JAX's render."""
    cfg = ingp_config(scene, scale)
    cfg['RENDERER']['PROBE_MODE'] = 'dense'
    jm = _jax_model(cfg)
    ckpt = tmp_path / 'final.ckpt'
    jm.save(ckpt)
    jr = JMethods.get_renderer(JConfigNode(cfg), jm)
    want = jr.render_image(JDatasets.get_dataset(JConfigNode(cfg))
                           .subsets['test'][0])
    tm = TMethods.get_model(TConfigNode(cfg), checkpoint=str(ckpt),
                            device='cpu')
    tr = TMethods.get_renderer(TConfigNode(cfg), tm)
    grid = tr.grid_binary()
    assert grid.ndim == (3 if scale == 1.0 else 2)
    np.testing.assert_array_equal(grid.numpy(), np.asarray(jr.grid_binary()))
    launches = txg.xbar_gather.launches
    got = tr.render_image(TDatasets.get_dataset(TConfigNode(cfg))
                          .subsets['test'][0])
    assert txg.xbar_gather.launches == launches      # CPU: plain versions
    assert float(got['alpha'].mean()) > 0.01
    for key in ('rgb', 'alpha'):
        a, b = np.asarray(want[key]), got[key].numpy()
        psnr = -10 * np.log10(max(float(np.mean((a - b) ** 2)), 1e-20))
        assert psnr >= MIN_PSNR_DB, f'{key}: {psnr:.1f} dB'


@pytest.fixture(scope='module')
def scene32(tmp_path_factory):
    root = tmp_path_factory.mktemp('textured32_dense')
    return make_textured_scene(root, image_size=32, n_train=8, n_test=2)


def test_dense_training_step_matches_jax(scene32):
    """One exact training step with PROBE_MODE 'dense' (two cascades)."""
    check_one_step(scene32, 'window', probe_mode='dense')
