"""The port's image, flow and color-space IO and its blob scenes against the
JAX package.

* Middlebury .flo files: each package reads the other's, and both write
  the same bytes for the same flow; a bad magic number is refused.
* ``flow_to_color``, ``srgb_to_linear`` and ``linear_to_srgb`` (numpy in
  both packages): bit-identical outputs on seeded inputs.
* ``resize_image`` of a 2-channel flow (per channel, float, bilinear) and of
  1, 3 and 4 channels: bit-identical.
* ``load_images_parallel`` on 8-bit PNGs: the same images in the same
  order as JAX's, within DECODE_ATOL (0 where both packages decode
  natively, or neither does).
* ``make_synthetic_scene`` and ``make_dynamic_scene``: the same files, byte
  for byte, as JAX's for the same arguments.
"""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from nerficg_torch.data import io as tio
from nerficg_torch.data import synthetic as tsyn
from nerficg_tpu.data import io as jio
from nerficg_tpu.data import synthetic as jsyn
from test_torch_colmap import DECODE_ATOL
from torch_threads import one_torch_thread  # noqa: F401  (autouse)


def _flow(seed=0, h=13, w=17):
    return (np.random.default_rng(seed).normal(size=(h, w, 2)) * 4
            ).astype(np.float32)


def test_flo_cross_read_and_bytes(tmp_path):
    flow = _flow()
    tio.write_flow(flow, tmp_path / 'port' / 'a.flo')
    jio.write_flow(flow, tmp_path / 'jax' / 'a.flo')
    assert (tmp_path / 'port' / 'a.flo').read_bytes() == \
        (tmp_path / 'jax' / 'a.flo').read_bytes()
    assert np.array_equal(jio.read_flow(tmp_path / 'port' / 'a.flo'), flow)
    got = tio.read_flow(tmp_path / 'jax' / 'a.flo')
    assert got.dtype == np.float32 and np.array_equal(got, flow)
    # float64 in, float32 on disk, as JAX writes it
    tio.write_flow(flow.astype(np.float64), tmp_path / 'b.flo')
    assert (tmp_path / 'b.flo').read_bytes() == \
        (tmp_path / 'jax' / 'a.flo').read_bytes()
    bad = tmp_path / 'bad.flo'
    bad.write_bytes(b'\x00' * 12)
    with pytest.raises(ValueError):
        tio.read_flow(bad)


@pytest.mark.parametrize('max_radius', [None, 2.5])
def test_flow_to_color_identical(max_radius):
    flow = _flow(1)
    flow[0, 0] = 0.0                     # a zero vector
    flow[0, 1] = [-1.0, 0.0]             # on the hue wheel's seam
    got = tio.flow_to_color(flow, max_radius)
    assert got.dtype == np.float32 and got.shape == flow.shape[:2] + (3,)
    assert np.array_equal(got, jio.flow_to_color(flow, max_radius))


def test_srgb_pair_identical():
    x = np.concatenate([np.linspace(-0.01, 1.01, 4097),
                        [0.0, 0.0031308, 0.04045]]).astype(np.float32)
    for fn in ('srgb_to_linear', 'linear_to_srgb'):
        got, want = getattr(tio, fn)(x), getattr(jio, fn)(x)
        assert got.dtype == want.dtype
        assert np.array_equal(got, want, equal_nan=True), fn
    np.testing.assert_allclose(tio.linear_to_srgb(tio.srgb_to_linear(
        x[(x >= 0) & (x <= 1)])), x[(x >= 0) & (x <= 1)], atol=1e-5)


@pytest.mark.parametrize('channels', [1, 2, 3, 4])
@pytest.mark.parametrize('factor', [0.5, 0.75, 2.0])
def test_resize_identical(channels, factor):
    rng = np.random.default_rng(channels)
    image = rng.random((12, 20, channels)).astype(np.float32)
    if channels == 2:
        image = image * 6 - 3            # flow: signed, beyond [0, 1]
    got = tio.resize_image(image, factor)
    want = jio.resize_image(image, factor)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert got.shape == (round(12 * factor), round(20 * factor), channels)
    assert np.array_equal(got, want)


def test_load_images_parallel(tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for i, shape in enumerate([(9, 7, 3), (5, 11, 4), (6, 6), (8, 3, 3)]):
        path = tmp_path / f'{i}.png'
        Image.fromarray(rng.integers(0, 256, shape, np.uint8)).save(path)
        paths.append(path)
    got = tio.load_images_parallel(paths, max_workers=3)
    want = jio.load_images_parallel(paths, max_workers=3)
    assert len(got) == len(want) == 4
    for g, w, path in zip(got, want, paths):
        assert g.shape == w.shape and g.dtype == np.float32
        np.testing.assert_allclose(g, w, rtol=0, atol=DECODE_ATOL)
        assert np.array_equal(g, tio.load_image(path))
    halves = tio.load_images_parallel(paths, scale_factor=0.5)
    for g, path in zip(halves, paths):
        assert np.array_equal(g, tio.load_image(path, 0.5))


def _files(root: Path) -> dict:
    return {p.relative_to(root).as_posix(): p.read_bytes()
            for p in sorted(root.rglob('*')) if p.is_file()}


@pytest.mark.parametrize('maker, kwargs', [
    ('make_synthetic_scene', {}),
    ('make_synthetic_scene', {'image_size': 20, 'n_train': 5, 'n_test': 3}),
    ('make_dynamic_scene', {}),
    ('make_dynamic_scene', {'image_size': 18, 'n_train': 4, 'n_test': 1}),
])
def test_blob_scenes_write_jax_files(tmp_path, maker, kwargs):
    getattr(tsyn, maker)(tmp_path / 'port', **kwargs)
    getattr(jsyn, maker)(tmp_path / 'jax', **kwargs)
    got, want = _files(tmp_path / 'port'), _files(tmp_path / 'jax')
    assert sorted(got) == sorted(want)
    assert any(name.endswith('.json') for name in got)
    for name in want:
        assert got[name] == want[name], name
