"""The port's native image decoder against the JAX package's.

Fixtures (tests/image_fixtures.py) are PNGs written with zlib from known
uint8/uint16 arrays (8- and 16-bit RGB, RGBA, gray and gray + alpha, 2-bit
gray, palette images with and without a tRNS chunk) and PIL-written RGB
and gray JPEGs.

* ``load_image`` at scales 1 and 0.5 and ``load_images_parallel`` of both
  packages return the same arrays bit for bit. PIL, which decoded every
  image of the port before it had the native decoder, reads a 16-bit
  colour PNG as 8 bits and a palette image as its indices / 255, so the
  palette and 16-bit fixtures fail on a port that decodes with PIL.
* The native decoder's arrays equal the known ones exactly: 8-bit values
  x float32(1/255), 16-bit x float32(1/65535), a palette image as its
  palette's colours (RGBA with tRNS), 2-bit gray replicated to 8 bits; a
  JPEG equals PIL's decode / 255 within one ulp.
* ``native_io_available()`` agrees between the packages; with
  ``NERFICG_DISABLE_NATIVE`` set both decode with PIL and agree, but on
  a palette image, which the port's PIL path expands to its colours.
* The library builds into the repository's ``build/``; a missing file
  raises FileNotFoundError and a damaged PNG a DatasetError.
"""

from pathlib import Path

import numpy as np
import pytest
from PIL import Image

import nerficg_torch.native as tnative
import nerficg_tpu.native as jnative
from image_fixtures import write_fixtures, write_png
from nerficg_torch.core.errors import DatasetError
from nerficg_torch.data import io as tio
from nerficg_tpu.data import io as jio

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope='module')
def fixtures(tmp_path_factory):
    return write_fixtures(tmp_path_factory.mktemp('image_io'))


def test_native_available_in_both():
    assert tnative.native_io_available() == jnative.native_io_available()


@pytest.mark.parametrize('name', ['rgb8', 'rgb16', 'rgba8', 'rgba16',
                                  'gray8', 'gray16', 'gray_alpha8',
                                  'gray_alpha16', 'gray2', 'palette',
                                  'palette_trns', 'rgb_jpg', 'gray_jpeg'])
def test_load_image_matches_jax(fixtures, name):
    """Both packages' load_image at scales 1 and 0.5, bit for bit; the
    native decode equals the known array (JPEG: PIL's decode / 255 within
    one ulp)."""
    path, want = fixtures[name]
    got = tio.load_image(path)
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, jio.load_image(path))
    half = tio.load_image(path, 0.5)
    np.testing.assert_array_equal(half, jio.load_image(path, 0.5))
    assert half.shape[:2] == (round(got.shape[0] * 0.5),
                              round(got.shape[1] * 0.5))
    if not tnative.native_io_available():
        pytest.skip('the native decoder does not build here')
    if want is None:
        with Image.open(path) as img:
            pil = np.asarray(img).astype(np.float32) / 255.0
        np.testing.assert_array_max_ulp(got, pil.reshape(got.shape), 1)
    else:
        np.testing.assert_array_equal(got, want)


def test_palette_and_16_bit_repaired(fixtures):
    """The two faults of a PIL decode: a palette image comes back as its
    colours, (H, W, 3), and a 16-bit colour PNG keeps its low bits."""
    if not tnative.native_io_available():
        pytest.skip('the native decoder does not build here')
    assert tio.load_image(fixtures['palette'][0]).shape == (12, 10, 3)
    assert tio.load_image(fixtures['palette_trns'][0]).shape == (12, 10, 4)
    rgb16 = tio.load_image(fixtures['rgb16'][0])
    assert not np.array_equal(np.round(rgb16 * 255) / 255, rgb16)


def test_load_images_parallel_matches_jax(fixtures):
    paths = [p for p, _ in fixtures.values()] * 3
    got = tio.load_images_parallel(paths, max_workers=4)
    want = jio.load_images_parallel(paths, max_workers=4)
    assert len(got) == len(want) == len(paths)
    for g, w, path in zip(got, want, paths):
        np.testing.assert_array_equal(g, w, err_msg=str(path))
        np.testing.assert_array_equal(g, tio.load_image(path))
    halves = tio.load_images_parallel(paths[:6], scale_factor=0.5)
    for g, path in zip(halves, paths[:6]):
        np.testing.assert_array_equal(g, jio.load_image(path, 0.5))


def test_disabled_native_decodes_with_pil_in_both(fixtures, monkeypatch):
    """NERFICG_DISABLE_NATIVE: each package's next first use finds no
    decoder, and their PIL paths agree, but on a palette image: there the
    port's returns the palette's colours (within one ulp of the native
    decode: x / 255 against x * float32(1/255)), the JAX package's the
    indices / 255, a fault of the reference not copied."""
    monkeypatch.setenv('NERFICG_DISABLE_NATIVE', '1')
    for module in (tnative, jnative):
        monkeypatch.setattr(module, '_checked', False)
        monkeypatch.setattr(module, '_lib', None)
    assert not tnative.native_io_available()
    assert not jnative.native_io_available()
    palettes = ('palette', 'palette_trns')
    for name, (path, want) in fixtures.items():
        got = tio.load_image(path)
        if name in palettes:
            np.testing.assert_array_max_ulp(got, want, 1)
            assert jio.load_image(path).shape == (12, 10, 1)
        else:
            np.testing.assert_array_equal(got, jio.load_image(path),
                                          err_msg=name)
    assert tio.load_image(fixtures['palette'][0]).shape == (12, 10, 3)
    assert tio.load_image(fixtures['palette_trns'][0]).shape == (12, 10, 4)
    names = [n for n in fixtures if n not in palettes]
    paths = [fixtures[n][0] for n in names]
    for g, w in zip(tio.load_images_parallel(paths),
                    jio.load_images_parallel(paths)):
        np.testing.assert_array_equal(g, w)
    for name in palettes:
        got, = tio.load_images_parallel([fixtures[name][0]])
        np.testing.assert_array_equal(got, tio.load_image(fixtures[name][0]))


def test_build_goes_to_repository_build_dir():
    path, what = tnative.build_library()
    if path is None:
        pytest.skip(f'the native decoder does not build here: {what}')
    assert path.parent == REPO / 'build'
    assert path.name.startswith('image_io_') and path.is_file()
    assert what in ('built', 'reused')


def test_failures_raise(tmp_path):
    if not tnative.native_io_available():
        pytest.skip('the native decoder does not build here')
    with pytest.raises(FileNotFoundError):
        tio.load_image(tmp_path / 'missing.png')
    bad = tmp_path / 'damaged.png'
    write_png(bad, np.zeros((4, 4, 3), np.uint8), 2, 8)
    bad.write_bytes(bad.read_bytes()[:40])
    with pytest.raises(DatasetError):
        tio.load_image(bad)
    with pytest.raises(DatasetError):
        tnative.decode_batch([bad, bad])
