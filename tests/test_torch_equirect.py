"""The port's EquirectangularCamera against the JAX package's.

* On numpy inputs both run the same numpy code: every function's output is
  bit-identical.
* On tensors (torch against jnp, float32): angles and unit directions to
  ANGLE_ATOL (radians), camera-space points to ANGLE_ATOL x their range,
  pixel coordinates to ANGLE_ATOL x the pixels per radian (the float32
  arcsin and atan2 of the two libraries differ in the last bits).
* The cached local ray directions (256x128, and 7x5) to ANGLE_ATOL.
* ``scaled`` keeps the settings and rounds the size as JAX's does.
* The seam, the poles and the camera centre: x = -0.0 and +0.0 behind the
  camera give azimuth -pi and +pi (pixel x 0 and width), straight up and
  down give pixel y 0 and height, a point at the centre has range 0 and
  the image centre; identical in both packages, on numpy and on tensors.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.cameras.base import SharedCameraSettings as TSettings
from nerficg_torch.cameras.equirectangular import \
    EquirectangularCamera as TCamera
from nerficg_tpu.cameras.equirectangular import \
    EquirectangularCamera as JCamera
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ANGLE_ATOL = 1e-6
WIDTH, HEIGHT = 256, 128


def _inputs(seed=0, n=2000):
    rng = np.random.default_rng(seed)
    pixels = (rng.random((n, 2)) * [WIDTH, HEIGHT]).astype(np.float32)
    ranges = (rng.random(n) * 5 + 0.1).astype(np.float32)
    points = (rng.normal(size=(n, 3)) * 3).astype(np.float32)
    return pixels, ranges, points


def test_numpy_paths_identical():
    t, j = TCamera(WIDTH, HEIGHT), JCamera(WIDTH, HEIGHT)
    pixels, ranges, points = _inputs()
    for got, want in zip(t.pixel_to_angles(pixels), j.pixel_to_angles(pixels)):
        assert isinstance(got, np.ndarray) and np.array_equal(got, want)
    theta, phi = j.pixel_to_angles(pixels)
    assert np.array_equal(t.angles_to_pixel(theta, phi),
                          j.angles_to_pixel(theta, phi))
    assert np.array_equal(t.screen_to_cam(pixels, ranges),
                          j.screen_to_cam(pixels, ranges))
    got = t.cam_to_screen(points)
    assert isinstance(got, np.ndarray)
    assert np.array_equal(got, j.cam_to_screen(points))


def test_tensor_paths_match_jax():
    t, j = TCamera(WIDTH, HEIGHT), JCamera(WIDTH, HEIGHT)
    pixels, ranges, points = _inputs(1)
    tp, tr, tx = (torch.from_numpy(a) for a in (pixels, ranges, points))
    jp, jr, jx = (jnp.asarray(a) for a in (pixels, ranges, points))
    for got, want in zip(t.pixel_to_angles(tp), j.pixel_to_angles(jp)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ANGLE_ATOL)
    theta, phi = j.pixel_to_angles(pixels)
    got = t.angles_to_pixel(torch.from_numpy(theta), torch.from_numpy(phi))
    assert isinstance(got, torch.Tensor)
    np.testing.assert_allclose(got.numpy(), np.asarray(j.angles_to_pixel(
        jnp.asarray(theta), jnp.asarray(phi))), rtol=0,
        atol=ANGLE_ATOL * WIDTH / (2 * math.pi))
    got = t.screen_to_cam(tp, tr).numpy()
    want = np.asarray(j.screen_to_cam(jp, jr))
    assert np.all(np.abs(got - want) <= ANGLE_ATOL * ranges[:, None])
    got = t.cam_to_screen(tx).numpy()
    want = np.asarray(j.cam_to_screen(jx))
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=0,
                               atol=ANGLE_ATOL * WIDTH / (2 * math.pi))
    np.testing.assert_allclose(got[:, 1], want[:, 1], rtol=0,
                               atol=ANGLE_ATOL * HEIGHT / math.pi)
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=1e-6, atol=0)


@pytest.mark.parametrize('size', [(WIDTH, HEIGHT), (7, 5)])
def test_local_ray_directions_match_jax(size):
    t, j = TCamera(*size), JCamera(*size)
    got = t.local_ray_directions('cpu')
    want = np.asarray(j.local_ray_directions())
    assert got.shape == want.shape == (size[0] * size[1], 3)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ANGLE_ATOL)
    np.testing.assert_allclose(np.linalg.norm(got.numpy(), axis=-1), 1.0,
                               atol=ANGLE_ATOL)
    assert t.local_ray_directions('cpu') is got          # cached


def test_scaled():
    settings = TSettings(near=0.1, far=50.0)
    t = TCamera(255, 127, settings=settings)
    j = JCamera(255, 127)
    for factor in (0.5, 0.25, 1 / 3, 2.0, 1e-3):
        got, want = t.scaled(factor), j.scaled(factor)
        assert isinstance(got, TCamera) and got.settings is settings
        assert (got.width, got.height) == (want.width, want.height)


_SPECIAL = np.array([[-0.0, 0.0, -1.0],    # behind, on the seam: -pi
                     [0.0, 0.0, -1.0],     # the seam's other side: +pi
                     [0.0, -1.0, 0.0],     # straight up (-y)
                     [0.0, 1.0, 0.0],      # straight down
                     [0.0, -2.0, 1e-30],   # up, past the clip's edge
                     [0.0, 0.0, 0.0],      # the camera centre
                     [0.0, 0.0, 1.0]],     # straight ahead
                    np.float32)


def test_seam_poles_and_centre():
    t, j = TCamera(WIDTH, HEIGHT), JCamera(WIDTH, HEIGHT)
    expected = np.array([[0, 64, 1], [256, 64, 1], [128, 0, 1],
                         [128, 128, 1], [128, 0, 2], [128, 64, 0],
                         [128, 64, 1]], np.float32)
    on_numpy = t.cam_to_screen(_SPECIAL)
    on_tensor = t.cam_to_screen(torch.from_numpy(_SPECIAL)).numpy()
    assert np.array_equal(on_numpy, np.asarray(j.cam_to_screen(_SPECIAL)))
    assert np.array_equal(on_tensor,
                          np.asarray(j.cam_to_screen(jnp.asarray(_SPECIAL))))
    assert np.array_equal(on_numpy, expected)
    assert np.array_equal(on_tensor, expected)
    # Unprojecting the poles and the seam returns those directions.
    corners = np.array([[0, 64], [256, 64], [128, 0], [128, 128]], np.float32)
    got = t.screen_to_cam(torch.from_numpy(corners), torch.ones(4)).numpy()
    want = np.array([[0, 0, -1], [0, 0, -1], [0, -1, 0], [0, 1, 0]],
                    np.float32)
    np.testing.assert_allclose(got, want, rtol=0, atol=ANGLE_ATOL)
    np.testing.assert_allclose(got, np.asarray(j.screen_to_cam(
        jnp.asarray(corners), jnp.ones(4))), rtol=0, atol=ANGLE_ATOL)
