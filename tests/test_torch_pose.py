"""The port's pose math, scene normalization and lens distortion against the
JAX package on the CPU.

* Every function of ``cameras/pose.py`` on seeded random poses: the same
  float64 arrays as JAX's, exactly (np.array_equal), including each branch
  of ``rotation_matrix_to_quaternion`` and the PCA flip.
* ``normalize_scene`` under NORMALIZE_RECENTER, NORMALIZE_CUBE and both, on
  the NeRF loader: the same poses, planes, box and applied transform.
* Boxes and clouds under a transform, and ``AxisAlignedBox.cube``.
* Distortion: ``distort`` / ``undistort`` on numpy arrays equal JAX's
  exactly (the same numpy operations); on torch f32 tensors within 1e-6 of
  JAX's jnp; ``local_ray_directions`` and ``cam_to_screen`` of an OPENCV
  camera within 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.cameras import pose as tpose
from nerficg_torch.cameras.distortion import \
    RadialTangentialDistortion as TDist
from nerficg_torch.cameras.perspective import PerspectiveCamera as TCamera
from nerficg_torch.core.config import ConfigNode as TConfig
from nerficg_torch.core.logging import Logger as TLogger
from nerficg_torch.core.registry import Datasets as TDatasets
from nerficg_torch.data.synthetic import make_textured_scene
from nerficg_tpu.cameras import pose as jpose
from nerficg_tpu.cameras.distortion import \
    RadialTangentialDistortion as JDist
from nerficg_tpu.cameras.perspective import PerspectiveCamera as JCamera
from nerficg_tpu.core.config import ConfigNode as JConfig
from nerficg_tpu.core.registry import Datasets as JDatasets
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TLogger.set_level('SILENT')

ATOL = 1e-6
LENS = dict(k1=0.1, k2=-0.02, p1=0.001, p2=-0.002, k3=0.003, k4=0.01,
            k5=-0.004, k6=0.002)


def _random_c2ws(rng, n=12, spread=3.0):
    """n random rigid c2w matrices around a random centre."""
    q = rng.normal(size=(n, 4))
    c2w = np.tile(np.eye(4), (n, 1, 1))
    c2w[:, :3, :3] = jpose.quaternion_to_rotation_matrix(q)
    c2w[:, :3, 3] = rng.normal(size=3) + rng.normal(size=(n, 3)) * spread
    return c2w


def test_look_at_and_fov():
    rng = np.random.default_rng(0)
    for _ in range(10):
        eye, target, up = rng.normal(size=(3, 3))
        assert np.array_equal(tpose.look_at(eye, target),
                              jpose.look_at(eye, target))
        assert np.array_equal(tpose.look_at(eye, target, up),
                              jpose.look_at(eye, target, up))
        fov, size = rng.uniform(0.2, 2.5), rng.uniform(16, 2000)
        assert tpose.fov_to_focal(fov, size) == jpose.fov_to_focal(fov, size)
        assert tpose.focal_to_fov(size, fov * 100) == \
            jpose.focal_to_fov(size, fov * 100)


def test_quaternions_and_inverse():
    """Every branch of rotation_matrix_to_quaternion (trace > 0, then the
    largest diagonal entry at 0, 1, 2) and the batched inverse."""
    rng = np.random.default_rng(1)
    branches = set()
    c2ws = _random_c2ws(rng, 200)
    for c2w in c2ws:
        m = c2w[:3, :3]
        branches.add('trace' if np.trace(m) > 0 else
                      int(np.argmax(np.diag(m))))
        assert np.array_equal(tpose.rotation_matrix_to_quaternion(m),
                              jpose.rotation_matrix_to_quaternion(m))
    assert branches == {'trace', 0, 1, 2}
    q = rng.normal(size=(7, 4))
    assert np.array_equal(tpose.quaternion_to_rotation_matrix(q),
                          jpose.quaternion_to_rotation_matrix(q))
    assert np.array_equal(tpose.invert_3d_affine(c2ws),
                          jpose.invert_3d_affine(c2ws))


@pytest.mark.parametrize('seed', range(6))
def test_scene_alignments(seed):
    """average_pose, recenter_poses, transform_poses_pca (both signs of the
    mean camera y, so the flip runs) and rescale_poses_to_unit_cube with
    and without a box."""
    rng = np.random.default_rng(seed)
    c2ws = _random_c2ws(rng)
    if seed % 2:
        c2ws[:, :3, 1] = np.abs(c2ws[:, :3, 1])
    assert np.array_equal(tpose.average_pose(c2ws), jpose.average_pose(c2ws))
    for name in ('recenter_poses', 'transform_poses_pca',
                 'rescale_poses_to_unit_cube'):
        got = getattr(tpose, name)(c2ws)
        want = getattr(jpose, name)(c2ws)
        for g, w in zip(got, want):
            assert np.array_equal(g, w), name
    aabb = np.sort(rng.normal(size=(2, 3)) * 4, axis=0)
    for g, w in zip(tpose.rescale_poses_to_unit_cube(c2ws, aabb),
                    jpose.rescale_poses_to_unit_cube(c2ws, aabb)):
        assert np.array_equal(g, w)


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    return make_textured_scene(tmp_path_factory.mktemp('textured16'),
                               image_size=16, n_train=6, n_test=2)


@pytest.mark.parametrize('flags', [(True, False), (False, True), (True, True)],
                         ids=['recenter', 'cube', 'both'])
def test_normalize_scene_matches_jax(scene, flags):
    recenter, cube = flags
    cfg = {'GLOBAL': {'DATASET_TYPE': 'NeRF'},
           'DATASET': {'PATH': str(scene), 'NORMALIZE_RECENTER': recenter,
                       'NORMALIZE_CUBE': cube}}
    t = TDatasets.get_dataset(TConfig(cfg))
    j = JDatasets.get_dataset(JConfig(cfg))
    for tv, jv in zip(t.all_views(), j.all_views()):
        assert np.array_equal(tv.c2w, jv.c2w)
    assert (t.camera_settings.near, t.camera_settings.far) == \
        (j.camera_settings.near, j.camera_settings.far)
    assert np.array_equal(t.bounding_box.bounds, j.bounding_box.bounds)
    assert np.array_equal(t._applied_transform, j._applied_transform)
    assert not np.array_equal(t._applied_transform, np.eye(4))


def test_distortion_matches_jax():
    rng = np.random.default_rng(3)
    xy = rng.uniform(-0.6, 0.6, (500, 2))
    t, j = TDist(**LENS), JDist(**LENS)
    assert np.array_equal(t.distort(xy), j.distort(xy))
    assert np.array_equal(t.undistort(xy), j.undistort(xy))
    assert np.abs(t.distort(t.undistort(xy)) - xy).max() < 1e-6
    xy32 = xy.astype(np.float32)
    for name in ('distort', 'undistort'):
        got = getattr(t, name)(torch.from_numpy(xy32)).numpy()
        want = np.asarray(getattr(j, name)(jnp.asarray(xy32)))
        np.testing.assert_allclose(got, want, rtol=0, atol=ATOL, err_msg=name)
    params = {'k1': 0.1, 'p2': 0.3}
    assert TDist.from_colmap(params) == TDist(k1=0.1, p2=0.3)
    assert TDist().is_identity() and not t.is_identity()


def test_opencv_camera_matches_jax():
    """An OPENCV-model camera: the local ray directions (undistorted pixel
    grid) and the projection of points (distorted) within 1e-6 of JAX's."""
    intr = dict(width=40, height=30, focal_x=36.0, focal_y=35.0,
                center_x=19.5, center_y=15.5)
    t = TCamera(**intr, distortion=TDist(k1=0.1, k2=-0.02, p1=0.001,
                                         p2=-0.002))
    j = JCamera(**intr, distortion=JDist(k1=0.1, k2=-0.02, p1=0.001,
                                         p2=-0.002))
    got = t.local_ray_directions().numpy()
    want = np.asarray(j.local_ray_directions())
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    plain = TCamera(**intr).local_ray_directions().numpy()
    assert np.abs(got - plain).max() > 1e-3
    pts = np.random.default_rng(4).uniform(-1, 1, (64, 3)) + [0, 0, 3]
    pts = pts.astype(np.float32)
    assert np.array_equal(t.cam_to_screen(pts), j.cam_to_screen(pts))
    np.testing.assert_allclose(
        t.cam_to_screen(torch.from_numpy(pts)).numpy(),
        np.asarray(j.cam_to_screen(jnp.asarray(pts))), rtol=0,
        atol=ATOL * intr['focal_x'])     # 1e-6 on the normalized plane


def test_box_and_cloud_transforms_match_jax():
    """AxisAlignedBox.transform / .cube and BasicPointCloud.transform under
    a PCA alignment: the same float32 arrays as JAX's."""
    from nerficg_torch.data.types import AxisAlignedBox as TBox
    from nerficg_torch.data.types import BasicPointCloud as TCloud
    from nerficg_tpu.data.types import AxisAlignedBox as JBox
    from nerficg_tpu.data.types import BasicPointCloud as JCloud
    rng = np.random.default_rng(5)
    _, transform = jpose.transform_poses_pca(_random_c2ws(rng))
    bounds = np.sort(rng.normal(size=(2, 3)) * 3, axis=0)
    for got, want in ((TBox(bounds).transform(transform),
                       JBox(bounds).transform(transform)),
                      (TBox(bounds).cube(), JBox(bounds).cube())):
        assert np.array_equal(got.bounds, want.bounds)
    assert np.ptp(TBox(bounds).cube().size) == 0
    pts, cols = rng.normal(size=(100, 3)), rng.random((100, 3))
    got = TCloud(pts, cols).transform(transform)
    want = JCloud(pts, cols).transform(transform)
    assert np.array_equal(got.positions, want.positions)
    assert np.array_equal(got.colors, want.colors)
