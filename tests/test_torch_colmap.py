"""The port's COLMAP reader and capture loaders against the JAX package.

``write_colmap_model`` and ``write_capture`` write COLMAP fixtures; the
other test files of the COLMAP capture path import them from here.

* The reader: on models written in .bin and in .txt with all six camera
  models the loaders support (and one the intrinsics refuse), the port's
  ``read_colmap_model`` and JAX's give identical cameras, images (qvec,
  tvec, names, ids) and points; ``intrinsics()`` and ``c2w()`` agree.
* The Colmap loader against the NeRF loader: a capture written from
  ``make_textured_scene`` (each view's w2c from ``opengl_to_colmap``) loads
  with NORMALIZE_PCA=False to the NeRF loader's views: intrinsics exactly,
  c2w within C2W_ATOL, images bit for bit.
* Every new loader against JAX's on the same fixture: Colmap (PCA,
  distortion, masks, depth with normalization), MipNeRF360, TanksAndTemples,
  TanksAndTemples_3DGS and Empty give the same splits and view order, c2w
  (np.array_equal), intrinsics, near and far, point cloud and bounding box.
* The registry lists all 13 datasets, and the data layer's modules import
  with ``jax`` blocked.
"""

import json
import math
import struct
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from nerficg_torch.cameras.pose import rotation_matrix_to_quaternion
from nerficg_torch.core.config import ConfigNode as TConfig
from nerficg_torch.core.logging import Logger as TLogger
from nerficg_torch import native as tnative
from nerficg_torch.core.registry import Datasets as TDatasets
from nerficg_torch.data.colmap_model import \
    read_colmap_model as t_read_colmap_model
from nerficg_torch.data.loaders.nerf import (BLENDER_TO_COLMAP_WORLD,
                                             opengl_to_colmap)
from nerficg_torch.data.synthetic import make_textured_scene
from nerficg_tpu.core.config import ConfigNode as JConfig
from nerficg_tpu import native as jnative
from nerficg_tpu.core.registry import Datasets as JDatasets
from nerficg_tpu.data.colmap_model import \
    read_colmap_model as j_read_colmap_model
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TLogger.set_level('SILENT')

# The reader rotates by q / (|q| + 1e-12) (colmap_model.py, both packages),
# so a unit quaternion's rotation comes back scaled by ~(1 - 2e-12) and a
# camera at distance 4 moves by ~1e-11.
C2W_ATOL = 1e-12 * 16

# Both packages decode PNG and JPEG through the same native decoder (each
# its own copy of image_io.cpp), or both through PIL where it does not
# build: the same arrays. Where only one of them has it (the JAX package
# builds into ~/.cache, the port into build/), the native decode
# multiplies by 1/255 and PIL's path divides by 255: one ulp apart below 1.
DECODE_ATOL = 0.0 if tnative.native_io_available() == \
    jnative.native_io_available() else 2.0 ** -24

_MODEL_IDS = {'SIMPLE_PINHOLE': 0, 'PINHOLE': 1, 'SIMPLE_RADIAL': 2,
              'RADIAL': 3, 'OPENCV': 4, 'OPENCV_FISHEYE': 5,
              'FULL_OPENCV': 6}


# -- fixture writers (test code, not an API of the package) -----------------

def write_colmap_model(model_dir, cameras, images, points, binary=True):
    """A COLMAP sparse model in the documented .bin or .txt format.

    cameras: [(camera_id, model, width, height, params)];
    images: [(image_id, qvec wxyz, tvec, camera_id, name)], each with two
    2D observations; points: (xyz (N, 3) f64, rgb (N, 3) uint8), each with
    a two-entry track."""
    model_dir = Path(model_dir)
    model_dir.mkdir(parents=True, exist_ok=True)
    xyz, rgb = points
    n = len(xyz)
    if binary:
        with open(model_dir / 'cameras.bin', 'wb') as f:
            f.write(struct.pack('<Q', len(cameras)))
            for cam_id, model, width, height, params in cameras:
                f.write(struct.pack('<iiQQ', cam_id, _MODEL_IDS[model],
                                    width, height))
                f.write(struct.pack(f'<{len(params)}d', *params))
        with open(model_dir / 'images.bin', 'wb') as f:
            f.write(struct.pack('<Q', len(images)))
            for image_id, qvec, tvec, cam_id, name in images:
                f.write(struct.pack('<i7di', image_id, *qvec, *tvec, cam_id))
                f.write(name.encode() + b'\x00')
                f.write(struct.pack('<Q', 2))
                f.write(struct.pack('<ddqddq', 1.5, 2.5, 0, 3.5, 4.5, -1))
        record = np.dtype([('id', '<u8'), ('xyz', '<f8', 3), ('rgb', 'u1', 3),
                           ('error', '<f8'), ('track_length', '<u8'),
                           ('track', '<i4', 4)])
        table = np.zeros(n, record)
        table['id'] = np.arange(1, n + 1)
        table['xyz'] = xyz
        table['rgb'] = rgb
        table['error'] = 0.5
        table['track_length'] = 2
        table['track'] = [1, 0, 2, 1]
        with open(model_dir / 'points3D.bin', 'wb') as f:
            f.write(struct.pack('<Q', n))
            f.write(table.tobytes())
        return model_dir
    with open(model_dir / 'cameras.txt', 'w') as f:
        f.write('# CAMERA_ID, MODEL, WIDTH, HEIGHT, PARAMS[]\n')
        for cam_id, model, width, height, params in cameras:
            f.write(' '.join([str(cam_id), model, str(width), str(height)] +
                             [repr(float(p)) for p in params]) + '\n')
    with open(model_dir / 'images.txt', 'w') as f:
        f.write('# IMAGE_ID, QW, QX, QY, QZ, TX, TY, TZ, CAMERA_ID, NAME\n')
        for image_id, qvec, tvec, cam_id, name in images:
            f.write(' '.join([str(image_id)] +
                             [repr(float(v)) for v in (*qvec, *tvec)] +
                             [str(cam_id), name]) + '\n')
            f.write('1.5 2.5 1 3.5 4.5 -1\n')
    with open(model_dir / 'points3D.txt', 'w') as f:
        f.write('# POINT3D_ID, X, Y, Z, R, G, B, ERROR, TRACK[]\n')
        for i in range(n):
            f.write(' '.join([str(i + 1)] +
                             [repr(float(v)) for v in xyz[i]] +
                             [str(int(c)) for c in rgb[i]] +
                             ['0.5', '1 0 2 1']) + '\n')
    return model_dir


def _sphere_points(count, outlier_share, seed):
    """``count`` points on the textured scene's sphere (radius 0.8), coloured
    as its images show them (texture x Lambertian shade, make_textured_scene
    seed 0), plus ``outlier_share`` of them uniform in a cube of side 8, in
    the scene's (pre-COLMAP) world frame."""
    from nerficg_torch.data.synthetic import _texture_fn
    rng = np.random.default_rng(seed)
    normals = rng.normal(size=(count, 3))
    normals /= np.linalg.norm(normals, axis=-1, keepdims=True)
    light = np.array([0.5, 0.7, 0.5]) / np.linalg.norm([0.5, 0.7, 0.5])
    texture = _texture_fn(np.random.default_rng(0), (3.0, 8.0, 14.0))
    colors = texture(0.8 * normals) * \
        (0.35 + 0.65 * np.maximum(normals @ light, 0.0))[:, None]
    outliers = int(round(count * outlier_share))
    xyz = np.concatenate([0.8 * normals,
                          rng.uniform(-4.0, 4.0, (outliers, 3))])
    colors = np.concatenate([colors, rng.random((outliers, 3))])
    return xyz, np.round(colors * 255).astype(np.uint8)


def write_capture(root, scene, image_dir='images', model_scale=1,
                  rows=None, n_points=2000, outlier_share=0.02, seed=0,
                  binary=True, second_scale=None):
    """A COLMAP capture of a ``make_textured_scene`` directory.

    Every view (train, then test) becomes ``{k:03d}.png`` in
    ``root/image_dir`` (RGB, composited on black, rows ``rows`` kept), and
    one PINHOLE camera at ``model_scale`` x the images' size (Mip-NeRF
    360's images_4 beside a full-size model), whose centre moves with the
    crop. With ``second_scale``, every odd view's image is resized by that
    factor (Lanczos) and it has a second PINHOLE camera, the first's
    intrinsics times the factor. Each pose is the NeRF loader's c2w
    (``opengl_to_colmap``) written as the w2c's wxyz quaternion and
    translation. The points: ``n_points`` on the sphere and
    ``outlier_share`` outliers (``_sphere_points``)."""
    root, scene = Path(root), Path(scene)
    images, index = [], 0
    for split in ('train', 'test'):
        meta = json.loads((scene / f'transforms_{split}.json').read_text())
        for frame in meta['frames']:
            rgba = np.asarray(Image.open(scene / (frame['file_path'][2:] +
                                                  '.png')))
            height, width = rgba.shape[:2]
            top, bottom = rows if rows is not None else (0, height)
            name = f'{index:03d}.png'
            (root / image_dir).mkdir(parents=True, exist_ok=True)
            image = Image.fromarray(rgba[top:bottom, :, :3])
            camera_id = 1
            if second_scale is not None and index % 2:
                camera_id = 2
                image = image.resize(
                    (round(width * second_scale),
                     round((bottom - top) * second_scale)), Image.LANCZOS)
            image.save(root / image_dir / name)
            w2c = np.linalg.inv(opengl_to_colmap(
                np.asarray(frame['transform_matrix'])))
            images.append((index + 1,
                           rotation_matrix_to_quaternion(w2c[:3, :3]),
                           w2c[:3, 3], camera_id, name))
            index += 1
        focal = 0.5 * width / math.tan(0.5 * meta['camera_angle_x'])
    cameras = []
    for camera_id, s in ((1, model_scale),
                         (2, None if second_scale is None
                          else model_scale * second_scale)):
        if s is not None:
            cameras.append((camera_id, 'PINHOLE', round(width * s),
                            round((bottom - top) * s),
                            [focal * s, focal * s, width / 2 * s,
                             (height / 2 - top) * s]))
    xyz, rgb = _sphere_points(n_points, outlier_share, seed)
    write_colmap_model(root / 'sparse' / '0', cameras, images,
                       (xyz @ BLENDER_TO_COLMAP_WORLD[:3, :3].T, rgb), binary=binary)
    return root


# -- the reader -------------------------------------------------------------

_CAMERAS = [
    (1, 'SIMPLE_PINHOLE', 64, 48, [60.0, 32.0, 24.0]),
    (2, 'PINHOLE', 64, 48, [60.0, 55.0, 32.5, 23.5]),
    (3, 'SIMPLE_RADIAL', 80, 60, [70.0, 40.0, 30.0, 0.05]),
    (4, 'RADIAL', 80, 60, [70.0, 40.0, 30.0, 0.05, -0.01]),
    (5, 'OPENCV', 96, 72, [80.0, 81.0, 48.0, 36.0, 0.1, -0.02, 0.001,
                           -0.002]),
    (6, 'FULL_OPENCV', 96, 72, [80.0, 81.0, 48.0, 36.0, 0.1, -0.02, 0.001,
                                -0.002, 0.003, 0.01, -0.004, 0.002]),
    (7, 'OPENCV_FISHEYE', 96, 72, [80.0, 81.0, 48.0, 36.0, 0.1, 0.0, 0.0,
                                   0.0]),
]


def _random_model(seed=0, n_points=50):
    rng = np.random.default_rng(seed)
    images = []
    for i in range(len(_CAMERAS)):
        q = rng.normal(size=4)
        images.append((10 + i, q / np.linalg.norm(q), rng.normal(size=3) * 2,
                       _CAMERAS[i][0], f'view_{i}.jpg'))
    points = (rng.normal(size=(n_points, 3)),
              rng.integers(0, 256, (n_points, 3)).astype(np.uint8))
    return _CAMERAS, images, points


@pytest.mark.parametrize('binary', [True, False], ids=['bin', 'txt'])
def test_reader_matches_jax(tmp_path, binary):
    """Identical cameras (ids, models, sizes, params), images (ids, qvec,
    tvec, camera ids, names) and points; each supported model's
    intrinsics and each image's c2w equal JAX's; OPENCV_FISHEYE is refused
    by both."""
    model = write_colmap_model(tmp_path / 'sparse', *_random_model(),
                               binary=binary)
    t_cams, t_imgs, (t_pts, t_cols) = t_read_colmap_model(model)
    j_cams, j_imgs, (j_pts, j_cols) = j_read_colmap_model(model)
    assert sorted(t_cams) == sorted(j_cams) == [c[0] for c in _CAMERAS]
    for cam_id, want in j_cams.items():
        got = t_cams[cam_id]
        assert (got.camera_id, got.model, got.width, got.height) == \
            (want.camera_id, want.model, want.width, want.height)
        assert np.array_equal(got.params, want.params)
        assert np.array_equal(got.params, _CAMERAS[cam_id - 1][4])
        if got.model == 'OPENCV_FISHEYE':
            with pytest.raises(ValueError):
                got.intrinsics()
            with pytest.raises(ValueError):
                want.intrinsics()
        else:
            assert got.intrinsics() == want.intrinsics()
    assert sorted(t_imgs) == sorted(j_imgs)
    for image_id, want in j_imgs.items():
        got = t_imgs[image_id]
        assert (got.image_id, got.camera_id, got.name) == \
            (want.image_id, want.camera_id, want.name)
        assert np.array_equal(got.qvec, want.qvec)
        assert np.array_equal(got.tvec, want.tvec)
        assert np.array_equal(got.c2w(), want.c2w())
    assert t_pts.dtype == j_pts.dtype == np.float32
    assert np.array_equal(t_pts, j_pts) and np.array_equal(t_cols, j_cols)
    assert len(t_pts) == 50


def test_reader_bin_equals_txt(tmp_path):
    """The .bin and the .txt of one model read to the same values."""
    parts = _random_model(seed=3)
    a = t_read_colmap_model(write_colmap_model(tmp_path / 'a', *parts))
    b = t_read_colmap_model(write_colmap_model(tmp_path / 'b', *parts,
                                               binary=False))
    for cam_id in a[0]:
        assert np.array_equal(a[0][cam_id].params, b[0][cam_id].params)
    for image_id in a[1]:
        assert np.array_equal(a[1][image_id].qvec, b[1][image_id].qvec)
        assert np.array_equal(a[1][image_id].tvec, b[1][image_id].tvec)
    assert np.array_equal(a[2][0], b[2][0])
    assert np.array_equal(a[2][1], b[2][1])


# -- the loaders --------------------------------------------------------------

@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    return make_textured_scene(tmp_path_factory.mktemp('textured48'),
                               image_size=48, n_train=14, n_test=3)


@pytest.fixture(scope='module')
def capture(scene, tmp_path_factory):
    """The scene as a full-size COLMAP capture (binary model)."""
    return write_capture(tmp_path_factory.mktemp('capture'), scene)


def _dataset(cls, name, path, **dataset):
    return cls({'GLOBAL': {'DATASET_TYPE': name},
                'DATASET': {'PATH': str(path), **dataset}})


def test_colmap_loader_matches_nerf_loader(scene, capture):
    """Without PCA alignment and test split, the Colmap loader's views are
    the NeRF loader's (train then test): the same intrinsics, c2w within
    C2W_ATOL, and rgb bit for bit (the NeRF loader's rgb of an RGBA image
    with a black background is the RGB written)."""
    nerf = TDatasets.get_dataset(_dataset(TConfig, 'NeRF', scene))
    colmap = TDatasets.get_dataset(_dataset(
        TConfig, 'Colmap', capture, NORMALIZE_PCA=False, TEST_STEP=0))
    want, got = nerf.all_views(), colmap.all_views()
    assert len(got) == len(want) == 17 and not colmap.subsets['test']
    worst = 0.0
    for g, w in zip(got, want):
        for key in ('width', 'height', 'focal_x', 'focal_y', 'center_x',
                    'center_y'):
            assert getattr(g.camera, key) == getattr(w.camera, key), key
        assert g.camera.distortion is None
        worst = max(worst, float(np.abs(g.c2w - w.c2w).max()))
        assert np.array_equal(g.rgb, w.rgb[..., :3])
    assert worst <= C2W_ATOL, worst


def _assert_datasets_equal(t, j):
    assert {s: len(v) for s, v in t.subsets.items()} == \
        {s: len(v) for s, v in j.subsets.items()}
    for subset in j.subsets:
        for tv, jv in zip(t.subsets[subset], j.subsets[subset]):
            assert (tv.frame_idx, tv.global_frame_idx, tv.camera_index) == \
                (jv.frame_idx, jv.global_frame_idx, jv.camera_index)
            assert np.array_equal(tv.c2w, jv.c2w)
            tc, jc = tv.camera, jv.camera
            assert tc._intrinsics_key() == jc._intrinsics_key()
            assert (tc.width, tc.height, tc.near, tc.far) == \
                (jc.width, jc.height, jc.near, jc.far)
            for slot in ('rgb', 'alpha', 'depth'):
                t_data = getattr(tv, f'{slot}_data')
                j_data = getattr(jv, f'{slot}_data')
                assert t_data.path == j_data.path, slot
                assert t_data.scale_factor == j_data.scale_factor, slot
                assert t_data.data_scale == j_data.data_scale, slot
    assert (t.point_cloud is None) == (j.point_cloud is None)
    if j.point_cloud is not None:
        assert np.array_equal(t.point_cloud.positions,
                              j.point_cloud.positions)
        assert np.array_equal(t.point_cloud.colors, j.point_cloud.colors)
    assert np.array_equal(t.bounding_box.bounds, j.bounding_box.bounds)
    assert np.array_equal(t._applied_transform, j._applied_transform)


@pytest.fixture(scope='module')
def rich_capture(scene, tmp_path_factory):
    """A text model with an OPENCV camera (distortion), masks and depth
    maps, and images_2 beside the full-size model."""
    root = write_capture(tmp_path_factory.mktemp('rich'), scene,
                         image_dir='images_2', model_scale=2, rows=(4, 44),
                         binary=False)
    model = root / 'sparse' / '0'
    lines = (model / 'cameras.txt').read_text().splitlines()
    parts = lines[1].split()
    parts[1] = 'OPENCV'
    lines[1] = ' '.join(parts + ['0.05', '-0.01', '0.001', '-0.002'])
    (model / 'cameras.txt').write_text('\n'.join(lines) + '\n')
    rng = np.random.default_rng(2)
    for image in sorted((root / 'images_2').iterdir()):
        (root / 'images').mkdir(exist_ok=True)
        Image.open(image).save(root / 'images' / image.name)
        (root / 'masks').mkdir(exist_ok=True)
        Image.fromarray((rng.random((40, 48)) > 0.5).astype(np.uint8) *
                        255).save(root / 'masks' / image.name)
        (root / 'depth').mkdir(exist_ok=True)
        np.save(root / 'depth' / (image.stem + '.npy'),
                rng.random((40, 48)).astype(np.float32))
    return root


_LOADER_CASES = {
    'colmap_pca': ('Colmap', 'capture', {}),
    'colmap_no_pca': ('Colmap', 'capture', {'NORMALIZE_PCA': False,
                                            'TEST_STEP': 4}),
    'colmap_recenter_cube': ('Colmap', 'capture',
                             {'NORMALIZE_RECENTER': True,
                              'NORMALIZE_CUBE': True}),
    'colmap_opencv_masks_depth': ('Colmap', 'rich_capture',
                                  {'LOAD_MASKS': True, 'LOAD_DEPTH': True,
                                   'NORMALIZE_CUBE': True,
                                   'IMAGE_SCALE_FACTOR': 0.5}),
    'mipnerf360': ('MipNeRF360', 'rich_capture', {'DOWNSAMPLE': 2}),
    'mipnerf360_full_size': ('MipNeRF360', 'capture', {}),
    'tanks_and_temples': ('TanksAndTemples', 'capture', {}),
    'tanks_and_temples_3dgs': ('TanksAndTemples_3DGS', 'rich_capture',
                               {'IMAGE_DIR': 'images_2',
                                'INTRINSICS_SCALE': 1.0}),
    'tanks_and_temples_3dgs_half': ('TanksAndTemples_3DGS', 'capture', {}),
    'empty': ('Empty', 'capture', {'WIDTH': 64, 'HEIGHT': 48}),
}


@pytest.mark.parametrize('case', list(_LOADER_CASES))
def test_loader_matches_jax(case, request):
    """The same splits and view order, c2w (array_equal), intrinsics and
    distortion, near and far, image slots (paths, scale factors, depth
    scale), point cloud, bounding box and applied transform as JAX's; the
    images load to the same arrays within DECODE_ATOL."""
    name, fixture, dataset = _LOADER_CASES[case]
    path = request.getfixturevalue(fixture)
    t = TDatasets.get_dataset(_dataset(TConfig, name, path, **dataset))
    j = JDatasets.get_dataset(_dataset(JConfig, name, path, **dataset))
    _assert_datasets_equal(t, j)
    views = t.all_views()
    assert views
    for tv, jv in zip(views[:2], j.all_views()[:2]):
        for slot in ('rgb', 'alpha', 'depth'):
            got, want = getattr(tv, slot), getattr(jv, slot)
            assert (got is None) == (want is None), slot
            if want is not None:
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=DECODE_ATOL, err_msg=slot)


def test_mipnerf360_intrinsics_scaled_once(rich_capture):
    """images_2 beside a model at 2x: the camera is the images' size, its
    intrinsics half the model's, and the images load unresized."""
    t = TDatasets.get_dataset(_dataset(TConfig, 'MipNeRF360', rich_capture,
                                       DOWNSAMPLE=2))
    view = t.subsets['train'][0]
    assert (view.camera.width, view.camera.height) == (48, 40)
    assert view.camera.center_y == pytest.approx(20.0)
    assert view.rgb.shape == (40, 48, 3)
    assert view.rgb_data.scale_factor is None
    assert len(t.subsets['test']) == 3          # every 8th of 17


def test_registry_lists_the_new_datasets():
    """All 13 of the JAX package's datasets, with its defaults."""
    names = TDatasets.options()
    assert names == JDatasets.options()
    for name in ('Colmap', 'MipNeRF360', 'TanksAndTemples',
                 'TanksAndTemples_3DGS', 'Empty', 'NeRF', 'DNeRF',
                 'NvidiaShort', 'PlenopticVideoBlender', 'OmniBlender',
                 'Ricoh360', 'RaRPano', 'RTMV'):
        assert name in names
        assert TDatasets.get_class(name).default_parameters() == \
            JDatasets.get_class(name).default_parameters()


_NEW_MODULES = [
    'nerficg_torch.cameras.pose', 'nerficg_torch.cameras.distortion',
    'nerficg_torch.cameras.perspective', 'nerficg_torch.data.types',
    'nerficg_torch.data.ply', 'nerficg_torch.data.colmap_model',
    'nerficg_torch.data.base', 'nerficg_torch.data.loaders.colmap',
    'nerficg_torch.data.loaders.mipnerf360',
    'nerficg_torch.data.loaders.tanks_and_temples',
    'nerficg_torch.data.loaders.tanks_and_temples_3dgs',
    'nerficg_torch.data.loaders.empty', 'nerficg_torch.core.registry',
    'nerficg_torch.cameras.equirectangular', 'nerficg_torch.data.io',
    'nerficg_torch.data.synthetic', 'nerficg_torch.data.loaders.nerf',
    'nerficg_torch.data.loaders.omni_blender',
    'nerficg_torch.data.loaders.ricoh360',
    'nerficg_torch.data.loaders.rar_pano', 'nerficg_torch.data.loaders.rtmv',
    'nerficg_torch.data.loaders.nvidia_short',
    'nerficg_torch.data.loaders.plenoptic_video_blender',
    'nerficg_torch.methods.gaussian_splatting',
    'nerficg_torch.visual.trajectories',
    'nerficg_torch.scripts.convert_to_ply',
    'nerficg_torch.scripts.create_config',
    'nerficg_torch.scripts.inference',
]


def test_new_modules_import_without_jax():
    """In a fresh interpreter with ``jax`` and ``nerficg_tpu`` blocked in
    sys.modules, every module of the slice imports, and none of them
    brought either in."""
    code = ('import sys\n'
            'for name in ("jax", "jaxlib", "nerficg_tpu"):\n'
            '    sys.modules[name] = None\n'
            'import importlib\n'
            f'for m in {_NEW_MODULES!r}:\n'
            '    importlib.import_module(m)\n'
            'assert not any(k.split(".")[0] in ("jax", "nerficg_tpu") and v\n'
            '               for k, v in sys.modules.items())\n'
            'print("ok")\n')
    out = subprocess.run([sys.executable, '-c', code], capture_output=True,
                         text=True, cwd=Path(__file__).resolve().parent.parent,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == 'ok', out.stderr
