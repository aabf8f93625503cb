"""The port's six remaining loaders, and NeRF's LOAD_TEST_DEPTH, against the
JAX package on fixtures this file writes.

``write_panoramas`` writes equirectangular captures in the transforms-json
layout (OmniBlender, Ricoh360, RaRPano); the other test files of the data
layer import it from here.

Every case loads one fixture with both packages' loaders and holds the port
to JAX through ``_assert_datasets_equal`` (test_torch_colmap.py): the same
splits and view order, c2w (np.array_equal), intrinsics, near and far,
image slots, point cloud, bounding box and applied transform. Besides, the
timestamps and the camera objects' sharing are equal, and every view's
images load to JAX's arrays within DECODE_ATOL (depth: DEPTH_ATOL). Fixtures:

* OmniBlender: train and test panoramas in two sizes (one camera each);
* Ricoh360: one transforms_train.json, split every TEST_STEP-th frame;
* RaRPano: the same with a ``points3d.ply``, timestamps over the capture;
* RTMV: a json per frame, two intrinsics (one of them only ``fx``), the
  ``cam2world`` transposed;
* NvidiaShort: ``poses_bounds.npy`` in LLFF axes with two focal lengths;
* PlenopticVideoBlender: the dynamic blob scene with MAX_TIMESTAMP 0.6;
* NeRF with LOAD_TEST_DEPTH: the blob scene with Blender depth PNGs.
"""

import json
import math
from pathlib import Path

import numpy as np
import pytest
from PIL import Image

from nerficg_torch.core.config import ConfigNode as TConfig
from nerficg_torch.core.registry import Datasets as TDatasets
from nerficg_torch.data.synthetic import (_pose_on_ring, _shade_sphere,
                                          _texture_fn, make_dynamic_scene,
                                          make_synthetic_scene,
                                          make_textured_scene)
from nerficg_torch.data.types import BasicPointCloud
from nerficg_tpu.core.config import ConfigNode as JConfig
from nerficg_tpu.core.registry import Datasets as JDatasets
from test_torch_colmap import DECODE_ATOL, _assert_datasets_equal, _dataset
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# Blender depth is 8 - 8 * red, the same float32 operations in both
# packages: equal reds give equal depths. Reds DECODE_ATOL apart give
# depths 8 x that apart, and each package's rounding of a result in
# [4, 8) adds up to half an ulp there (2^-22).
DEPTH_ATOL = 0.0 if DECODE_ATOL == 0.0 else \
    8 * DECODE_ATOL + 2 * 2.0 ** -22


# -- fixture writers (test code, not an API of the package) -----------------

def render_panorama(texture, c2w, width, height, ss=2):
    """The textured sphere (``make_textured_scene``'s, radius 0.8 at the
    origin) in an equirectangular image seen from ``c2w`` (COLMAP axes),
    black where a ray misses, box-downsampled from ``ss`` x supersampling:
    the pixel centre's azimuth and elevation are EquirectangularCamera's."""
    ys, xs = np.mgrid[0:height * ss, 0:width * ss].astype(np.float64) + 0.5
    theta = (xs / (width * ss) - 0.5) * 2.0 * math.pi
    phi = (0.5 - ys / (height * ss)) * math.pi
    d = np.stack([np.cos(phi) * np.sin(theta), -np.sin(phi),
                  np.cos(phi) * np.cos(theta)], -1) @ c2w[:3, :3].T
    rgb, _ = _shade_sphere(texture, c2w[:3, 3], d, np.zeros(3))
    return rgb.reshape(height, ss, width, ss, 3).mean(axis=(1, 3))


def write_panoramas(root, counts, size=(32, 16), second_size=None):
    """``transforms_{split}.json`` and RGB PNGs of ``render_panorama`` for
    each split in ``counts`` (split -> frames), cameras on the textured
    scene's ring (distance 4, elevations 20 and -25 degrees alternating,
    facing the origin; the test ring offset by half a step), each frame's
    ``time`` i / (count - 1). With ``second_size``, odd frames have that
    (width, height)."""
    root = Path(root)
    texture = _texture_fn(np.random.default_rng(0), (3.0, 8.0, 14.0))
    for split, count in counts.items():
        (root / split).mkdir(parents=True, exist_ok=True)
        frames = []
        for i in range(count):
            angle = 2 * math.pi * (i + (0.5 if split == 'test' else 0)) / count
            c2w = _pose_on_ring(angle, math.radians(-25.0 if i % 2 else 20.0))
            width, height = second_size if second_size and i % 2 else size
            rgb = render_panorama(texture, c2w, width, height)
            Image.fromarray((np.clip(rgb, 0, 1) * 255).astype(np.uint8)).save(
                root / split / f'r_{i}.png')
            c2w_gl = c2w.copy()
            c2w_gl[:3, 1:3] *= -1
            frames.append({'file_path': f'./{split}/r_{i}',
                           'time': i / max(count - 1, 1),
                           'transform_matrix': c2w_gl.tolist()})
        (root / f'transforms_{split}.json').write_text(
            json.dumps({'frames': frames}))
    return root


@pytest.fixture(scope='module')
def panoramas_two_sizes(tmp_path_factory):
    return write_panoramas(tmp_path_factory.mktemp('omni'),
                           {'train': 5, 'test': 2}, second_size=(24, 12))


@pytest.fixture(scope='module')
def panorama_capture(tmp_path_factory):
    return write_panoramas(tmp_path_factory.mktemp('ricoh'), {'train': 10})


@pytest.fixture(scope='module')
def rar_pano_capture(tmp_path_factory):
    root = write_panoramas(tmp_path_factory.mktemp('rarpano'), {'train': 9})
    rng = np.random.default_rng(5)
    BasicPointCloud(rng.normal(size=(300, 3)) * 0.5,
                    rng.random((300, 3))).save_ply(root / 'points3d.ply')
    return root


@pytest.fixture(scope='module')
def textured(tmp_path_factory):
    return make_textured_scene(tmp_path_factory.mktemp('textured24'),
                               image_size=24, n_train=10, n_test=2)


def _views_of(scene):
    """(RGBA image, COLMAP c2w) of every frame of a Blender-format scene."""
    from nerficg_torch.data.loaders.nerf import opengl_to_colmap
    out = []
    for split in ('train', 'test'):
        meta = json.loads((scene / f'transforms_{split}.json').read_text())
        for frame in meta['frames']:
            out.append((np.asarray(Image.open(
                scene / (frame['file_path'][2:] + '.png'))),
                opengl_to_colmap(np.asarray(frame['transform_matrix']))))
    return out, meta['camera_angle_x']


@pytest.fixture(scope='module')
def rtmv_capture(textured, tmp_path_factory):
    """A json per frame: odd frames with a second focal length; frame 0,
    whose camera the even frames share, with only ``fx`` among the
    intrinsics (the others take their defaults); ``cam2world`` the
    transposed OpenGL c2w."""
    from nerficg_torch.data.loaders.nerf import (BLENDER_TO_COLMAP_WORLD,
                                                 OPENGL_TO_COLMAP)
    root = tmp_path_factory.mktemp('rtmv')
    views, fov = _views_of(textured)
    for k, (rgba, c2w) in enumerate(views):
        Image.fromarray(rgba[..., :3]).save(root / f'{k:05d}.png')
        h, w = rgba.shape[:2]
        focal = 0.5 * w / math.tan(0.5 * fov) * (1.1 if k % 2 else 1.0)
        intrinsics = {'fx': focal} if k == 0 else \
            {'fx': focal, 'fy': focal, 'cx': w / 2 + 0.25, 'cy': h / 2 - 0.25}
        c2w_gl = BLENDER_TO_COLMAP_WORLD.T @ c2w @ OPENGL_TO_COLMAP
        (root / f'{k:05d}.json').write_text(json.dumps({'camera_data': {
            'width': w, 'height': h, 'intrinsics': intrinsics,
            'cam2world': c2w_gl.T.tolist()}}))
    return root


@pytest.fixture(scope='module')
def nvidia_capture(textured, tmp_path_factory):
    """``poses_bounds.npy`` in LLFF's [down right back | t | hwf] rows, odd
    frames with a second focal length, near/far bounds per frame."""
    root = tmp_path_factory.mktemp('nvidia')
    (root / 'images').mkdir()
    views, fov = _views_of(textured)
    rows = []
    for k, (rgba, c2w) in enumerate(views):
        Image.fromarray(rgba[..., :3]).save(root / 'images' / f'{k:03d}.png')
        h, w = rgba.shape[:2]
        focal = 0.5 * w / math.tan(0.5 * fov) * (0.9 if k % 2 else 1.0)
        pose = np.stack([c2w[:3, 1], c2w[:3, 0], -c2w[:3, 2], c2w[:3, 3],
                         np.array([h, w, focal])], axis=1)
        rows.append(np.concatenate([pose.reshape(-1),
                                    [2.5 + 0.05 * k, 5.5 - 0.03 * k]]))
    np.save(root / 'poses_bounds.npy', np.stack(rows))
    return root


@pytest.fixture(scope='module')
def dynamic_blob(tmp_path_factory):
    return make_dynamic_scene(tmp_path_factory.mktemp('dyn'), image_size=16,
                              n_train=6, n_test=3)


@pytest.fixture(scope='module')
def blob_with_depth(tmp_path_factory):
    """The blob scene with a Blender depth PNG (RGBA) for each test view but
    the last."""
    root = make_synthetic_scene(tmp_path_factory.mktemp('blob'),
                                image_size=16, n_train=4, n_test=3)
    rng = np.random.default_rng(1)
    for i in range(2):
        Image.fromarray(rng.integers(0, 256, (16, 16, 4), np.uint8)).save(
            root / 'test' / f'r_{i}_depth_0001.png')
    return root


_CASES = {
    'omni_blender': ('OmniBlender', 'panoramas_two_sizes', {}),
    'omni_blender_scaled': ('OmniBlender', 'panoramas_two_sizes',
                            {'IMAGE_SCALE_FACTOR': 0.5}),
    'ricoh360': ('Ricoh360', 'panorama_capture', {}),
    'ricoh360_step3': ('Ricoh360', 'panorama_capture', {'TEST_STEP': 3}),
    'ricoh360_given_test_split': ('Ricoh360', 'panoramas_two_sizes', {}),
    'rar_pano': ('RaRPano', 'rar_pano_capture', {}),
    'rar_pano_cube': ('RaRPano', 'rar_pano_capture',
                      {'NORMALIZE_CUBE': True, 'NORMALIZE_RECENTER': True}),
    'rtmv': ('RTMV', 'rtmv_capture', {}),
    'rtmv_scaled_step4': ('RTMV', 'rtmv_capture',
                          {'IMAGE_SCALE_FACTOR': 0.5, 'TEST_STEP': 4}),
    'nvidia_short': ('NvidiaShort', 'nvidia_capture', {}),
    'nvidia_short_scaled': ('NvidiaShort', 'nvidia_capture',
                            {'IMAGE_SCALE_FACTOR': 0.5}),
    'plenoptic_video_blender': ('PlenopticVideoBlender', 'dynamic_blob',
                                {'MAX_TIMESTAMP': 0.6}),
    'nerf_test_depth': ('NeRF', 'blob_with_depth', {'LOAD_TEST_DEPTH': True}),
    'nerf_test_depth_scaled': ('NeRF', 'blob_with_depth',
                               {'LOAD_TEST_DEPTH': True,
                                'IMAGE_SCALE_FACTOR': 0.5}),
}


def _camera_groups(dataset):
    """Each view's camera as the index of its first view: which views
    share a camera object."""
    first = {}
    return [first.setdefault(id(v.camera), i)
            for i, v in enumerate(dataset.all_views())]


@pytest.mark.parametrize('case', list(_CASES))
def test_loader_matches_jax(case, request):
    name, fixture, dataset = _CASES[case]
    path = request.getfixturevalue(fixture)
    t = TDatasets.get_dataset(_dataset(TConfig, name, path, **dataset))
    j = JDatasets.get_dataset(_dataset(JConfig, name, path, **dataset))
    _assert_datasets_equal(t, j)
    assert [v.timestamp for v in t.all_views()] == \
        [v.timestamp for v in j.all_views()]
    assert _camera_groups(t) == _camera_groups(j)
    assert type(t.all_views()[0].camera).__name__ == \
        type(j.all_views()[0].camera).__name__
    for tv, jv in zip(t.all_views(), j.all_views()):
        for slot in ('rgb', 'alpha', 'depth'):
            got, want = getattr(tv, slot), getattr(jv, slot)
            assert (got is None) == (want is None), slot
            if want is not None:
                assert got.shape == want.shape
                np.testing.assert_allclose(
                    got, want, rtol=0, err_msg=slot,
                    atol=DEPTH_ATOL if slot == 'depth' else DECODE_ATOL)


def test_fixtures_cover_what_they_claim(panoramas_two_sizes, rtmv_capture,
                                        nvidia_capture, rar_pano_capture,
                                        blob_with_depth):
    """Two cameras where the loaders key them apart; the split rules; the
    point cloud; the depth decode 8 - 8 * red."""
    def load(name, path, **kw):
        return TDatasets.get_dataset(_dataset(TConfig, name, path, **kw))

    omni = load('OmniBlender', panoramas_two_sizes)
    assert len(set(_camera_groups(omni))) == 2
    assert {(v.camera.width, v.camera.height) for v in omni.all_views()} == \
        {(32, 16), (24, 12)}
    rtmv = load('RTMV', rtmv_capture)
    assert len(set(_camera_groups(rtmv))) == 2
    assert [v.frame_idx for v in rtmv.subsets['test']] == [0, 10]
    assert len(set(_camera_groups(load('NvidiaShort', nvidia_capture)))) == 2
    ricoh = load('Ricoh360', rar_pano_capture)
    assert [v.frame_idx for v in ricoh.subsets['test']] == [0, 8]
    rar = load('RaRPano', rar_pano_capture)
    assert len(rar.point_cloud) == 300
    assert [v.timestamp for v in rar.all_views()] == \
        [i / 8 for i in (1, 2, 3, 4, 5, 6, 7, 0, 8)]
    nerf = load('NeRF', blob_with_depth, LOAD_TEST_DEPTH=True)
    test = nerf.subsets['test']
    assert [v.depth_data.exists() for v in test] == [True, True, False]
    red = np.asarray(Image.open(blob_with_depth / 'test' /
                                'r_0_depth_0001.png'))[..., :1] / 255.0
    np.testing.assert_allclose(test[0].depth, 8.0 - 8.0 * red, atol=1e-5)
