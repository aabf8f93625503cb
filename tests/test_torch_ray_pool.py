"""The port's training ray pool (``BaseDataset.precompute_rays``) against the
JAX package's, with ``RayBatch.cat`` / ``.split`` and ``View.get_rays``.

For each fixture and subset, both packages' pools have the same view order
and ``view_slices``, each view's own pixel count in ``pixel_ids``, equal
``view_ids`` and ``timestamps``, ``rgb`` / ``alpha`` / ``depth`` where
every view has them (None where JAX's is None) within DECODE_ATOL, and
origins and directions (and view directions) within RAY_ATOL. Fixtures:

* one shared camera with masks and depth (test_torch_colmap.py's
  ``rich_capture``, its images_2 beside the 2x model, with LOAD_MASKS and
  LOAD_DEPTH): JAX's pool has depth;
* a COLMAP capture with two PINHOLE cameras, alternating by image name
  (every odd view resized by 0.8), with depth for every view, and again
  with one view's depth missing;
* Ricoh360 panoramas (one EquirectangularCamera) and OmniBlender panoramas
  in two sizes (two).

The port takes the grouped path exactly when the views have more than one
camera object (``_grouped_rays``, counted here).
"""

import numpy as np
import pytest
import torch

from nerficg_torch.core.config import ConfigNode as TConfig
from nerficg_torch.core.registry import Datasets as TDatasets
from nerficg_torch.data.base import BaseDataset
from nerficg_torch.data.synthetic import make_textured_scene
from nerficg_torch.data.types import RayBatch as TRayBatch
from nerficg_tpu.core.config import ConfigNode as JConfig
from nerficg_tpu.core.registry import Datasets as JDatasets
from nerficg_tpu.data.types import RayBatch as JRayBatch
from test_torch_colmap import (DECODE_ATOL, _dataset, rich_capture,  # noqa: F401
                               scene, write_capture)
from test_torch_data_loaders import write_panoramas
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# float32 rotations of unit directions: einsum against matmul, and the two
# libraries' normalisations, differ in the last bits.
RAY_ATOL = 1e-6

_IMAGES = ('rgb', 'alpha', 'depth')
_RAYS = ('origins', 'directions', 'view_directions')
_EXACT = ('timestamps', 'pixel_ids', 'view_ids')


@pytest.fixture(scope='module')
def two_camera_capture(tmp_path_factory):
    """A 40x40 textured scene's 8 views as a COLMAP capture: even views on
    a 40x40 PINHOLE camera, odd ones resized to 32x32 on a second camera
    with 0.8 x its intrinsics; a depth map per view."""
    scene40 = make_textured_scene(tmp_path_factory.mktemp('textured40'),
                                  image_size=40, n_train=6, n_test=2)
    root = write_capture(tmp_path_factory.mktemp('two_cameras'), scene40,
                         second_scale=0.8)
    rng = np.random.default_rng(4)
    (root / 'depth').mkdir()
    for k in range(8):
        size = 32 if k % 2 else 40
        np.save(root / 'depth' / f'{k:03d}.npy',
                rng.random((size, size)).astype(np.float32) * 4)
    return root


@pytest.fixture(scope='module')
def two_camera_capture_one_depth_missing(two_camera_capture,
                                         tmp_path_factory):
    import shutil
    root = tmp_path_factory.mktemp('two_cameras_gap') / 'capture'
    shutil.copytree(two_camera_capture, root)
    (root / 'depth' / '004.npy').unlink()        # a training view's
    return root


@pytest.fixture(scope='module')
def panoramas(tmp_path_factory):
    return write_panoramas(tmp_path_factory.mktemp('ricoh'), {'train': 10})


@pytest.fixture(scope='module')
def panoramas_two_sizes(tmp_path_factory):
    return write_panoramas(tmp_path_factory.mktemp('omni'),
                           {'train': 5, 'test': 3}, second_size=(24, 12))


_CASES = {
    'shared_camera_depth': ('MipNeRF360', 'rich_capture',
                            {'DOWNSAMPLE': 2, 'LOAD_MASKS': True,
                             'LOAD_DEPTH': True, 'NORMALIZE_CUBE': True}, 1),
    'two_cameras_depth': ('Colmap', 'two_camera_capture',
                          {'LOAD_DEPTH': True, 'TEST_STEP': 3}, 2),
    'two_cameras_depth_gap': ('Colmap', 'two_camera_capture_one_depth_missing',
                              {'LOAD_DEPTH': True, 'TEST_STEP': 3}, 2),
    'two_cameras_scaled': ('Colmap', 'two_camera_capture',
                           {'IMAGE_SCALE_FACTOR': 0.5, 'TEST_STEP': 0}, 2),
    'panoramas': ('Ricoh360', 'panoramas', {}, 1),
    'panoramas_two_sizes': ('OmniBlender', 'panoramas_two_sizes', {}, 2),
}


@pytest.fixture
def grouped_calls(monkeypatch):
    """The number of ``_grouped_rays`` calls and the camera groups each
    was given."""
    calls = []
    original = BaseDataset._grouped_rays.__func__

    def counted(cls, views, groups, device, *rest):
        calls.append(len(groups))
        return original(cls, views, groups, device, *rest)
    monkeypatch.setattr(BaseDataset, '_grouped_rays', classmethod(counted))
    return calls


def assert_pools_equal(got, want, image_atol=DECODE_ATOL):
    """A port RayCollection against a JAX one."""
    assert got.view_slices == [tuple(s) for s in want.view_slices]
    for name in _RAYS + _EXACT + _IMAGES:
        g, w = getattr(got.rays, name), getattr(want.rays, name)
        assert (g is None) == (w is None), name
        if w is None:
            continue
        g, w = g.cpu().numpy(), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name in _EXACT:
            assert np.array_equal(g, w), name
        else:
            np.testing.assert_allclose(g, w, rtol=0, err_msg=name,
                                       atol=RAY_ATOL if name in _RAYS
                                       else image_atol)


@pytest.mark.parametrize('case', list(_CASES))
def test_pool_matches_jax(case, request, grouped_calls):
    name, fixture, dataset, cameras = _CASES[case]
    path = request.getfixturevalue(fixture)
    t = TDatasets.get_dataset(_dataset(TConfig, name, path, **dataset))
    j = JDatasets.get_dataset(_dataset(JConfig, name, path, **dataset))
    for subset in ('train', 'test'):
        if not j.subsets[subset]:
            continue
        views = t.subsets[subset]
        grouped_calls.clear()
        got = t.precompute_rays(subset, device='cpu')
        n_cameras = len({id(v.camera) for v in views})
        assert grouped_calls == ([n_cameras] if n_cameras > 1 else [])
        assert_pools_equal(got, j.precompute_rays(subset))
        counts = [v.camera.width * v.camera.height for v in views]
        ids = got.rays.pixel_ids[:, 0].numpy()
        assert np.array_equal(ids, np.concatenate([np.arange(n)
                                                   for n in counts]))
        for k, view in enumerate(views):
            start, stop = got.view_slices[k]
            assert np.all(got.rays.view_ids[start:stop].numpy() ==
                          view.global_frame_idx)
    train = t.subsets['train']
    assert len({id(v.camera) for v in train}) == cameras
    if case.startswith('two_cameras'):
        # the cameras alternate by view, so view order is not group order
        cams = [id(v.camera) for v in train]
        assert cams != sorted(cams, key=cams.index)
    has_depth = case in ('shared_camera_depth', 'two_cameras_depth')
    assert (t.precompute_rays('train').rays.depth is not None) == has_depth


def test_get_rays_with_depth_matches_jax(rich_capture):  # noqa: F811
    cfg = {'DOWNSAMPLE': 2, 'LOAD_MASKS': True, 'LOAD_DEPTH': True}
    t = TDatasets.get_dataset(_dataset(TConfig, 'MipNeRF360', rich_capture,
                                       **cfg))
    j = JDatasets.get_dataset(_dataset(JConfig, 'MipNeRF360', rich_capture,
                                       **cfg))
    for tv, jv in zip(t.subsets['test'], j.subsets['test']):
        got, want = tv.get_rays(device='cpu'), jv.get_rays()
        assert got.depth is not None
        for name in _RAYS + _EXACT + _IMAGES:
            g, w = getattr(got, name).numpy(), np.asarray(getattr(want, name))
            assert g.dtype == w.dtype and g.shape == w.shape, name
            np.testing.assert_allclose(g, w, rtol=0, err_msg=name,
                                       atol=RAY_ATOL if name in _RAYS
                                       else DECODE_ATOL)
        assert tv.get_rays(with_images=False, device='cpu').depth is None


def _batches(seed):
    """Two port batches and JAX's of the same values, the second without
    depth."""
    rng = np.random.default_rng(seed)
    out = []
    for n, with_depth in ((7, True), (5, False)):
        fields = {'origins': rng.normal(size=(n, 3)),
                  'directions': rng.normal(size=(n, 3)),
                  'rgb': rng.random((n, 3)),
                  'depth': rng.random((n, 1)) if with_depth else None,
                  'timestamps': rng.random((n, 1))}
        fields = {k: None if v is None else v.astype(np.float32)
                  for k, v in fields.items()}
        fields['pixel_ids'] = np.arange(n, dtype=np.int32)[:, None]
        out.append(fields)
    return out


def test_raybatch_cat_and_split_match_jax():
    import jax.numpy as jnp
    fields = _batches(0)
    t = [TRayBatch(**{k: None if v is None else torch.from_numpy(v)
                      for k, v in f.items()}) for f in fields]
    j = [JRayBatch(**{k: None if v is None else jnp.asarray(v)
                      for k, v in f.items()}) for f in fields]
    for got, want in ((TRayBatch.cat(t), JRayBatch.cat(j)),
                      (TRayBatch.cat(t[:1]), JRayBatch.cat(j[:1]))):
        assert len(got) == len(want)
        for name in ('origins', 'directions', 'view_directions', 'rgb',
                     'alpha', 'depth', 'timestamps', 'pixel_ids', 'view_ids'):
            g, w = getattr(got, name), getattr(want, name)
            assert (g is None) == (w is None), name
            if w is not None:
                assert np.array_equal(g.numpy(), np.asarray(w)), name
    whole_t, whole_j = TRayBatch.cat(t), JRayBatch.cat(j)
    for size in (1, 4, 12, 20):
        got, want = whole_t.split(size), whole_j.split(size)
        assert [len(b) for b in got] == [len(b) for b in want]
        for g, w in zip(got, want):
            assert np.array_equal(g.origins.numpy(), np.asarray(w.origins))
            assert np.array_equal(g.pixel_ids.numpy(),
                                  np.asarray(w.pixel_ids))


def test_view_slots_and_projection_match_jax(tmp_path):
    """The seven image slots load what JAX's load (a flow through
    ``read_flow``; flow_bwd left empty), prefetch keeps a decoded image until
    ``release_images``, and ``world_to_cam`` / ``project_points`` equal
    JAX's on a perspective and an equirectangular camera."""
    from PIL import Image

    from nerficg_torch.cameras.equirectangular import EquirectangularCamera
    from nerficg_torch.cameras.perspective import PerspectiveCamera
    from nerficg_torch.data import io as tio
    from nerficg_torch.data.types import ImageData as TImageData
    from nerficg_torch.data.types import View as TView
    from nerficg_tpu.cameras.equirectangular import \
        EquirectangularCamera as JEquirectangular
    from nerficg_tpu.cameras.perspective import \
        PerspectiveCamera as JPerspective
    from nerficg_tpu.data import io as jio
    from nerficg_tpu.data.types import ImageData as JImageData
    from nerficg_tpu.data.types import View as JView

    rng = np.random.default_rng(6)
    image = tmp_path / 'seg.png'
    Image.fromarray(rng.integers(0, 256, (6, 8, 3), np.uint8)).save(image)
    tio.write_flow(rng.normal(size=(6, 8, 2)).astype(np.float32),
                   tmp_path / 'fwd.flo')
    slots = {'segmentation': {'path': image, 'channels': slice(0, 1)},
             'flow_fwd': {'path': tmp_path / 'fwd.flo'},
             'misc': {'data': rng.random((6, 8, 1)).astype(np.float32)}}
    loaders = {'flow_fwd': (tio.read_flow, jio.read_flow)}
    q, _ = np.linalg.qr(rng.normal(size=(3, 3)))
    c2w = np.concatenate([q, rng.normal(size=(3, 1))], 1)
    points = rng.normal(size=(50, 3)) * 3
    for t_cam, j_cam in ((PerspectiveCamera(8, 6, 7.0, 7.5, 4.2, 2.9),
                          JPerspective(8, 6, 7.0, 7.5, 4.2, 2.9)),
                         (EquirectangularCamera(8, 6), JEquirectangular(8, 6))):
        views = []
        for image_cls, view_cls, cam, k in ((TImageData, TView, t_cam, 0),
                                            (JImageData, JView, j_cam, 1)):
            kwargs = {}
            for slot, spec in slots.items():
                load = loaders.get(slot)
                kwargs[slot] = image_cls(
                    **spec, load_fn=None if load is None else
                    (lambda path, scale, fn=load[k]: fn(path)))
            views.append(view_cls(cam, c2w, **kwargs))
        tv, jv = views
        assert tv.IMAGE_SLOTS == jv.IMAGE_SLOTS
        for slot in tv.IMAGE_SLOTS:
            got, want = getattr(tv, slot), getattr(jv, slot)
            assert (got is None) == (want is None), slot
            if want is not None:
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=DECODE_ATOL, err_msg=slot)
        assert np.array_equal(tv.world_to_cam(points),
                              jv.world_to_cam(points))
        assert np.array_equal(tv.project_points(points),
                              jv.project_points(points))
    tv.prefetch()
    assert tv.segmentation_data._cache is not None
    image.unlink()                        # served from memory now
    assert tv.segmentation.shape == (6, 8, 1)
    tv.release_images()
    assert tv.segmentation_data._cache is None
    assert not tv.segmentation_data.exists()
