"""The rest of the port's ``optim/`` against the JAX package on the CPU.

* Every loss and its gradient against ``jax.grad`` within ATOL: ``mse``
  and ``l1`` with and without a mask, ``charbonnier``, ``dssim``,
  ``background_entropy``, ``depth_smoothness``, ``magnitude`` (orders 1
  and 2), ``robust_loss`` on all of its branches (alpha 2, 0, -inf and the
  general form); ``ssim(return_map=True)``'s map.
* ``scale_gradients_by_distance``: the identity forward and the backward
  against ``jax.vjp`` for (N, C) values under (N,) distances and (N,)
  values under (N,) distances.
* The seven samplers: the same index sequence as JAX's for seeds 0 and 7
  on the blob scene (``make_synthetic_scene``); ``RayPoolSampler``'s
  batches against the same ids of JAX's ``RayCollection``.
* PPISP: ``apply_ppisp`` for random parameters within ATOL; the camera
  and frame bookkeeping, extra state and report text equal to JAX's on
  tests/test_torch_ray_pool.py's two-camera COLMAP capture; five optimiser
  steps from the same gradients against optax's Adam under
  ``cosine_decay_schedule`` within PPISP_RTOL.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.core.config import ConfigNode as TConfig
from nerficg_torch.core.errors import SamplerError
from nerficg_torch.core.registry import Datasets as TDatasets
from nerficg_torch.data.synthetic import make_synthetic_scene
from nerficg_torch.optim import gradient_scaling as tgs
from nerficg_torch.optim import losses as tlosses
from nerficg_torch.optim import metrics as tmetrics
from nerficg_torch.optim import ppisp as tppisp
from nerficg_torch.optim import samplers as tsamplers
from nerficg_tpu.core.config import ConfigNode as JConfig
from nerficg_tpu.core.registry import Datasets as JDatasets
from nerficg_tpu.optim import gradient_scaling as jgs
from nerficg_tpu.optim import losses as jlosses
from nerficg_tpu.optim import metrics as jmetrics
from nerficg_tpu.optim import ppisp as jppisp
from nerficg_tpu.optim import samplers as jsamplers
from test_torch_colmap import DECODE_ATOL, _dataset
from test_torch_ray_pool import RAY_ATOL, two_camera_capture  # noqa: F401
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ATOL = 1e-6
# One SSIM window divides by var_p + var_t + c2, each variance a float32
# difference of two means that the libraries sum in another order; the
# map's mean holds ATOL.
SSIM_MAP_ATOL = 1e-5
# Adam's division by sqrt(v) + eps in another order, five steps; a value
# crossing zero holds PPISP_RTOL of the learning rate.
PPISP_RTOL = 1e-5
PPISP_LR = 1e-2


def _arrays(*shapes, seed=0, low=0.0, high=1.0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(low, high, shape).astype(np.float32)
            for shape in shapes]


def _check_loss(t_fn, j_fn, arrays, grad_args=(0,)):
    """The value and the gradients in ``grad_args`` of both packages."""
    want = j_fn(*[jnp.asarray(a) for a in arrays])
    want_grads = jax.grad(lambda *xs: j_fn(*xs), argnums=grad_args)(
        *[jnp.asarray(a) for a in arrays])
    tensors = [torch.from_numpy(a).requires_grad_(i in grad_args)
               for i, a in enumerate(arrays)]
    got = t_fn(*tensors)
    got.backward()
    assert got.item() == pytest.approx(float(want), abs=ATOL)
    for i, g in zip(grad_args, want_grads):
        np.testing.assert_allclose(tensors[i].grad.numpy(), np.asarray(g),
                                   rtol=0, atol=ATOL)


_LOSSES = {
    'mse': (lambda p, t: tlosses.mse(p, t), lambda p, t: jlosses.mse(p, t),
            ((16, 3), (16, 3))),
    'mse_mask': (lambda p, t, m: tlosses.mse(p, t, m),
                 lambda p, t, m: jlosses.mse(p, t, m),
                 ((16, 3), (16, 3), (16, 1))),
    'l1': (lambda p, t: tlosses.l1(p, t), lambda p, t: jlosses.l1(p, t),
           ((16, 3), (16, 3))),
    'l1_mask': (lambda p, t, m: tlosses.l1(p, t, mask=m),
                lambda p, t, m: jlosses.l1(p, t, mask=m),
                ((16, 3), (16, 3), (16, 1))),
    'charbonnier': (tlosses.charbonnier, jlosses.charbonnier,
                    ((16, 3), (16, 3))),
    'dssim': (tlosses.dssim, jlosses.dssim, ((19, 23, 3), (19, 23, 3))),
    'background_entropy': (tlosses.background_entropy,
                           jlosses.background_entropy, ((64, 1),)),
    'depth_smoothness': (tlosses.depth_smoothness, jlosses.depth_smoothness,
                         ((13, 17, 1), (13, 17, 3))),
    'magnitude_1': (lambda v: tlosses.magnitude(v, 1),
                    lambda v: jlosses.magnitude(v, 1), ((32, 4),)),
    'magnitude_2': (lambda v: tlosses.magnitude(v, 2),
                    lambda v: jlosses.magnitude(v, 2), ((32, 4),)),
}


@pytest.mark.parametrize('name', list(_LOSSES))
def test_loss_and_gradient_match_jax(name):
    t_fn, j_fn, shapes = _LOSSES[name]
    arrays = _arrays(*shapes, seed=len(name))
    if name.endswith('_mask'):
        arrays[-1] = (arrays[-1] > 0.4).astype(np.float32)
    if name.startswith('magnitude'):
        arrays[0] = arrays[0] * 2 - 1
    _check_loss(t_fn, j_fn, arrays,
                grad_args=tuple(range(len(shapes) -
                                      name.endswith('_mask'))))


@pytest.mark.parametrize('alpha', [2.0, 0.0, -math.inf, 1.0, -2.0, 0.5])
@pytest.mark.parametrize('scale', [1.0, 0.3])
def test_robust_loss_matches_jax(alpha, scale):
    x, = _arrays((64, 3), seed=3, low=-2.0, high=2.0)
    _check_loss(lambda v: tlosses.robust_loss(v, alpha, scale),
                lambda v: jlosses.robust_loss(v, alpha, scale), [x])


def test_ssim_map_matches_jax():
    pred, target = _arrays((21, 26, 3), (21, 26, 3), seed=5)
    got = tmetrics.ssim(torch.from_numpy(pred), torch.from_numpy(target),
                        return_map=True)
    want = jmetrics.ssim(jnp.asarray(pred), jnp.asarray(target),
                         return_map=True)
    assert got.shape == want.shape == (11, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=SSIM_MAP_ATOL)
    assert float(got.mean()) == pytest.approx(
        float(tmetrics.ssim(torch.from_numpy(pred), torch.from_numpy(target))),
        abs=ATOL)


# -- gradient scaling -----------------------------------------------------

@pytest.mark.parametrize('value_shape', [(50, 3), (50,)])
def test_scale_gradients_by_distance_matches_jax(value_shape):
    values, cotangent = _arrays(value_shape, value_shape, seed=9,
                                low=-1.0, high=1.0)
    distances, = _arrays((50,), seed=10, low=0.0, high=2.0)
    out, vjp = jax.vjp(jgs.scale_gradients_by_distance, jnp.asarray(values),
                       jnp.asarray(distances))
    want_grad, _ = vjp(jnp.asarray(cotangent))
    v = torch.from_numpy(values).requires_grad_(True)
    d = torch.from_numpy(distances).requires_grad_(True)
    got = tgs.scale_gradients_by_distance(v, d)
    assert torch.equal(got, v)
    got.backward(torch.from_numpy(cotangent))
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(want_grad),
                               rtol=0, atol=ATOL)
    assert d.grad is None
    # Beyond distance 1 the gradient passes unchanged.
    far = distances >= 1.0
    assert far.any() and (~far).any()
    np.testing.assert_array_equal(v.grad.numpy()[far], cotangent[far])


# -- samplers ----------------------------------------------------------------

@pytest.fixture(scope='module')
def blob_datasets(tmp_path_factory):
    root = make_synthetic_scene(tmp_path_factory.mktemp('blob'),
                                image_size=12, n_train=6, n_test=2)
    cfg = {'GLOBAL': {'METHOD_TYPE': 'NeRF', 'DATASET_TYPE': 'NeRF'},
           'DATASET': {'PATH': str(root)}}
    return (TDatasets.get_dataset(TConfig(cfg)),
            JDatasets.get_dataset(JConfig(cfg)))


def _draws(make, steps):
    """``steps`` results of a sampler; a callable step is called with it."""
    sampler = make()
    out = []
    for step in steps:
        out.append(step(sampler) if callable(step) else sampler.get())
    return out


def _same(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if isinstance(w, tuple):
            assert g[0] == w[0]
            assert (g[1] is None) == (w[1] is None)
            if w[1] is not None:
                np.testing.assert_array_equal(g[1], w[1])
        elif isinstance(w, np.ndarray):
            np.testing.assert_array_equal(g, w)
        else:
            assert g == w


def _grow(sampler):
    sampler.grow(2)
    return sampler.get()


def _reweight(sampler):
    sampler.update_pdf(np.arange(sampler.num_elements) ** 2 + 0.5)
    return sampler.get()


@pytest.mark.parametrize('seed', [0, 7])
@pytest.mark.parametrize('name', [
    'SequentialSampler', 'RandomSequentialSampler',
    'IncrementalSequentialSampler', 'MultinomialImageSampler'])
def test_element_samplers_match_jax(name, seed):
    steps = [None] * 9 + [_grow] + [None] * 5 + (
        [_reweight] + [None] * 10 if name == 'MultinomialImageSampler'
        else [])
    if name != 'IncrementalSequentialSampler':
        steps = [s if s is not _grow else None for s in steps]
    got = _draws(lambda: getattr(tsamplers, name)(6, seed), steps)
    want = _draws(lambda: getattr(jsamplers, name)(6, seed), steps)
    _same(got, want)
    assert len(set(got)) > 1


@pytest.mark.parametrize('seed', [0, 7])
@pytest.mark.parametrize('kind', ['random', 'sequential', 'full_image',
                                  'incremental'])
def test_dataset_samplers_match_jax(blob_datasets, kind, seed):
    t_data, j_data = blob_datasets

    def make(module, data):
        if kind == 'incremental':
            return module.IncrementalDatasetSampler(data, 64, seed)
        return module.DatasetSampler(
            data, None if kind == 'full_image' else 64, seed,
            random_views=kind != 'sequential')

    steps = [None] * 8 + ([_grow] + [None] * 6 if kind == 'incremental'
                          else [])
    _same(_draws(lambda: make(tsamplers, t_data), steps),
          _draws(lambda: make(jsamplers, j_data), steps))
    t_views = [make(tsamplers, t_data).get_view() for _ in range(3)]
    j_views = [make(jsamplers, j_data).get_view() for _ in range(3)]
    assert [v.global_frame_idx for v in t_views] == \
        [v.global_frame_idx for v in j_views]


@pytest.mark.parametrize('seed', [0, 7])
def test_ray_pool_sampler_matches_jax(blob_datasets, seed):
    t_data, j_data = blob_datasets
    t_sampler = tsamplers.RayPoolSampler(t_data, seed, device='cpu')
    j_sampler = jsamplers.RayPoolSampler(j_data, seed)
    assert t_sampler.num_rays_total == j_sampler.num_rays_total == 6 * 144
    for n in (32, 100):
        np.testing.assert_array_equal(t_sampler.get_ids(n),
                                      j_sampler.get_ids(n))
    got, want = t_sampler.get(64), j_sampler.get(64)
    for name in ('origins', 'directions', 'rgb', 'alpha', 'pixel_ids',
                 'view_ids'):
        np.testing.assert_allclose(
            getattr(got, name).numpy(), np.asarray(getattr(want, name)),
            rtol=0, err_msg=name,
            atol={'origins': RAY_ATOL, 'directions': RAY_ATOL,
                  'rgb': DECODE_ATOL, 'alpha': DECODE_ATOL}.get(name, 0))


def test_sampler_refuses_no_elements():
    with pytest.raises(SamplerError):
        tsamplers.SequentialSampler(0)


# -- PPISP --------------------------------------------------------------------

def _random_params(n_cameras, n_frames, seed=0):
    rng = np.random.default_rng(seed)
    return {
        'log_exposure': rng.normal(0, 0.3, (n_frames,)),
        'wb_gains': rng.normal(0, 0.2, (n_frames, 2)),
        'ccm': np.eye(3)[None] + rng.normal(0, 0.1, (n_cameras, 3, 3)),
        'vignette': rng.normal(0, 0.2, (n_cameras, 2)),
        'log_gamma': rng.normal(0, 0.2, (n_cameras,)),
    }


@pytest.mark.parametrize('shape', [(6, 8), (9, 5)])
def test_apply_ppisp_matches_jax(shape):
    params = {k: v.astype(np.float32) for k, v in
              _random_params(2, 3, seed=shape[0]).items()}
    rgb, = _arrays(shape + (3,), seed=4, low=0.05, high=0.95)
    for cam, frame in ((0, 0), (1, 2), (1, 1)):
        want = jppisp.apply_ppisp({k: jnp.asarray(v) for k, v in
                                   params.items()}, jnp.asarray(rgb), cam,
                                  frame)
        got = tppisp.apply_ppisp({k: torch.from_numpy(v) for k, v in
                                  params.items()}, torch.from_numpy(rgb),
                                 cam, frame)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=ATOL)


@pytest.fixture(scope='module')
def two_camera_views(two_camera_capture):  # noqa: F811
    t = TDatasets.get_dataset(_dataset(TConfig, 'Colmap', two_camera_capture,
                                       TEST_STEP=3))
    j = JDatasets.get_dataset(_dataset(JConfig, 'Colmap', two_camera_capture,
                                       TEST_STEP=3))
    return t.all_views(), j.all_views()


def test_ppisp_bookkeeping_and_report_match_jax(two_camera_views, tmp_path):
    t_views, j_views = two_camera_views
    assert len({v.camera_index for v in t_views}) == 2
    t, j = tppisp.PPISP(), jppisp.PPISP()
    t.initialize(t_views, n_iterations=10)
    j.initialize(j_views, n_iterations=10)
    assert t.get_extra_state() == j.get_extra_state()
    assert t.frames_per_camera == [4, 4]
    # A camera's frames are contiguous: sorted by camera.
    assert sorted(t.known_global_frame_indices.values()) == list(range(8))
    # The report of identity parameters, then of the same random ones.
    for seed in (None, 3):
        if seed is not None:
            params = _random_params(2, 8, seed)
            j.params = {k: jnp.asarray(v, jnp.float32)
                        for k, v in params.items()}
            t.params = {k: torch.tensor(v, dtype=torch.float32)
                        for k, v in params.items()}
        t.create_report(tmp_path / 'port')
        j.create_report(tmp_path / 'jax')
        got = (tmp_path / 'port' / 'ppisp_report' / 'report.txt').read_text()
        assert got == \
            (tmp_path / 'jax' / 'ppisp_report' / 'report.txt').read_text()
    fresh = tppisp.PPISPWrapper()
    fresh.set_extra_state(t.get_extra_state())
    assert fresh.get_extra_state() == j.get_extra_state()
    # Views render through their camera's and frame's parameters, CHW too.
    rgb, = _arrays((3, 6, 8), seed=8, low=0.1, high=0.9)
    for tv, jv in zip(t_views[:3], j_views[:3]):
        np.testing.assert_allclose(t(torch.from_numpy(rgb), tv).numpy(),
                                   np.asarray(j(jnp.asarray(rgb), jv)),
                                   rtol=0, atol=ATOL)


def test_ppisp_adam_steps_match_optax():
    class View:
        def __init__(self, camera_index, global_frame_idx):
            self.camera_index = camera_index
            self.global_frame_idx = global_frame_idx

    views = [View(0, 0), View(1, 1), View(0, 2), View(1, 3), View(0, 4)]
    t = tppisp.PPISP(learning_rate=PPISP_LR)
    j = jppisp.PPISP(learning_rate=PPISP_LR)
    t.initialize(views, n_iterations=4)     # past the schedule's end at 5
    j.initialize(views, n_iterations=4)
    rng = np.random.default_rng(11)
    for _ in range(5):
        grads = {k: rng.standard_normal(np.shape(v)).astype(np.float32)
                 for k, v in j.params.items()}
        j.step({k: jnp.asarray(v) for k, v in grads.items()})
        t.step({k: torch.from_numpy(v) for k, v in grads.items()})
    for name, want in j.params.items():
        np.testing.assert_allclose(t.params[name].detach().numpy(),
                                   np.asarray(want), rtol=PPISP_RTOL,
                                   atol=PPISP_RTOL * PPISP_LR, err_msg=name)
    assert not np.allclose(np.asarray(j.params['log_gamma']), 0.0)
