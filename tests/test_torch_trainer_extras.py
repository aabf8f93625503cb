"""The port's trainer extras against the JAX package on the CPU.

* ``ColorMap.apply`` (interpolated and nearest-entry), ``apply_color_map``
  with a mask (and an empty one), ``visualize_error`` (l1, l2) and the
  error maps ``render_subset(visualize_errors=True)`` writes: equal to the
  JAX package's within 1e-6 on the same inputs.
* ``View.to_simple`` and ``catch`` as in the JAX package.
* ``TRAINING.TIMING.PROFILE``: a window of iterations traced by
  ``torch.profiler`` into ``<output_dir>/profile/trace.json``, with the
  program's spans, and the window's counters in ``profile/counters.json``.
* ``TRAINING.WANDB``: a fake ``wandb`` module, and both packages' 3DGS
  trainers on the same short run with losses, image grids, sweep metrics
  and the primitives panel on: the same keys at the same steps; every
  scalar within the one-step test's 1e-5 relative, images within
  IMAGE_PSNR_DB, the Gaussians' means within POINT_ATOL. Without wandb
  the run warns and goes on.
"""

import json
import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.core import errors as terrors
from nerficg_torch.core.config import ConfigNode as TConfig
from nerficg_torch.core.logging import Logger as TLogger
from nerficg_torch.core.registry import Datasets as TDatasets
from nerficg_torch.core.registry import Methods as TMethods
from nerficg_torch.core.setup import Directories as TDirectories
from nerficg_torch.data.synthetic import make_textured_scene
from nerficg_torch.methods.base import renderer as trenderer
from nerficg_torch.visual import ColorMap as TColorMap
from nerficg_torch.visual import apply_color_map as t_apply
from nerficg_tpu.core import errors as jerrors
from nerficg_tpu.core.config import ConfigNode as JConfig
from nerficg_tpu.core.registry import Datasets as JDatasets
from nerficg_tpu.core.registry import Methods as JMethods
from nerficg_tpu.core.setup import Directories as JDirectories
from nerficg_tpu.methods.base import renderer as jrenderer
from nerficg_tpu.visual import ColorMap as JColorMap
from nerficg_tpu.visual import apply_color_map as j_apply
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TLogger.set_level('SILENT')

ATOL = 1e-6
# The one-step test's loss tolerance (tests/test_torch_gaussian_splatting.py
# test_one_training_step_matches_jax), for every logged scalar.
SCALAR_RTOL = 1e-5
# The render grids go through the lossy packed serving path in both
# packages; the checkpoint-swap test's bar.
IMAGE_PSNR_DB = 45.0
# The means' panel (positions, colours x 255): after Adam's first steps a
# parameter whose gradient is round-off may differ by up to 2 lr
# (test_one_training_step_matches_jax), 1.6e-4 x the scene's extent here.
POINT_ATOL = 1e-4


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    return make_textured_scene(tmp_path_factory.mktemp('extras_scene'),
                               image_size=32, n_train=8, n_test=2)


# -- colormaps ---------------------------------------------------------------

@pytest.mark.parametrize('name', ['TURBO', 'INFERNO', 'VIRIDIS'])
@pytest.mark.parametrize('interpolate', [True, False])
def test_color_map_apply(name, interpolate):
    values = np.random.default_rng(0).uniform(-0.2, 1.2, (17, 23)).astype(
        np.float32)
    values[0, :4] = [0.0, 1.0, 0.5 / 255, 254.5 / 255]
    got = TColorMap.apply(torch.from_numpy(values), name, interpolate)
    want = JColorMap.apply(jnp.asarray(values), name, interpolate)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=ATOL)
    np.testing.assert_array_equal(TColorMap.get(name), JColorMap.get(name))
    assert TColorMap.options == JColorMap.options


@pytest.mark.parametrize('case', ['mask', 'empty_mask', 'mask_and_range',
                                  'no_mask_channel'])
def test_apply_color_map_mask(case):
    rng = np.random.default_rng(1)
    values = rng.normal(size=(19, 21, 1)).astype(np.float32)
    mask = rng.random((19, 21)) > 0.4
    kwargs = {}
    if case == 'empty_mask':
        mask[:] = False
    if case == 'mask_and_range':
        kwargs = {'min_value': -0.5, 'max_value': 1.5}
    if case == 'no_mask_channel':
        mask = None
    with np.errstate(all='ignore'):
        want = np.asarray(j_apply(
            jnp.asarray(values), 'TURBO',
            mask=None if mask is None else jnp.asarray(mask), **kwargs))
    got = t_apply(torch.from_numpy(values), 'TURBO',
                  mask=None if mask is None else torch.from_numpy(mask),
                  **kwargs).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if mask is not None:
        assert not got[~mask].any()


@pytest.mark.parametrize('mode', ['l1', 'l2'])
def test_visualize_error(mode):
    rng = np.random.default_rng(2)
    pred = rng.random((13, 11, 3)).astype(np.float32)
    gt = rng.random((13, 11, 4)).astype(np.float32)
    got = trenderer.BaseRenderer.visualize_error(pred, gt, mode)
    want = jrenderer.BaseRenderer.visualize_error(pred, gt, mode)
    assert got.shape == (13, 11, 3)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=ATOL)


class _Fixed:
    """A model stand-in for the renderers below."""
    device = torch.device('cpu')


def _fixed_renderer(base, to_array):
    """A renderer of ``base`` whose every view renders the same image."""
    image = np.random.default_rng(3).random((32, 32, 3)).astype(np.float32)

    class Fixed(base):
        MODEL_CLASS = _Fixed

        def render_image(self, view, *args, **kwargs):
            return {'rgb': to_array(image)}

    return Fixed(None, _Fixed())


def test_render_subset_visualize_errors(scene, tmp_path, monkeypatch):
    """The error maps of both packages' ``render_subset`` on the same
    renders and ground truth, as saved (captured before PNG rounding)."""
    saved = {'port': {}, 'jax': {}}
    for side, module in (('port', trenderer), ('jax', jrenderer)):
        monkeypatch.setattr(module, 'save_image',
                            lambda img, path, side=side: saved[side].__setitem__(
                                (path.parent.name, path.name),
                                np.asarray(img)))
    cfg = {'GLOBAL': {'METHOD_TYPE': 'NeRF', 'DATASET_TYPE': 'NeRF'},
           'DATASET': {'PATH': str(scene)}}
    _fixed_renderer(trenderer.BaseRenderer, torch.from_numpy).render_subset(
        TDatasets.get_dataset(TConfig(cfg)), 'test', tmp_path / 'port',
        compute_metrics=False, visualize_errors=True)
    _fixed_renderer(jrenderer.BaseRenderer, jnp.asarray).render_subset(
        JDatasets.get_dataset(JConfig(cfg)), 'test', tmp_path / 'jax',
        compute_metrics=False, visualize_errors=True)
    errors = sorted(k for k in saved['port'] if k[0] == 'error')
    assert errors == [('error', '00000.png'), ('error', '00001.png')]
    assert set(saved['port']) == set(saved['jax'])
    for key in errors:
        assert saved['port'][key].std() > 0.01
        np.testing.assert_allclose(saved['port'][key], saved['jax'][key],
                                   rtol=0, atol=ATOL)


# -- View.to_simple, catch ---------------------------------------------------

def test_view_to_simple(scene):
    cfg = {'GLOBAL': {'METHOD_TYPE': 'NeRF', 'DATASET_TYPE': 'NeRF'},
           'DATASET': {'PATH': str(scene)}}
    t_view = TDatasets.get_dataset(TConfig(cfg)).subsets['train'][5]
    j_view = JDatasets.get_dataset(JConfig(cfg)).subsets['train'][5]
    got, want = t_view.to_simple(), j_view.to_simple()
    np.testing.assert_array_equal(got.c2w, want.c2w)
    assert got.c2w is not t_view.c2w and got.camera is t_view.camera
    for name in ('camera_index', 'frame_idx', 'global_frame_idx',
                 'timestamp'):
        assert getattr(got, name) == getattr(want, name), name
    assert t_view.rgb_data.exists()
    assert not any(getattr(got, f'{slot}_data').exists()
                   for slot in got.IMAGE_SLOTS)


def test_catch_logs_once_and_cleans_up(monkeypatch):
    """As the JAX package's: the exception is swallowed, its traceback
    logged once however often it repeats, and ``cleanup`` called."""
    for errors in (terrors, jerrors):
        logged, cleaned = [], []
        monkeypatch.setattr(errors.Logger, 'error',
                            staticmethod(logged.append))

        @errors.catch(cleanup=lambda x: cleaned.append(x))
        def fails(x):
            raise ValueError('boom')

        assert [fails(1), fails(2)] == [None, None]
        assert cleaned == [1, 2]
        assert len(logged) == 1 and 'ValueError: boom' in logged[0]
        assert any('ValueError: boom' in tb for tb in errors._seen_tracebacks)
        assert errors.catch()(lambda: 7)() == 7


# -- TIMING.PROFILE ----------------------------------------------------------

def _nerf_config(scene, iterations, **training):
    """tests/test_torch_nerf.py's small NeRF."""
    return {'GLOBAL': {'METHOD_TYPE': 'NeRF', 'DATASET_TYPE': 'NeRF',
                       'RANDOM_SEED': 0, 'LOG_LEVEL': 'SILENT'},
            'DATASET': {'PATH': str(scene)},
            'MODEL': {'NUM_LAYERS': 3, 'WIDTH': 64, 'SKIP_LAYER': 2,
                      'POSITION_FREQUENCIES': 6, 'DIRECTION_FREQUENCIES': 2,
                      'USE_COARSE': True},
            'RENDERER': {'N_SAMPLES': 24, 'COARSE_RATIO': 0.5},
            'TRAINING': {'NUM_ITERATIONS': iterations,
                         'RAYS_PER_BATCH': 128, 'RENDER_TESTSET': False,
                         'CHECKPOINT': {'FINAL': False}, **training}}


@pytest.mark.parametrize('start,steps', [(3, 2), (4, 10)])
def test_profile_writes_a_trace(scene, tmp_path, monkeypatch, start, steps):
    """PROFILE=3, PROFILE_STEPS=2 traces iterations 3-4 of 6; a window
    past the loop's end stops with the loop. The trace is Chrome JSON
    with the host's operations (the CPU is the only activity here) and
    the program's spans; counters.json holds the window's field samples,
    128 rays of 12 coarse, then 24 merged samples, an iteration."""
    monkeypatch.setattr(TDirectories, 'base', tmp_path)
    cfg = TConfig(_nerf_config(scene, 6, TIMING={'PROFILE': start,
                                                 'PROFILE_STEPS': steps}))
    trainer = TMethods.get_training_instance(cfg, device='cpu')
    trainer.run(TDatasets.get_dataset(cfg))
    assert trainer.model.num_iterations_trained == 6
    trace = json.loads((trainer.output_dir / 'profile' / 'trace.json')
                       .read_text())
    names = {e.get('name', '') for e in trace['traceEvents']}
    assert len(trace['traceEvents']) > 100
    assert any(n.startswith('aten::') for n in names)
    assert not any('cuda' in n.lower() and 'kernel' in n.lower()
                   for n in names)
    assert {'nerficg/trainer/training_iteration', 'nerficg/sampler',
            'nerficg/field', 'nerficg/compositor', 'nerficg/loss',
            'nerficg/optimizer'} <= names
    counted = json.loads((trainer.output_dir / 'profile' / 'counters.json')
                         .read_text())
    assert counted == {'iterations': 2,
                       'totals': {'nerf/samples': 2 * 128 * 36},
                       'per_iteration': {'nerf/samples': 128 * 36}}


# -- WANDB -------------------------------------------------------------------

class _FakeRun:
    url = 'fake://run'

    def __init__(self):
        self.logged: list[tuple] = []
        self.finished = False

    def log(self, metrics, step=None):
        self.logged.append((step, dict(metrics)))

    def finish(self):
        self.finished = True


def _fake_wandb():
    module = types.ModuleType('wandb')
    module.runs = []

    def init(project=None, name=None, config=None):
        run = _FakeRun()
        run.project, run.name, run.config = project, name, config
        module.runs.append(run)
        return run

    module.init = init
    module.Image = lambda image: ('image', np.asarray(image))
    module.Object3D = lambda points: ('object3d', np.asarray(points))
    return module


def _gs_config(scene, cls, **training):
    """tests/test_torch_gaussian_splatting.py's small 3DGS run."""
    return cls({
        'GLOBAL': {'METHOD_TYPE': 'GaussianSplatting', 'DATASET_TYPE': 'NeRF',
                   'RANDOM_SEED': 0, 'LOG_LEVEL': 'SILENT'},
        'DATASET': {'PATH': str(scene)},
        'MODEL': {'SH_DEGREE': 2, 'CAPACITY_GRANULARITY': 1024},
        'RENDERER': {'MAX_PER_TILE': 64},
        'TRAINING': {'RANDOM_POINTS': 512, 'RENDER_TESTSET': False,
                     'CHECKPOINT': {'FINAL': False},
                     'PRELOAD_DATASET': False, **training}})


WANDB_RUN = {
    'NUM_ITERATIONS': 3, 'LOG_INTERVAL': 1, 'MODEL_NAME': 'wandb',
    'WANDB': {'ACTIVATE': True, 'INTERVAL': 1, 'PROJECT': 'extras',
              'LOG_IMAGES': True, 'IMAGE_INTERVAL': 2,
              'SWEEP_MODE': {'ACTIVE': True, 'START_ITERATION': 1,
                             'ITERATION_STRIDE': 2, 'NUM_IMAGES': 0}}}


def _logged(run) -> dict:
    """{(step, key): value} of a fake run's log calls."""
    out = {}
    for step, metrics in run.logged:
        for key, value in metrics.items():
            assert (step, key) not in out
            out[step, key] = value
    return out


def test_wandb_logs_as_jax(scene, tmp_path, monkeypatch):
    fake = _fake_wandb()
    monkeypatch.setitem(sys.modules, 'wandb', fake)
    monkeypatch.setattr(TDirectories, 'base', tmp_path / 'port')
    monkeypatch.setattr(JDirectories, 'base', tmp_path / 'jax')
    j_cfg = _gs_config(scene, JConfig, **WANDB_RUN)
    JMethods.get_training_instance(j_cfg).run(JDatasets.get_dataset(j_cfg))
    t_cfg = _gs_config(scene, TConfig, **WANDB_RUN)
    TMethods.get_training_instance(t_cfg, device='cpu').run(
        TDatasets.get_dataset(t_cfg))
    j_run, t_run = fake.runs
    assert j_run.finished and t_run.finished
    assert (t_run.project, t_run.name) == (j_run.project, j_run.name) == \
        ('extras', 'wandb')
    got, want = _logged(t_run), _logged(j_run)
    assert sorted(got) == sorted(want)
    assert {key for _, key in got} == {
        'l1', 'dssim', 'total', 'psnr', 'training', 'test_psnr', 'test_ssim',
        'test_lpips', 'combined_metrics', 'gaussians/count',
        'gaussians/means'}
    for (step, key), value in want.items():
        mine = got[step, key]
        if isinstance(value, tuple):
            kind, array = value
            assert mine[0] == kind and mine[1].shape == array.shape
            if kind == 'image':
                mse = float(np.mean((mine[1] - array) ** 2))
                assert -10 * np.log10(max(mse, 1e-20)) >= IMAGE_PSNR_DB
            else:
                np.testing.assert_allclose(mine[1], array, rtol=0,
                                           atol=POINT_ATOL)
        elif key == 'test_lpips':
            assert np.isnan(mine) and np.isnan(value)
        else:
            assert mine == pytest.approx(float(value), rel=SCALAR_RTOL), \
                (step, key)


def test_wandb_missing_warns_and_trains(scene, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, 'wandb', None)     # import fails
    monkeypatch.setattr(TDirectories, 'base', tmp_path)
    warnings = []
    monkeypatch.setattr(TLogger, 'warning', staticmethod(warnings.append))
    cfg = _gs_config(scene, TConfig, **WANDB_RUN)
    trainer = TMethods.get_training_instance(cfg, device='cpu')
    trainer.run(TDatasets.get_dataset(cfg))
    assert trainer.model.num_iterations_trained == 3
    assert not trainer._wandb.active
    assert any('wandb not installed' in w for w in warnings)
    assert any('sweep mode requires wandb' in w for w in warnings)
