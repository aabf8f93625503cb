"""The port's LPIPS (``nerficg_torch/optim/lpips.py``, ``optim/metrics.py``)
and ``vgg_perceptual`` against the JAX package on the CPU.

One weights file serves both: the JAX package's ``init_random_weights
(PRNGKey(0))`` written as its npz (HWIO convolutions), loaded by the port
(OIHW) and passed to JAX as ``params=``, or found by both through
``NERFICG_LPIPS_WEIGHTS``.

* LPIPS of 64x64 and odd 37x53 pairs (the max-pools drop odd rows) and
  ``vgg_perceptual`` with its gradient: within RTOL.
* ``metrics_8bit.txt`` written by both packages' ``render_subset`` on the
  same renders: with the npz, every column (LPIPS among them) within
  METRIC_ATOL; without one, the same ``# LPIPS: unavailable`` line and
  no LPIPS column.
* The wandb sweep callback of both packages' trainers on the same renders:
  with the npz a finite ``test_lpips`` and the three-term
  ``combined_metrics``, within RTOL; without it NaN and two terms. The
  JAX package's ``lpips_available`` counts only the optional ``lpips``
  package, so here it is pointed at its weights file.
* Without weights: NaN, ``lpips_available`` false, ``vgg_perceptual``
  raising in both packages.
* ``save_weights_npz`` through a stand-in ``lpips`` package: the npz's
  layout, read back by ``load_weights``.
"""

import math
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.core.config import ConfigNode as TConfig
from nerficg_torch.core.registry import Datasets as TDatasets
from nerficg_torch.data.synthetic import make_textured_scene
from nerficg_torch.methods.base import renderer as trenderer
from nerficg_torch.methods.base.trainer import BaseTrainer as TBaseTrainer
from nerficg_torch.optim import lpips as tlpips
from nerficg_torch.optim import losses as tlosses
from nerficg_torch.optim import metrics as tmetrics
from nerficg_tpu.core.config import ConfigNode as JConfig
from nerficg_tpu.core.registry import Datasets as JDatasets
from nerficg_tpu.methods.base import renderer as jrenderer
from nerficg_tpu.methods.base.trainer import BaseTrainer as JBaseTrainer
from nerficg_tpu.optim import losses as jlosses
from nerficg_tpu.optim import lpips_jax
from nerficg_tpu.optim import metrics as jmetrics
from test_torch_trainer_extras import _fixed_renderer
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

# Float32 convolutions by different algorithms; LPIPS sums 5 blocks.
RTOL = 1e-4
# metrics_8bit.txt prints 6 decimals; the two packages' values agree to
# RTOL, and PSNR ~10-20 dB x RTOL stays under this.
METRIC_ATOL = 1e-4


@pytest.fixture(scope='module')
def npz(tmp_path_factory):
    params = lpips_jax.init_random_weights(jax.random.PRNGKey(0))
    path = tmp_path_factory.mktemp('lpips') / 'lpips_vgg.npz'
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})
    return path


@pytest.fixture(scope='module')
def jax_params(npz):
    with np.load(npz) as data:
        return {k: jnp.asarray(data[k]) for k in data.files}


def _use_weights(monkeypatch, path):
    """Both packages find ``path`` through NERFICG_LPIPS_WEIGHTS (the JAX
    loader's process-wide cache reset), and the JAX package's
    ``lpips_available`` follows its weights file."""
    monkeypatch.setenv('NERFICG_LPIPS_WEIGHTS', str(path))
    monkeypatch.setattr(lpips_jax, '_weights_cache', None)
    monkeypatch.setattr(lpips_jax, '_weights_checked', False)
    monkeypatch.setattr(jmetrics, 'lpips_available',
                        lpips_jax.lpips_weights_available)


@pytest.fixture
def with_weights(monkeypatch, npz):
    _use_weights(monkeypatch, npz)


@pytest.fixture
def without_weights(monkeypatch, tmp_path):
    _use_weights(monkeypatch, tmp_path / 'missing.npz')


def _pair(shape, seed):
    rng = np.random.default_rng(seed)
    a = rng.random(shape).astype(np.float32)
    b = np.clip(a + 0.2 * rng.standard_normal(shape), 0, 1).astype(np.float32)
    return a, b


@pytest.mark.parametrize('shape', [(64, 64, 3), (37, 53, 3)])
def test_lpips_matches_jax(npz, jax_params, with_weights, shape):
    a, b = _pair(shape, seed=shape[0])
    want = lpips_jax.lpips_jax(a, b, params=jax_params)
    got = tlpips.lpips_vgg(a, b, params=tlpips.load_weights(npz))
    assert want > 0
    assert got == pytest.approx(want, rel=RTOL)
    # Found through NERFICG_LPIPS_WEIGHTS by both packages' metrics.
    assert tmetrics.lpips_available() and tlpips.lpips_weights_available()
    assert tmetrics.lpips(torch.from_numpy(a), torch.from_numpy(b)) == \
        pytest.approx(jmetrics.lpips(a, b), rel=RTOL)
    assert tmetrics.compute_all_metrics(a, b)['LPIPS'] == \
        pytest.approx(jmetrics.compute_all_metrics(a, b)['LPIPS'], rel=RTOL)


def test_lpips_identical_images_is_zero(npz):
    a, _ = _pair((32, 32, 3), seed=1)
    assert tlpips.lpips_vgg(a, a, params=tlpips.load_weights(npz)) == 0.0


@pytest.mark.parametrize('shape', [(24, 24, 3), (2, 17, 19, 3)])
def test_vgg_perceptual_matches_jax(npz, jax_params, with_weights, shape):
    a, b = _pair(shape, seed=7)
    want, want_grad = jax.value_and_grad(
        lambda p: jlosses.vgg_perceptual(p, jnp.asarray(b),
                                         params=jax_params))(jnp.asarray(a))
    pred = torch.from_numpy(a).requires_grad_(True)
    got = tlosses.vgg_perceptual(pred, torch.from_numpy(b))
    got.backward()
    assert got.item() == pytest.approx(float(want), rel=RTOL)
    scale = float(np.abs(np.asarray(want_grad)).max())
    np.testing.assert_allclose(pred.grad.numpy(), np.asarray(want_grad),
                               rtol=0, atol=RTOL * scale)


def test_without_weights(without_weights):
    a, b = _pair((24, 24, 3), seed=3)
    assert not tlpips.lpips_weights_available()
    assert not tmetrics.lpips_available()
    assert math.isnan(tmetrics.lpips(a, b))
    assert math.isnan(jmetrics.lpips(a, b))
    assert math.isnan(tmetrics.compute_all_metrics(a, b)['LPIPS'])
    with pytest.raises(RuntimeError, match='NERFICG_LPIPS_WEIGHTS'):
        tlosses.vgg_perceptual(torch.from_numpy(a), torch.from_numpy(b))
    with pytest.raises(RuntimeError, match='NERFICG_LPIPS_WEIGHTS'):
        jlosses.vgg_perceptual(jnp.asarray(a), jnp.asarray(b))


# -- metrics_8bit.txt ---------------------------------------------------------

@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    return make_textured_scene(tmp_path_factory.mktemp('lpips_scene'),
                               image_size=32, n_train=4, n_test=2)


def _metrics_files(scene, tmp_path):
    """Both packages' metrics_8bit.txt of one fixed render per test view."""
    cfg = {'GLOBAL': {'METHOD_TYPE': 'NeRF', 'DATASET_TYPE': 'NeRF'},
           'DATASET': {'PATH': str(scene)}}
    _fixed_renderer(trenderer.BaseRenderer, torch.from_numpy).render_subset(
        TDatasets.get_dataset(TConfig(cfg)), 'test', tmp_path / 'port')
    _fixed_renderer(jrenderer.BaseRenderer, jnp.asarray).render_subset(
        JDatasets.get_dataset(JConfig(cfg)), 'test', tmp_path / 'jax')
    return [(tmp_path / side / 'metrics_8bit.txt').read_text().splitlines()
            for side in ('port', 'jax')]


def _columns(line):
    """'00000: PSNR=1.0 SSIM=...' -> ('00000', {'PSNR': 1.0, ...})."""
    head, rest = line.split(': ', 1)
    return head, {k: float(v) for k, v in
                  (item.split('=') for item in rest.split())}


def test_metrics_file_lpips_column_as_jax(scene, tmp_path, with_weights):
    port, want = _metrics_files(scene, tmp_path)
    assert len(port) == len(want) == 3                 # 2 views and the mean
    for got_line, want_line in zip(port, want):
        head, got = _columns(got_line)
        assert (head, list(got)) == (_columns(want_line)[0],
                                     ['PSNR', 'SSIM', 'LPIPS'])
        for key, value in _columns(want_line)[1].items():
            assert got[key] == pytest.approx(value, abs=METRIC_ATOL), \
                (head, key)
        assert got['LPIPS'] > 0


def test_metrics_file_without_weights_as_jax(scene, tmp_path,
                                             without_weights):
    port, want = _metrics_files(scene, tmp_path)
    assert port[0] == want[0] == '# LPIPS: unavailable'
    assert len(port) == len(want) == 4
    for got_line, want_line in zip(port[1:], want[1:]):
        head, got = _columns(got_line)
        want_head, want_values = _columns(want_line)
        assert (head, list(got)) == (want_head, list(want_values))
        np.testing.assert_allclose(list(got.values()),
                                   list(want_values.values()), rtol=0,
                                   atol=METRIC_ATOL)
    # Each view's LPIPS is nan; the mean leaves the column out.
    assert list(_columns(port[-1])[1]) == ['PSNR', 'SSIM']
    assert math.isnan(_columns(port[1])[1]['LPIPS'])


# -- the wandb sweep ---------------------------------------------------------

class _Run:
    """A wandb run stand-in: what ``log`` was given, by step."""
    active = True

    def __init__(self):
        self.logged = {}

    def log(self, metrics, step):
        self.logged[step] = metrics


def _sweep(trainer_cls, renderer, dataset, **extra):
    """One ``_wandb_sweep_metrics`` call of ``trainer_cls`` on a stand-in
    trainer with ``renderer``; returns what it logged."""
    run = _Run()
    trainer = types.SimpleNamespace(
        _wandb=run, WANDB={'SWEEP_MODE': {'NUM_IMAGES': 0}},
        renderer=renderer, **extra)
    trainer_cls._wandb_sweep_metrics(trainer, dataset, 7)
    return run.logged[7]


def test_sweep_logs_lpips_as_jax(scene, with_weights):
    cfg = {'GLOBAL': {'METHOD_TYPE': 'NeRF', 'DATASET_TYPE': 'NeRF'},
           'DATASET': {'PATH': str(scene)}}
    got = _sweep(TBaseTrainer, _fixed_renderer(trenderer.BaseRenderer,
                                               torch.from_numpy),
                 TDatasets.get_dataset(TConfig(cfg)),
                 device=torch.device('cpu'))
    want = _sweep(JBaseTrainer, _fixed_renderer(jrenderer.BaseRenderer,
                                                 jnp.asarray),
                  JDatasets.get_dataset(JConfig(cfg)))
    assert list(got) == list(want) == ['test_psnr', 'test_ssim', 'test_lpips',
                                       'combined_metrics']
    lp = got['test_lpips']
    assert math.isfinite(lp) and lp > 0
    for key, value in want.items():
        assert got[key] == pytest.approx(float(value), rel=RTOL), key
    # Three terms: the geometric mean of PSNR's, SSIM's and LPIPS's.
    terms = [-0.1 * math.log(10.0) * got['test_psnr'],
             math.log(math.sqrt(max(1.0 - got['test_ssim'], 1e-12))),
             math.log(lp)]
    assert got['combined_metrics'] == pytest.approx(
        math.exp(sum(terms) / 3), rel=1e-12)


def test_sweep_without_weights_as_jax(scene, without_weights):
    cfg = {'GLOBAL': {'METHOD_TYPE': 'NeRF', 'DATASET_TYPE': 'NeRF'},
           'DATASET': {'PATH': str(scene)}}
    got = _sweep(TBaseTrainer, _fixed_renderer(trenderer.BaseRenderer,
                                               torch.from_numpy),
                 TDatasets.get_dataset(TConfig(cfg)),
                 device=torch.device('cpu'))
    want = _sweep(JBaseTrainer, _fixed_renderer(jrenderer.BaseRenderer,
                                                 jnp.asarray),
                  JDatasets.get_dataset(JConfig(cfg)))
    assert math.isnan(got['test_lpips']) and math.isnan(want['test_lpips'])
    assert got['combined_metrics'] == pytest.approx(
        float(want['combined_metrics']), rel=RTOL)


# -- save_weights_npz ----------------------------------------------------------

def _fake_lpips_package():
    """A stand-in for the ``lpips`` package: VGG16's convolutions in five
    slices with ReLUs and pools between, and five 1x1 linear heads."""
    module = types.ModuleType('lpips')
    cfg = ((2, 64), (2, 128), (3, 256), (3, 512), (3, 512))

    class LPIPS(torch.nn.Module):
        def __init__(self, net='vgg', verbose=True):
            super().__init__()
            assert net == 'vgg'
            torch.manual_seed(0)            # each instance: the same weights
            self.net = torch.nn.Module()
            cin = 3
            for block, (n_convs, cout) in enumerate(cfg):
                layers = [torch.nn.MaxPool2d(2)] if block else []
                for _ in range(n_convs):
                    layers += [torch.nn.Conv2d(cin, cout, 3, padding=1),
                               torch.nn.ReLU()]
                    cin = cout
                setattr(self.net, f'slice{block + 1}',
                        torch.nn.Sequential(*layers))
            self.lins = torch.nn.ModuleList()
            for _, cout in cfg:
                lin = torch.nn.Module()
                lin.model = torch.nn.Sequential(
                    torch.nn.Dropout(), torch.nn.Conv2d(cout, 1, 1,
                                                        bias=False))
                self.lins.append(lin)

    module.LPIPS = LPIPS
    return module


def test_save_weights_npz_layout(tmp_path, monkeypatch):
    fake = _fake_lpips_package()
    monkeypatch.setitem(sys.modules, 'lpips', fake)
    path = tmp_path / 'converted.npz'
    tlpips.save_weights_npz(path)
    model = fake.LPIPS()
    convs = [m for part in (model.net.slice1, model.net.slice2,
                            model.net.slice3, model.net.slice4,
                            model.net.slice5)
             for m in part if isinstance(m, torch.nn.Conv2d)]
    with np.load(path) as data:
        assert sorted(data.files) == sorted(
            [f'conv{i}_{s}' for i in range(13) for s in 'wb'] +
            [f'lin{l}' for l in range(5)])
        assert data['conv0_w'].shape == (3, 3, 3, 64)
        np.testing.assert_array_equal(
            data['conv12_w'], convs[12].weight.detach().permute(2, 3, 1, 0))
        np.testing.assert_array_equal(
            data['lin4'], model.lins[4].model[-1].weight.detach()[0, :, 0, 0])
    loaded = tlpips.load_weights(path)
    for i, conv in enumerate(convs):
        torch.testing.assert_close(loaded[f'conv{i}_w'], conv.weight.detach(),
                                   rtol=0, atol=0)
