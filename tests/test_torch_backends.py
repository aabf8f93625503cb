"""The port's Instant-NGP with the cell and crossbar encode backends against
the JAX package on the CPU, and the entry points' refusal to fall back to the
CPU unasked.

For ``MODEL.ENCODING_BACKEND`` in {cell, xbar}, with the same numpy weights
on both sides (a JAX checkpoint loaded through convert.py, or the trees of
``_trainers``):
  * a test view of a 24 px textured scene, rendered by both packages with
    two cascades, agrees to PSNR >= 45 dB in rgb and alpha (the checks of
    ``tests/test_torch_instant_ngp.py``);
  * one exact training step (STOCHASTIC_CORNERS=0 on both sides) agrees in
    the loss to 1e-5 relative, and in the gradients to 2e-2 relative
    Frobenius error and 1e-3 in norm, the bf16 noise floor
    ``tests/test_torch_training.py`` explains.
Besides: configs/ingp_parity.yaml has the same occupancy threshold in both
packages, and at its 512 steps per ray that threshold lies above the
untrained field's density both at its own MODEL.SCALE 0.5 and at 1.0 (why
the port's chip run of that config sets RENDERER.MAX_SAMPLES=256). The
factories and entry points refuse to fall back to the CPU unasked.
"""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.core.config import ConfigNode as TConfigNode
from nerficg_torch.core.config import load_config as t_load
from nerficg_torch.core.config import save_config
from nerficg_torch.core.errors import KernelError, ModelError
from nerficg_torch.core.logging import Logger as TLogger
from nerficg_torch.core.registry import Methods as TMethods
from nerficg_torch.data.synthetic import make_textured_scene
from nerficg_tpu.core.config import load_config as j_load
from nerficg_tpu.core.registry import Methods as JMethods
from test_torch_instant_ngp import _config as render_config
from test_torch_instant_ngp import check_render
from test_torch_training import check_one_step
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TLogger.set_level('SILENT')
PARITY_CONFIG = Path(__file__).resolve().parents[1] / 'configs' / \
    'ingp_parity.yaml'


@pytest.fixture(scope='module')
def scene24(tmp_path_factory):
    return make_textured_scene(tmp_path_factory.mktemp('textured24'),
                               image_size=24, n_train=2, n_test=2)


@pytest.fixture(scope='module')
def scene32(tmp_path_factory):
    return make_textured_scene(tmp_path_factory.mktemp('textured32'),
                               image_size=32, n_train=8, n_test=2)


@pytest.mark.parametrize('backend', ['cell', 'xbar'])
def test_render_matches_jax(scene24, tmp_path, backend):
    check_render(scene24, tmp_path, 1.0, backend)


@pytest.mark.parametrize('backend', ['cell', 'xbar'])
def test_one_step_matches_jax(scene32, backend):
    check_one_step(scene32, backend)


@pytest.mark.parametrize('backend', ['window', 'cell', 'xbar'])
def test_backend_sets_the_anchor_stride(scene24, backend):
    """The windowed encodes window over one anchor per march block; the
    crossbar, which runs on the ray-ordered stream, has none."""
    model = TMethods.get_model(TConfigNode(render_config(scene24, 1.0,
                                                         backend)),
                               device='cpu')
    assert model.module.backend == backend
    assert model.hash_config.anchor_stride == (1 if backend == 'xbar' else 8)


def test_unknown_backend_raises(scene24):
    with pytest.raises(ModelError):
        TMethods.get_model(TConfigNode(render_config(scene24, 1.0, 'onehot')),
                           device='cpu')


def _parity_threshold_and_density(scale, max_samples):
    """Both packages' occupancy threshold for configs/ingp_parity.yaml at
    ``MODEL.SCALE=scale`` and ``RENDERER.MAX_SAMPLES=max_samples``, and
    their untrained fields' densities at 2048 points of the box, with the
    threshold the formula gives: an alpha of DENSITY_THRESHOLD (0.01) per
    mean step, 2 * SCALE * sqrt(3) / MAX_SAMPLES long."""
    overrides = [f'MODEL.SCALE={scale}', f'RENDERER.MAX_SAMPLES={max_samples}',
                 'GLOBAL.LOG_LEVEL=SILENT']
    positions = np.random.default_rng(0).uniform(
        -scale, scale, (2048, 3)).astype(np.float32)
    tcfg = t_load(PARITY_CONFIG, overrides)
    tmodel = TMethods.get_model(tcfg, device='cpu')
    t_threshold = TMethods.get_renderer(tcfg, tmodel).density_threshold
    with torch.no_grad():
        t_sigma = tmodel.density(torch.from_numpy(positions))[0].numpy()
    jcfg = j_load(PARITY_CONFIG, overrides)
    jmodel = JMethods.get_model(jcfg)
    j_threshold = JMethods.get_renderer(jcfg, jmodel).density_threshold
    j_sigma = np.asarray(jmodel.density(jmodel.params,
                                        jnp.asarray(positions))[0])
    assert tmodel.module.backend == 'cell'
    assert tmodel.hash_config.table_size == 2 ** 19
    want = 0.01 * max_samples / (2.0 * scale * 3.0 ** 0.5)
    assert t_threshold == pytest.approx(want, rel=1e-12)
    assert j_threshold == pytest.approx(want, rel=1e-12)
    for sigma in (t_sigma, j_sigma):
        assert np.all(np.abs(sigma - 1.0) < 0.05)
    return want, (t_sigma, j_sigma)


def test_parity_config_as_published_never_warms_up():
    """configs/ingp_parity.yaml as it stands (SCALE 0.5, 512 steps per ray)
    puts the threshold at a density of 2.96, above the untrained field's
    density of about 1 (trunc_exp of a near-zero MLP output): in both
    packages the warm-up grid holds no cell, the marcher finds no sample
    and nothing trains from random weights."""
    want, sigmas = _parity_threshold_and_density(0.5, 512)
    assert want == pytest.approx(2.956, abs=1e-3)
    for sigma in sigmas:
        assert sigma.max() < want       # the warm-up grid stays empty


@pytest.mark.parametrize('max_samples', [512, 256])
def test_parity_config_warmup_grid_at_unit_scale(max_samples):
    """The same config at MODEL.SCALE=1.0, for a scene that spans the unit
    box. Doubling SCALE halves the threshold, to 1.48 at 512 steps per ray,
    still above the untrained density: the grid stays empty. MAX_SAMPLES=256,
    bench.py's own pairing with SCALE 1.0 for its quality probe on this
    scene, halves it again to 0.74 (a quarter of the published config's)
    and every queried cell is occupied."""
    want, sigmas = _parity_threshold_and_density(1.0, max_samples)
    for sigma in sigmas:
        if max_samples == 512:
            assert sigma.max() < want       # the warm-up grid stays empty
        else:
            assert sigma.min() > want       # every queried cell is occupied


@pytest.mark.parametrize('script', ['train', 'inference'])
def test_entry_points_refuse_to_fall_back_to_the_cpu(scene24, tmp_path,
                                                     monkeypatch, script):
    """Without a card the entry points raise, naming ``--device cpu``,
    before they build anything; with ``--device cpu`` they run (the CPU
    runs are tests/test_torch_training.py and test_torch_instant_ngp.py)."""
    from nerficg_torch.scripts import inference, train
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    save_config(TConfigNode(render_config(scene24, 1.0)),
                tmp_path / 'training_config.yaml')
    argv = (['-c', str(tmp_path / 'training_config.yaml')]
            if script == 'train' else ['-d', str(tmp_path), '-s', 'test'])
    main = train.main if script == 'train' else inference.main
    with pytest.raises(KernelError, match='--device cpu'):
        main(argv)


@pytest.mark.parametrize('factory', ['get_model', 'get_training_instance'])
def test_factories_refuse_to_fall_back_to_the_cpu(scene24, monkeypatch,
                                                  factory):
    """The registry's factories put the model on the card by default and,
    without one, raise naming ``device='cpu'`` instead of building on the
    CPU, where every kernel wrapper would take its plain version."""
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(KernelError, match="device='cpu'"):
        getattr(TMethods, factory)(TConfigNode(render_config(scene24, 1.0)))
