"""The port's Instant-NGP serving slice against the JAX package on the CPU.

A checkpoint saved by nerficg_tpu (random U(-1, 1) table, He-uniform MLPs,
a shell-shaped occupancy grid, so every term of the field matters) loads in
nerficg_torch; a test view of a 24 px textured scene rendered by both must
agree to PSNR >= 45 dB, for one cascade (SCALE 0.5, linear steps) and two
(SCALE 1.0, exponential steps). Checkpoints also go the other way, the
port's inference entry point runs end to end, and the guards check that the
port never imports jax and that chip_smoke.py refuses to run without a card.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.core.checkpoint import flatten_tree, load_checkpoint
from nerficg_torch.core.config import ConfigNode as TConfigNode
from nerficg_torch.core.logging import Logger as TLogger
from nerficg_torch.core.registry import Datasets as TDatasets
from nerficg_torch.core.registry import Methods as TMethods
from nerficg_torch.data.synthetic import make_textured_scene
from nerficg_torch.methods.instant_ngp.model import _mlp
from nerficg_torch.ops.encoding import sh_encode
from nerficg_tpu.core.config import ConfigNode as JConfigNode
from nerficg_tpu.core.registry import Datasets as JDatasets
from nerficg_tpu.core.registry import Methods as JMethods
from nerficg_tpu.methods.instant_ngp import model as jmodel
from nerficg_tpu.ops import encoding as jencoding
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

ROOT = Path(__file__).resolve().parent.parent
MIN_PSNR_DB = 45.0

TLogger.set_level('SILENT')


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp('textured24')
    return make_textured_scene(root, image_size=24, n_train=2, n_test=2)


def _config(scene, scale, backend='window'):
    return {'GLOBAL': {'METHOD_TYPE': 'InstantNGP', 'DATASET_TYPE': 'NeRF',
                       'RANDOM_SEED': 0, 'LOG_LEVEL': 'SILENT'},
            'DATASET': {'PATH': str(scene)},
            'MODEL': {'NUM_LEVELS': 6, 'LOG2_HASHMAP_SIZE': 12,
                      'BASE_RESOLUTION': 4, 'TARGET_RESOLUTION': 256,
                      'GRID_RESOLUTION': 32, 'SCALE': scale,
                      'ENCODING_BACKEND': backend},
            'RENDERER': {'MAX_SAMPLES': 64, 'RAY_BATCH_SIZE': 1024}}


def _shell_grid(resolution, cascades, scale):
    """1e3 on an 8-cell shell at radius 0.8 * scale in every cascade."""
    grids = []
    for c in range(cascades):
        half = scale / 2 ** (cascades - 1) * 2 ** c
        ax = ((np.arange(resolution) + 0.5) / resolution - 0.5) * 2 * half
        x, y, z = np.meshgrid(ax, ax, ax, indexing='ij')
        r = np.sqrt(x * x + y * y + z * z)
        cell = 2 * half / resolution
        grids.append(np.where(np.abs(r - 0.8 * scale) <= 4 * cell, 1e3, 0.0)
                     .reshape(-1))
    return np.concatenate(grids).astype(np.float32)


def _jax_model(cfg, seed=0):
    """A nerficg_tpu model with random weights from a numpy seed."""
    model = JMethods.get_model(JConfigNode(cfg))
    rng = np.random.default_rng(seed)

    def he_uniform(w):
        bound = np.sqrt(6.0 / w.shape[0])
        return jnp.asarray(rng.uniform(-bound, bound, w.shape), jnp.float32)

    model.params = {
        'hash_table': jnp.asarray(rng.uniform(
            -1, 1, model.params['hash_table'].shape), jnp.float32),
        'density_mlp': [he_uniform(w) for w in model.params['density_mlp']],
        'color_mlp': [he_uniform(w) for w in model.params['color_mlp']]}
    model.buffers = {'density_grid': jnp.asarray(_shell_grid(
        int(model.GRID_RESOLUTION), model.cascades, float(model.SCALE)))}
    return model


def check_render(scene, tmp_path, scale, backend):
    """A test view rendered by both packages from one JAX checkpoint agrees
    to MIN_PSNR_DB in rgb and alpha."""
    cfg = _config(scene, scale, backend)
    jm = _jax_model(cfg)
    ckpt = tmp_path / 'final.ckpt'
    jm.save(ckpt)
    jr = JMethods.get_renderer(JConfigNode(cfg), jm)
    want = jr.render_image(JDatasets.get_dataset(JConfigNode(cfg))
                           .subsets['test'][0])

    tm = TMethods.get_model(TConfigNode(cfg), checkpoint=str(ckpt),
                         device='cpu')
    assert tm.cascades == jm.cascades == (1 if scale == 0.5 else 2)
    tr = TMethods.get_renderer(TConfigNode(cfg), tm)
    assert tr._exponential == (scale == 1.0)
    got = tr.render_image(TDatasets.get_dataset(TConfigNode(cfg))
                          .subsets['test'][0])
    assert float(got['alpha'].mean()) > 0.01     # the shell is in view
    for key in ('rgb', 'alpha'):
        a, b = np.asarray(want[key]), got[key].numpy()
        assert a.shape == b.shape and np.isfinite(b).all()
        psnr = -10 * np.log10(max(float(np.mean((a - b) ** 2)), 1e-20))
        assert psnr >= MIN_PSNR_DB, f'{key}: {psnr:.1f} dB'


@pytest.mark.parametrize('scale', [0.5, 1.0])
def test_render_matches_jax(scene, tmp_path, scale):
    check_render(scene, tmp_path, scale, 'window')


def test_port_checkpoint_loads_in_jax(scene, tmp_path):
    """Weights survive port -> npz -> nerficg_tpu exactly, in its layout."""
    cfg = _config(scene, 1.0)
    tm = TMethods.get_model(TConfigNode(cfg), device='cpu')
    tm.buffers['density_grid'] = torch.from_numpy(_shell_grid(32, 2, 1.0))
    ckpt = tmp_path / 'port.ckpt'
    tm.save(ckpt)
    keys = set(flatten_tree(load_checkpoint(ckpt)['params']))
    assert keys == {'hash_table', 'density_mlp/0', 'density_mlp/1',
                    'color_mlp/0', 'color_mlp/1', 'color_mlp/2'}
    jm = JMethods.get_model(JConfigNode(cfg), checkpoint=str(ckpt))
    tree = tm.params_tree()
    np.testing.assert_array_equal(np.asarray(jm.params['hash_table']),
                                  tree['hash_table'])
    for name in ('density_mlp', 'color_mlp'):
        for w_j, w_t, layer in zip(jm.params[name], tree[name],
                                   getattr(tm.module, name)):
            np.testing.assert_array_equal(np.asarray(w_j), w_t)
            assert w_t.shape == tuple(layer.weight.shape[::-1])
    np.testing.assert_array_equal(np.asarray(jm.buffers['density_grid']),
                                  tm.buffers['density_grid'].numpy())


def test_mlp_and_sh_match(scene):
    """bf16-operand, f32-accumulate MLP and the SH basis against JAX."""
    cfg = _config(scene, 1.0)
    jm = _jax_model(cfg, seed=3)
    tm = TMethods.get_model(TConfigNode(cfg), device='cpu')
    tm.load_params_tree({k: (np.asarray(v) if k == 'hash_table' else
                             [np.asarray(w) for w in v])
                         for k, v in jm.params.items()})
    rng = np.random.default_rng(4)
    x = rng.normal(size=(512, 31)).astype(np.float32)
    want = np.asarray(jmodel._mlp(jm.params['color_mlp'], jnp.asarray(x)))
    with torch.no_grad():
        got = _mlp(tm.module.color_mlp, torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    d = rng.normal(size=(512, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    np.testing.assert_allclose(sh_encode(torch.from_numpy(d), 4).numpy(),
                               np.asarray(jencoding.sh_encode(
                                   jnp.asarray(d), 4)), rtol=0, atol=1e-6)


def test_inference_main_end_to_end(scene, tmp_path):
    """python -m nerficg_torch.scripts.inference -d RUN -s test -m -b on CPU."""
    from nerficg_torch.core.config import save_config
    from nerficg_torch.scripts import inference
    cfg = _config(scene, 1.0)
    run = tmp_path / 'run'
    save_config(TConfigNode(cfg), run / 'training_config.yaml')
    _jax_model(cfg).save(run / 'checkpoints' / 'final.ckpt')
    result = inference.main(['-d', str(run), '-s', 'test', '-m', '-b',
                             '--repeats', '1', '--device', 'cpu'])
    metrics = result['metrics']['test']
    assert np.isfinite(metrics['PSNR']) and np.isfinite(metrics['SSIM'])
    assert result['fps'] > 0
    assert (run / 'performance_0.txt').is_file()
    lines = (run / 'test' / 'metrics_8bit.txt').read_text().splitlines()
    assert lines[-1].startswith('mean: PSNR=')
    for key in ('rgb', 'depth', 'alpha'):
        assert sorted(p.name for p in (run / 'test' / key).iterdir()) == \
            ['00000.png', '00001.png']


def _clean_env():
    env = dict(os.environ)
    env.pop('PYTHONPATH', None)
    return env


def test_port_never_imports_jax(scene):
    """Import every nerficg_torch module and render on the CPU in a fresh
    interpreter; neither jax nor nerficg_tpu may be loaded."""
    code = f'''
import importlib, pkgutil, sys
import torch
import nerficg_torch
for info in pkgutil.walk_packages(nerficg_torch.__path__, 'nerficg_torch.'):
    importlib.import_module(info.name)
from nerficg_torch.core.config import ConfigNode
from nerficg_torch.core.logging import Logger
from nerficg_torch.core.registry import Datasets, Methods
Logger.set_level('SILENT')
cfg = ConfigNode({_config(scene, 1.0)!r})
model = Methods.get_model(cfg, device='cpu')
model.buffers['density_grid'] = torch.full_like(model.buffers['density_grid'], 1e3)
renderer = Methods.get_renderer(cfg, model)
out = renderer.render_image(Datasets.get_dataset(cfg).subsets['test'][0])
assert torch.isfinite(out['rgb']).all()
bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'nerficg_tpu')]
assert not bad, bad
print('clean')
'''
    proc = subprocess.run([sys.executable, '-c', code], cwd=ROOT,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.strip().endswith('clean')


@pytest.mark.parametrize('alone', [False, True])
def test_chip_smoke_refuses_without_a_card(tmp_path, alone):
    """Without CUDA (and, alone, without the repository around it)
    chip_smoke.py exits non-zero and prints no result line."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA card is present: chip_smoke.py would run')
    script = ROOT / 'chip_smoke.py'
    cwd = ROOT
    if alone:
        shutil.copy(script, tmp_path / 'chip_smoke.py')
        script, cwd = tmp_path / 'chip_smoke.py', tmp_path
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd,
                          env=_clean_env(), capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
