"""Instant-NGP on the captures only the new data layer loads, the port
against the JAX package on the CPU.

* One training step with exact corners (STOCHASTIC_CORNERS=0) on a COLMAP
  capture with two cameras (alternating views, the odd ones resized by 0.8)
  and on a Ricoh360 panorama capture: the same parameters, density grid,
  ray ids, background and march seed in both packages (as
  test_torch_training.py's one-step test); the loss agrees to LOSS_RTOL,
  each gradient to FROBENIUS_RTOL relative Frobenius error and its norm to
  NORM_RTOL. Half the ray ids fall on the sphere's pixels, the rest
  anywhere, so on the panoramas most of those miss the model's box.
* The inference entry point (``scripts.inference -d RUN -s test``) on a
  JAX-saved checkpoint renders a panorama test view: its written 8-bit
  image against JAX's render of the view, quantised the same way, at
  MIN_PSNR_DB or more (test_torch_instant_ngp.py's bar for renders).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerficg_torch.core.config import ConfigNode as TConfigNode
from nerficg_torch.core.config import save_config
from nerficg_torch.core.logging import Logger as TLogger
from nerficg_torch.core.registry import Datasets as TDatasets
from nerficg_torch.core.registry import Methods as TMethods
from nerficg_torch.data.synthetic import make_textured_scene
from nerficg_tpu.core.config import ConfigNode as JConfigNode
from nerficg_tpu.core.registry import Datasets as JDatasets
from nerficg_tpu.core.registry import Methods as JMethods
from test_torch_colmap import write_capture
from test_torch_data_loaders import write_panoramas
from test_torch_instant_ngp import MIN_PSNR_DB, _jax_model
from test_torch_training import (FROBENIUS_RTOL, LOSS_RTOL,  # noqa: F401
                                 NORM_RTOL, _assert_trees_close, _port_tree,
                                 _shell_grid)
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TLogger.set_level('SILENT')


@pytest.fixture(scope='module')
def two_camera_capture(tmp_path_factory):
    scene = make_textured_scene(tmp_path_factory.mktemp('textured40'),
                                image_size=40, n_train=8, n_test=2)
    return write_capture(tmp_path_factory.mktemp('two_cameras'), scene,
                         second_scale=0.8)


@pytest.fixture(scope='module')
def panoramas(tmp_path_factory):
    return write_panoramas(tmp_path_factory.mktemp('ricoh'), {'train': 10},
                           size=(96, 48))


_DATASETS = {'two_cameras': ('Colmap', 'two_camera_capture',
                             {'NORMALIZE_PCA': False, 'TEST_STEP': 4}),
             'panoramas': ('Ricoh360', 'panoramas', {})}


def _config(name, path, dataset):
    return {'GLOBAL': {'METHOD_TYPE': 'InstantNGP', 'DATASET_TYPE': name,
                       'RANDOM_SEED': 0, 'LOG_LEVEL': 'SILENT',
                       'NUM_DEVICES': 1},
            'DATASET': {'PATH': str(path), **dataset},
            'MODEL': {'NUM_LEVELS': 6, 'LOG2_HASHMAP_SIZE': 12,
                      'BASE_RESOLUTION': 4, 'TARGET_RESOLUTION': 256,
                      'GRID_RESOLUTION': 32, 'SCALE': 1.0,
                      'STOCHASTIC_CORNERS': 0},
            'RENDERER': {'MAX_SAMPLES': 64, 'RAY_BATCH_SIZE': 1024,
                         'OCCUPANCY_SAMPLES': 4096},
            'TRAINING': {'NUM_ITERATIONS': 10,
                         'INITIAL_RAYS_PER_BATCH': 256,
                         'TARGET_BATCH_SIZE': 8192, 'MODEL_NAME': 'slice'}}


def _trainers(cfg):
    """A JAX and a port trainer with the same weights (table U(-0.1, 0.1),
    He-uniform MLPs from a numpy seed) and shell density grid, ray pools
    built."""
    jt = JMethods.get_training_instance(JConfigNode(cfg))
    tt = TMethods.get_training_instance(TConfigNode(cfg), device='cpu')
    rng = np.random.default_rng(0)

    def he_uniform(w):
        bound = np.sqrt(6.0 / w.shape[0])
        return rng.uniform(-bound, bound, w.shape).astype(np.float32)
    tree = {'hash_table': rng.uniform(-0.1, 0.1, jt.model.params[
                'hash_table'].shape).astype(np.float32),
            'density_mlp': [he_uniform(w) for w in
                            jt.model.params['density_mlp']],
            'color_mlp': [he_uniform(w) for w in jt.model.params['color_mlp']]}
    jt.model.params = jax.tree_util.tree_map(jnp.asarray, tree)
    tt.model.load_params_tree(tree)
    grid = _shell_grid(32, 2, 1.0)
    jt.model.buffers['density_grid'] = jnp.asarray(grid)
    tt.model.buffers['density_grid'] = torch.from_numpy(grid)
    jt.opt_state = None
    jt._init_samplers(JDatasets.get_dataset(JConfigNode(cfg)))
    tt._init_samplers(TDatasets.get_dataset(TConfigNode(cfg)))
    return jt, tt


@pytest.mark.parametrize('case', list(_DATASETS))
def test_one_step_matches_jax(case, request):
    name, fixture, dataset = _DATASETS[case]
    cfg = _config(name, request.getfixturevalue(fixture), dataset)
    jt, tt = _trainers(cfg)
    pool = jt._pool
    assert tt._pool_size == int(pool['origins'].shape[0])
    rgb = np.asarray(pool['rgb'])
    rng = np.random.default_rng(1)
    on_sphere = np.nonzero(rgb.sum(-1) > 0.05)[0]
    ids = np.concatenate([rng.choice(on_sphere, 128, replace=False),
                          rng.integers(0, len(rgb), 128)])
    bg = rng.random(3).astype(np.float32)
    key = jax.random.PRNGKey(11)
    jr = jt.renderer
    n = ids.shape[0]
    spr = min(max(int(jt.TARGET_BATCH_SIZE) // n, 4), int(jr.MAX_SAMPLES))
    assert pool['alpha'] is None
    target = pool['rgb'][ids]
    grid = jr.grid_binary()

    @jax.jit
    def loss_fn(p):       # nerficg_tpu trainer.py:172-192
        out = jr._render_rays_impl(p, grid, pool['origins'][ids],
                                   pool['directions'][ids], key,
                                   jnp.asarray(bg), randomized=True,
                                   num_rays=n, samples_per_ray=spr)
        mask = out['ray_mask']
        color = jnp.sum((out['rgb'] - target) ** 2 * mask) / \
            jnp.maximum(jnp.sum(mask) * 3.0, 1.0)
        return color + float(jt.WEIGHT_DECAY) * \
            jr.model.mlp_weight_squares(p)

    loss_j, grads_j = jax.value_and_grad(loss_fn)(jt.model.params)
    assert tt.samples_per_ray(n) == spr
    logs = tt.loss_and_grads(torch.from_numpy(ids), torch.from_numpy(bg),
                             int(jax.random.bits(key, dtype=jnp.uint32)), 0)
    assert float(logs['num_samples']) > 500
    assert float(logs['total']) == pytest.approx(float(loss_j),
                                                 rel=LOSS_RTOL)
    from nerficg_torch.methods.instant_ngp.convert import params_to_numpy
    grads_t = params_to_numpy({k: p.grad for k, p in
                               tt.model.module.named_parameters()})
    _assert_trees_close(_port_tree(grads_t), grads_j, 'gradient',
                        norm_rtol=NORM_RTOL)


def test_inference_renders_a_panorama_as_jax(panoramas, tmp_path):
    from nerficg_torch.scripts import inference
    cfg = _config('Ricoh360', panoramas, {})
    jm = _jax_model(cfg)
    run = tmp_path / 'run'
    save_config(TConfigNode(cfg), run / 'training_config.yaml')
    jm.save(run / 'checkpoints' / 'final.ckpt')
    result = inference.main(['-d', str(run), '-s', 'test', '-m',
                             '--device', 'cpu'])
    assert np.isfinite(result['metrics']['test']['PSNR'])
    view = JDatasets.get_dataset(JConfigNode(cfg)).subsets['test'][0]
    assert (view.camera.width, view.camera.height) == (96, 48)
    want = np.asarray(JMethods.get_renderer(JConfigNode(cfg), jm)
                      .render_image(view)['rgb'])
    want = (np.clip(want, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    got = np.asarray(Image.open(run / 'test' / 'rgb' / '00000.png'))
    assert got.shape == want.shape == (48, 96, 3)
    # the shell (radius 0.8 at distance 4) fills ~1% of a panorama
    assert (got > 0).mean() > 0.005
    mse = np.mean((got / 255.0 - want / 255.0) ** 2)
    psnr = -10 * np.log10(max(mse, 1e-20))
    assert psnr >= MIN_PSNR_DB, f'{psnr:.1f} dB'
