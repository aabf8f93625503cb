"""The COLMAP capture path of 3DGS through the port, against the JAX package
on the CPU: create_config -> train -> convert_to_ply -> inference.

The fixture: ``make_textured_scene`` at 64x64 (6 train, 2 test views)
written as a Mip-NeRF-360 capture (``test_torch_colmap.write_capture``):
images_4 of 64x48 (rows 8-55), one PINHOLE camera at 4x, 2,000 SfM points
on the sphere and 2% outliers; its config from ``create_config -m
GaussianSplatting -d MipNeRF360`` (PCA alignment, DOWNSAMPLE 4, TEST_STEP
8) with the small overrides of ``OVERRIDES``.

* The initial Gaussians from the SfM cloud equal JAX's (the kNN scales
  within 1e-6, the rest exactly), and so do the camera extent and box.
* One training step on the same view: loss within 1e-5 relative, the six
  gradients and the viewspace norm within 1e-3 relative Frobenius (the
  tolerances of tests/test_torch_gaussian_splatting.py).
* A 150-iteration run through ``scripts.train``: its test PSNR within
  PSNR_BAND_DB of JAX's; then ``convert_to_ply`` (one vertex per active
  Gaussian, the checkpoint's parameters bit for bit, read by both
  packages) and ``inference -s test ellipse_path`` (120 finite frames of
  the camera's shape).

``JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_capture.py`` runs
JAX's trainer on the same fixture and config over seeds 0-3 and prints the
PSNRs JAX_PSNR and PSNR_BAND_DB come from.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from nerficg_torch.core.config import load_config as t_load_config
from nerficg_torch.core.logging import Logger as TLogger
from nerficg_torch.core.registry import Datasets as TDatasets
from nerficg_torch.core.registry import Methods as TMethods
from nerficg_torch.core.setup import Directories as TDirectories
from nerficg_torch.data.ply import read_ply_vertices as t_read_ply
from nerficg_torch.data.synthetic import make_textured_scene
from nerficg_torch.scripts import (convert_to_ply, create_config, inference,
                                   train)
from nerficg_tpu.core.config import load_config as j_load_config
from nerficg_tpu.core.logging import Logger as JLogger
from nerficg_tpu.core.registry import Datasets as JDatasets
from nerficg_tpu.core.registry import Methods as JMethods
from nerficg_tpu.core.setup import Directories as JDirectories
from nerficg_tpu.data.ply import read_ply_vertices as j_read_ply
from test_torch_colmap import write_capture
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TLogger.set_level('SILENT')
JLogger.set_level('SILENT')

KEYS = ('positions', 'features_dc', 'features_rest', 'scales', 'rotations',
        'opacities')
OVERRIDES = ['TRAINING.NUM_ITERATIONS=150', 'MODEL.SH_DEGREE=2',
             'MODEL.CAPACITY_GRANULARITY=1024', 'RENDERER.MAX_PER_TILE=64',
             'TRAINING.DENSIFY_FROM=30', 'TRAINING.DENSIFY_UNTIL=100',
             'TRAINING.DENSIFY_INTERVAL=50', 'TRAINING.SH_UPDATE_INTERVAL=50',
             'GLOBAL.LOG_LEVEL="SILENT"']
# JAX's trainer on this fixture and config (``_jax_psnrs``): test PSNR
# 15.0372 dB at seed 0; seeds 1-3: 15.0091, 15.1019, 15.0913 (spread
# 0.0928 dB).
JAX_PSNR = 15.0372
PSNR_BAND_DB = 2 * 0.0928


def write_fixture(root) -> Path:
    """The capture and its config (``root/cfg.yaml``)."""
    root = Path(root)
    scene = make_textured_scene(root / 'scene', image_size=64, n_train=6,
                                n_test=2)
    write_capture(root / 'capture', scene, image_dir='images_4',
                  model_scale=4, rows=(8, 56), n_points=2000)
    create_config.main(['-m', 'GaussianSplatting', '-d', 'MipNeRF360', '-o',
                        str(root / 'cfg.yaml'), '-p',
                        str(root / 'capture')])
    return root / 'cfg.yaml'


@pytest.fixture(scope='module')
def config_path(tmp_path_factory):
    return write_fixture(tmp_path_factory.mktemp('capture_path'))


def _trainers(config_path):
    t_cfg = t_load_config(config_path, OVERRIDES)
    j_cfg = j_load_config(config_path, OVERRIDES)
    t_ds, j_ds = TDatasets.get_dataset(t_cfg), JDatasets.get_dataset(j_cfg)
    t_tr = TMethods.get_training_instance(t_cfg, device='cpu')
    j_tr = JMethods.get_training_instance(j_cfg)
    t_tr._setup_gaussians(t_ds)
    j_tr._setup_gaussians(j_ds)
    return (t_tr, t_ds), (j_tr, j_ds)


def test_sfm_init_matches_jax(config_path):
    (t_tr, t_ds), (j_tr, j_ds) = _trainers(config_path)
    assert len(t_ds.point_cloud) == len(j_ds.point_cloud) == 2040
    assert np.array_equal(t_ds.bounding_box.bounds, j_ds.bounding_box.bounds)
    assert t_tr.camera_extent == j_tr.camera_extent
    camera = t_ds.subsets['train'][0].camera
    assert (camera.width, camera.height) == (64, 48)
    t, j = t_tr.model, j_tr.model
    assert (t.num_active, t.capacity) == (j.num_active, 2048)
    for key in KEYS:
        got, want = t.params_tree()[key], np.asarray(j.params[key])
        if key == 'scales':
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
        else:
            assert np.array_equal(got, want), key


def _rel_frobenius(got, want):
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def test_one_step_matches_jax(config_path):
    """JAX's initial parameters in both trainers; one step on the same
    training view of the non-square frame."""
    (t_tr, t_ds), (j_tr, j_ds) = _trainers(config_path)
    t_tr.model.load_params_tree({k: np.asarray(v) for k, v in
                                 j_tr.model.params.items()})
    t_tr._build_optimizer()
    j_view, t_view = j_ds.subsets['train'][2], t_ds.subsets['train'][2]
    intrinsics, w2c, cam = j_tr.renderer.view_constants(j_view)
    assert intrinsics[4:] == (64, 48)
    target = t_tr._target(2, t_view)
    bg = jnp.asarray(j_view.camera.background_color, jnp.float32)
    sh = j_tr.model.active_sh_degree
    n = j_tr.model.params['positions'].shape[0]

    def j_loss(params, offset):
        from nerficg_tpu.optim.losses import dssim
        out = j_tr.renderer.render_impl(params, offset, w2c, cam,
                                        intrinsics=intrinsics, background=bg,
                                        sh_degree=sh)
        l1 = jnp.mean(jnp.abs(out['rgb'] - target.numpy()))
        return 0.8 * l1 + 0.2 * dssim(out['rgb'], target.numpy())

    j_value, (j_grads, j_off) = jax.jit(jax.value_and_grad(
        j_loss, argnums=(0, 1)))(
        j_tr.model.params, jnp.zeros((n, 2), jnp.float32))
    t_intr, t_w2c, t_cam = t_tr.renderer.view_constants(t_view)
    logs = t_tr.loss_and_grads(t_w2c, t_cam, t_intr,
                               torch.tensor(t_view.camera.background_color,
                                            dtype=torch.float32), target)
    assert float(logs['total']) == pytest.approx(float(j_value), rel=1e-5)
    for key in KEYS:
        got = t_tr.model.params[key].grad.numpy()
        assert _rel_frobenius(got, np.asarray(j_grads[key])) <= 1e-3, key
    ndc = np.array([0.5 * intrinsics[4], 0.5 * intrinsics[5]], np.float32)
    j_norm = np.linalg.norm(np.asarray(j_off) * ndc, axis=-1)
    assert _rel_frobenius(logs['viewspace_grad_norm'].numpy(),
                          j_norm) <= 1e-3


def test_train_export_serve(config_path, tmp_path, monkeypatch):
    """create_config's file through the port's four commands."""
    monkeypatch.setattr(TDirectories, 'base', tmp_path / 'output')
    result = train.main(['-c', str(config_path), '--device', 'cpu',
                         *OVERRIDES])
    psnr = result['metrics']['PSNR']
    assert abs(psnr - JAX_PSNR) <= PSNR_BAND_DB, psnr
    losses = torch.stack(result['trainer'].losses)
    assert losses[-20:].mean() < losses[:20].mean()
    run = Path(result['output_dir'])

    ply = convert_to_ply.main(['-d', str(run), '--device', 'cpu'])
    assert ply == run / 'export.ply'
    model = TMethods.get_model(t_load_config(run / 'training_config.yaml'),
                               checkpoint=str(run / 'checkpoints' /
                                              'final.ckpt'), device='cpu')
    want = model.get_ply_dict()
    tree = model.params_tree()
    for read in (t_read_ply, j_read_ply):
        got = read(ply)
        assert list(got) == list(want)
        assert len(got['x']) == model.num_active
        for key in want:
            assert np.array_equal(got[key], want[key]), key
        assert np.array_equal(
            np.stack([got['x'], got['y'], got['z']], -1),
            tree['positions'][:model.num_active])
    j_model = JMethods.get_model(
        j_load_config(run / 'training_config.yaml'),
        checkpoint=str(run / 'checkpoints' / 'final.ckpt'))
    for key, value in j_model.get_ply_dict().items():
        assert np.array_equal(np.asarray(value), want[key]), key

    served = inference.main(['-d', str(run), '-s', 'test', 'ellipse_path',
                             '-m', '--device', 'cpu'])
    assert served['metrics']['test']['PSNR'] == pytest.approx(psnr,
                                                              abs=1e-4)
    assert served['metrics']['ellipse_path'] == {}
    frames = sorted((run / 'ellipse_path' / 'rgb').iterdir())
    assert len(frames) == 120
    for frame in frames[::17]:
        assert np.asarray(Image.open(frame)).shape == (48, 64, 3)


def _jax_psnrs(seeds=(0, 1, 2, 3)):
    """JAX's test PSNR on the fixture over ``seeds``."""
    import tempfile
    with tempfile.TemporaryDirectory() as tmp:
        cfg_path = write_fixture(tmp)
        JDirectories.base = Path(tmp) / 'output'
        for seed in seeds:
            cfg = j_load_config(cfg_path, OVERRIDES +
                                [f'GLOBAL.RANDOM_SEED={seed}'])
            trainer = JMethods.get_training_instance(cfg)
            trainer.run(JDatasets.get_dataset(cfg))
            line = (trainer.output_dir / 'test' / 'metrics_8bit.txt'
                    ).read_text().splitlines()[-1]
            print(f'seed {seed}: {line}', flush=True)


if __name__ == '__main__':
    _jax_psnrs()
