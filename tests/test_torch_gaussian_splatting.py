"""The port's 3D Gaussian Splatting method against the JAX package on the CPU.

* The model: the point-cloud init (kNN scales), clone / split / prune with
  the Adam moments following the rows, the opacity reset zeroing the
  opacity moments, the Morton bake: the same counts and rows as the JAX
  model on the same inputs.
* Checkpoints swap both ways, and a checkpoint served by both packages
  renders the same image (>= 45 dB).
* One training step of the two trainers on the same view: loss, the six
  parameter gradients and the viewspace gradient norm, and the parameters
  after the per-group Adam update.
* The whole trainer at tests/test_gaussian_splatting.py's end-to-end config
  (the JAX test's 14 dB bar) within a band of the JAX trainer's PSNR.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerficg_torch.core.config import ConfigNode as TConfig
from nerficg_torch.core.logging import Logger as TLogger
from nerficg_torch.core.registry import Datasets as TDatasets
from nerficg_torch.core.registry import Methods as TMethods
from nerficg_torch.core.setup import Directories as TDirectories
from nerficg_torch.data.synthetic import make_textured_scene
from nerficg_torch.data.types import BasicPointCloud as TCloud
from nerficg_torch.methods.gaussian_splatting.model import \
    GaussianSplattingModel as TModel
from nerficg_torch.optim.state_surgery import reset_rows as t_reset_rows
from nerficg_tpu.core.config import ConfigNode as JConfig
from nerficg_tpu.core.registry import Datasets as JDatasets
from nerficg_tpu.core.registry import Methods as JMethods
from nerficg_tpu.data.types import BasicPointCloud as JCloud
from nerficg_tpu.methods.gaussian_splatting.model import \
    GaussianSplattingModel as JModel
from nerficg_tpu.optim.state_surgery import reset_rows as j_reset_rows
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TLogger.set_level('SILENT')

KEYS = ('positions', 'features_dc', 'features_rest', 'scales', 'rotations',
        'opacities')
# The JAX trainer at the end-to-end config below, seed 0 on the blob scene:
# test PSNR 14.574 dB; seeds 1-3: 14.641, 14.524, 14.559 (spread 0.117 dB).
JAX_E2E_PSNR = 14.574
PSNR_BAND_DB = 2 * 0.117


def _cloud(n, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((n, 3)).astype(np.float32) * 2 - 1,
            rng.random((n, 3)).astype(np.float32))


def _models(n=64, granularity=128, sh=2):
    cfg = {'MODEL': {'SH_DEGREE': sh, 'CAPACITY_GRANULARITY': granularity}}
    pos, col = _cloud(n)
    j = JModel(JConfig(cfg))
    j.init_from_point_cloud(JCloud(pos, col))
    t = TModel(TConfig(cfg), device='cpu')
    t.init_from_point_cloud(TCloud(pos, col))
    return j, t


def _assert_params_equal(t, j, exact=True):
    assert t.num_active == j.num_active
    for key in KEYS:
        got, want = t.params_tree()[key], np.asarray(j.params[key])
        assert got.shape == want.shape, key
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=key)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=key)


def test_init_matches_jax():
    """Equal rows, padding and counts; log-scales from the two kNN paths
    within 1e-5."""
    j, t = _models()
    assert t.capacity == 128 and t.active_sh_degree == j.active_sh_degree
    _assert_params_equal(t, j, exact=False)
    assert (t.get_opacities(t.params)[64:] < 1e-5).all()


def _adam_states(t, j, rng):
    """The same nonzero Adam moments in a torch Adam over the port's
    parameters and an optax multi_transform state over the JAX ones."""
    moments = {key: (rng.normal(size=p.shape).astype(np.float32),
                     rng.random(p.shape).astype(np.float32))
               for key, p in t.params_tree().items()}
    opt = torch.optim.Adam([{'params': [t.params[key]], 'name': key}
                            for key in KEYS], lr=1e-3, eps=1e-15)
    for key, (mu, nu) in moments.items():
        opt.state[t.params[key]] = {'step': torch.tensor(3.0),
                                    'exp_avg': torch.tensor(mu),
                                    'exp_avg_sq': torch.tensor(nu)}
    j_opt = optax.multi_transform(
        {key: optax.adam(1e-3, eps=1e-15) for key in KEYS},
        param_labels={key: key for key in KEYS})

    def fill(item):
        if not isinstance(item, optax.ScaleByAdamState):
            return item
        return optax.ScaleByAdamState(
            count=item.count,
            mu={k: jnp.asarray(moments[k][0]) if hasattr(v, 'shape') else v
                for k, v in item.mu.items()},
            nu={k: jnp.asarray(moments[k][1]) if hasattr(v, 'shape') else v
                for k, v in item.nu.items()})

    state = jax.tree_util.tree_map(
        fill, j_opt.init(j.params),
        is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState))
    return opt, state


def _jax_moments(state):
    out = {}
    for item in jax.tree_util.tree_leaves(
            state, is_leaf=lambda x: isinstance(x, optax.ScaleByAdamState)):
        if isinstance(item, optax.ScaleByAdamState):
            for k, v in item.mu.items():
                if hasattr(v, 'shape'):
                    out[k] = (np.asarray(v), np.asarray(item.nu[k]))
    return out


def _assert_moments_equal(opt, t, j_state):
    want = _jax_moments(j_state)
    for key in KEYS:
        s = opt.state[t.params[key]]
        assert float(s['step']) == 3.0
        np.testing.assert_array_equal(s['exp_avg'].numpy(), want[key][0],
                                      err_msg=key)
        np.testing.assert_array_equal(s['exp_avg_sq'].numpy(), want[key][1],
                                      err_msg=key)


@pytest.mark.parametrize('case', ['clone', 'split', 'prune', 'mixed'])
def test_densify_matches_jax(case):
    """The same rows (split children drawn from the same generator), count
    and capacity; the moments follow the rows; the optimizer steps the new
    parameters."""
    j, t = _models()
    rng = np.random.default_rng(7)
    capacity = t.capacity
    grads = np.zeros(capacity, np.float32)
    counts = np.ones(capacity, np.float32)
    scales = t.params_tree()['scales']
    opac = t.params_tree()['opacities']
    max_radii = None
    extent = 100.0
    if case in ('clone', 'mixed'):
        grads[:8] = 1.0
    if case in ('split', 'mixed'):
        scales[:5] = np.log(10.0)
        grads[:5] = 1.0
        extent = 1.0 if case == 'split' else extent
    if case in ('prune', 'mixed'):
        opac[40:50] = -10.0
    if case == 'mixed':
        max_radii = rng.uniform(0, 40, capacity).astype(np.float32)
        counts[:64] = rng.integers(1, 4, 64)
        grads[10:30] = rng.uniform(0, 2, 20)
    for key, value in (('scales', scales), ('opacities', opac)):
        j.params[key] = jnp.asarray(value)
        t.params[key].data.copy_(torch.tensor(value))
    opt, j_state = _adam_states(t, j, rng)
    kwargs = dict(grad_threshold=0.5, scene_extent=extent,
                  max_screen_size=20.0 if max_radii is not None else None,
                  max_radii=max_radii)
    _, j_state = j.densify_and_prune(j_state, grads, counts, **kwargs)
    t.densify_and_prune(opt, grads, counts, **kwargs)
    expected = {'clone': 72, 'split': 69, 'prune': 54}.get(case)
    assert expected is None or t.num_active == expected
    _assert_params_equal(t, j)
    _assert_moments_equal(opt, t, j_state)
    assert {id(p) for g in opt.param_groups for p in g['params']} == \
        {id(p) for p in t.params.values()}


def test_opacity_reset_zeroes_moments():
    """Opacities clamped to 0.01 as the JAX model does; the opacity rows'
    moments zero, every other group's intact."""
    j, t = _models()
    opt, j_state = _adam_states(t, j, np.random.default_rng(3))
    mask = np.zeros(t.capacity, bool)
    mask[:t.num_active] = True
    j.reset_opacity()
    j_state = j_reset_rows(j_state, mask, param_key='opacities')
    t.reset_opacity()
    t_reset_rows(opt, t.params['opacities'], mask)
    _assert_params_equal(t, j)
    state = opt.state[t.params['opacities']]
    assert not state['exp_avg'][:64].any()
    assert not state['exp_avg_sq'][:64].any()
    _assert_moments_equal(opt, t, j_state)


def test_bake_matches_jax():
    """The same pruned set in the same Morton order."""
    j, t = _models(200, 128)
    opac = t.params_tree()['opacities']
    opac[::3] = -8.0                                   # below 1/255
    j.params['opacities'] = jnp.asarray(opac)
    t.params['opacities'].data.copy_(torch.tensor(opac))
    j.bake()
    t.bake()
    assert t.num_active == j.num_active < 200
    _assert_params_equal(t, j)


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    return make_textured_scene(tmp_path_factory.mktemp('gs_scene'),
                               image_size=32, n_train=8, n_test=2)


def _config(scene, cls, **training):
    return cls({
        'GLOBAL': {'METHOD_TYPE': 'GaussianSplatting', 'DATASET_TYPE': 'NeRF',
                   'RANDOM_SEED': 0, 'LOG_LEVEL': 'SILENT'},
        'DATASET': {'PATH': str(scene)},
        'MODEL': {'SH_DEGREE': 2, 'CAPACITY_GRANULARITY': 1024},
        'RENDERER': {'MAX_PER_TILE': 64},
        'TRAINING': {'RANDOM_POINTS': 512, 'RENDER_TESTSET': False,
                     'CHECKPOINT': {'FINAL': False},
                     'PRELOAD_DATASET': False, **training}})


def test_checkpoints_swap_both_ways(scene, tmp_path):
    """Port -> JAX and JAX -> port: equal parameters, count and SH degree;
    the checkpoint served by both packages agrees to >= 45 dB."""
    pos, col = _cloud(2000, seed=4)
    t = TModel(TConfig({'MODEL': {'SH_DEGREE': 2,
                                  'CAPACITY_GRANULARITY': 1024}}),
               device='cpu')
    t.init_from_point_cloud(TCloud(pos * 0.8, col))
    rest = np.random.default_rng(5).normal(
        size=t.params['features_rest'].shape).astype(np.float32) * 0.2
    t.params['features_rest'].data.copy_(torch.tensor(rest))
    t.active_sh_degree = 2
    t.save(tmp_path / 'port.ckpt')
    j = JModel.load(tmp_path / 'port.ckpt')
    assert (j.num_active, j.active_sh_degree) == (2000, 2)
    _assert_params_equal(t, j)
    j.save(tmp_path / 'jax.ckpt')
    back = TModel.load(tmp_path / 'jax.ckpt', device='cpu')
    assert (back.num_active, back.active_sh_degree) == (2000, 2)
    _assert_params_equal(back, j)

    t_cfg, j_cfg = _config(scene, TConfig), _config(scene, JConfig)
    t_view = TDatasets.get_dataset(t_cfg).subsets['test'][0]
    j_view = JDatasets.get_dataset(j_cfg).subsets['test'][0]
    t_rgb = TMethods.get_renderer(t_cfg, back).render_image(t_view)['rgb']
    j_rgb = JMethods.get_renderer(j_cfg, j).render_image(j_view)['rgb']
    mse = float(np.mean((t_rgb.numpy() - np.asarray(j_rgb)) ** 2))
    assert t_rgb.numpy().std() > 0.01
    assert -10 * np.log10(max(mse, 1e-20)) >= 45.0


def _rel_frobenius(got, want):
    return float(np.linalg.norm(got - want) /
                 max(np.linalg.norm(want), 1e-30))


def test_one_training_step_matches_jax(scene):
    """Both trainers set up from the same dataset (random points in its
    box), then one step on the same view: loss within 1e-5 relative; the
    six gradients and the viewspace norm within 1e-3 relative Frobenius.
    After Adam's first step, lr * g / (|g| + eps), each parameter within
    1e-6 where its gradient is above 1e-3 of its largest, and within 2 lr
    elsewhere: there the gradient is round-off (an isotropic Gaussian's
    rotation gradient is zero in exact arithmetic), and so is its sign."""
    t_cfg, j_cfg = _config(scene, TConfig), _config(scene, JConfig)
    j_ds = JDatasets.get_dataset(j_cfg)
    t_ds = TDatasets.get_dataset(t_cfg)
    np.testing.assert_allclose(t_ds.bounding_box.bounds,
                               j_ds.bounding_box.bounds, rtol=1e-6)
    j_tr = JMethods.get_training_instance(j_cfg)
    t_tr = TMethods.get_training_instance(t_cfg, device='cpu')
    j_tr._setup_gaussians(j_ds)
    t_tr._setup_gaussians(t_ds)
    assert t_tr.camera_extent == pytest.approx(j_tr.camera_extent, rel=1e-12)
    _assert_params_equal(t_tr.model, j_tr.model, exact=False)
    t_tr.model.load_params_tree({k: np.asarray(v) for k, v in
                                 j_tr.model.params.items()})
    t_tr._build_optimizer()

    j_view, t_view = j_ds.subsets['train'][3], t_ds.subsets['train'][3]
    intrinsics, w2c, cam = j_tr.renderer.view_constants(j_view)
    target = t_tr._target(3, t_view)
    bg = jnp.asarray(j_view.camera.background_color, jnp.float32)
    sh = j_tr.model.active_sh_degree
    n = j_tr.model.params['positions'].shape[0]

    def j_loss(params, offset):
        out = j_tr.renderer.render_impl(params, offset, w2c, cam,
                                        intrinsics=intrinsics, background=bg,
                                        sh_degree=sh)
        l1 = jnp.mean(jnp.abs(out['rgb'] - target.numpy()))
        from nerficg_tpu.optim.losses import dssim
        return 0.8 * l1 + 0.2 * dssim(out['rgb'], target.numpy())

    j_value, (j_grads, j_off) = jax.value_and_grad(j_loss, argnums=(0, 1))(
        j_tr.model.params, jnp.zeros((n, 2), jnp.float32))
    j_step = j_tr._get_train_step(intrinsics, sh, n)
    j_new, _, _ = j_step(j_tr.model.params, j_tr.opt_state, w2c, cam, bg,
                         jnp.asarray(target.numpy()), 0)

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
    t_tr.apply_update()
    lrs = {g['name']: g['lr'] for g in t_tr.optimizer.param_groups}
    for key in KEYS:
        got = t_tr.model.params[key].detach().numpy()
        want = np.asarray(j_new[key])
        g = np.abs(np.asarray(j_grads[key]))
        strong = g > 1e-3 * g.max()
        np.testing.assert_allclose(got[strong], want[strong], rtol=0,
                                   atol=1e-6, err_msg=key)
        assert np.abs(got - want).max() <= 2 * lrs[key] * (1 + 1e-5), key


def test_trainer_matches_jax_band(synthetic_dataset, tmp_path):
    """tests/test_gaussian_splatting.py's end-to-end config through the
    port's trainer: the JAX test's 14 dB bar, and within PSNR_BAND_DB (twice
    the JAX trainer's spread over seeds 1-3) of the JAX trainer's PSNR."""
    TDirectories.base = tmp_path / 'output'
    cfg = TConfig({
        'GLOBAL': {'METHOD_TYPE': 'GaussianSplatting', 'DATASET_TYPE': 'NeRF',
                   'RANDOM_SEED': 0, 'LOG_LEVEL': 'SILENT'},
        'MODEL': {'SH_DEGREE': 2, 'CAPACITY_GRANULARITY': 1024},
        'RENDERER': {'MAX_PER_TILE': 64},
        'TRAINING': {'NUM_ITERATIONS': 150, 'RANDOM_POINTS': 512,
                     'DENSIFY_FROM': 30, 'DENSIFY_UNTIL': 100,
                     'DENSIFY_INTERVAL': 50, 'OPACITY_RESET_INTERVAL': 10000,
                     'SH_UPDATE_INTERVAL': 50, 'RENDER_TESTSET': False,
                     'CHECKPOINT': {'FINAL': False},
                     'PRELOAD_DATASET': False}})
    dataset = TDatasets.get_dataset(cfg, path=str(synthetic_dataset))
    trainer = TMethods.get_training_instance(cfg, device='cpu')
    trainer.run(dataset)
    view = dataset.subsets['test'][0]
    pred = trainer.renderer.render_image(view)['rgb'].numpy()
    gt = view.rgb * view.alpha + \
        dataset.camera_settings.background_color * (1 - view.alpha)
    psnr = -10 * np.log10(max(float(np.mean((pred - gt) ** 2)), 1e-10))
    assert np.isfinite(pred).all()
    assert psnr > 14.0
    assert abs(psnr - JAX_E2E_PSNR) <= PSNR_BAND_DB, psnr


def test_backup_and_resume(synthetic_dataset, tmp_path):
    """A BACKUP.INTERVAL file resumes a fresh trainer with the Gaussian
    count, SH degree and Adam moments intact (tests/test_gaussian_splatting
    TestBackupResume, through the port)."""
    TDirectories.base = tmp_path / 'output'

    def make(iterations):
        return TConfig({
            'GLOBAL': {'METHOD_TYPE': 'GaussianSplatting',
                       'DATASET_TYPE': 'NeRF', 'RANDOM_SEED': 0,
                       'LOG_LEVEL': 'SILENT'},
            'MODEL': {'SH_DEGREE': 2, 'CAPACITY_GRANULARITY': 1024},
            'RENDERER': {'MAX_PER_TILE': 64},
            'TRAINING': {'NUM_ITERATIONS': iterations, 'RANDOM_POINTS': 256,
                         'DENSIFY_FROM': 4, 'DENSIFY_UNTIL': 8,
                         'DENSIFY_INTERVAL': 4,
                         'OPACITY_RESET_INTERVAL': 10000,
                         'SH_UPDATE_INTERVAL': 5, 'BACKUP': {'INTERVAL': 10},
                         'RENDER_TESTSET': False,
                         'CHECKPOINT': {'FINAL': False},
                         'PRELOAD_DATASET': False}})

    dataset = TDatasets.get_dataset(make(12), path=str(synthetic_dataset))
    trainer = TMethods.get_training_instance(make(12), device='cpu')
    trainer.run(dataset)
    backup = Path(trainer.output_dir) / 'latest.train'
    assert backup.is_file()
    resumed = TMethods.get_training_instance(make(14), device='cpu')
    resumed.load_training_state(backup)
    assert resumed.iteration == 11
    resumed.run(dataset)
    assert resumed.model.num_iterations_trained == 14
    assert resumed.updates == 14
    assert resumed.model.active_sh_degree >= 2
    assert any(float(s['exp_avg'].abs().sum()) > 0
               for s in resumed.optimizer.state.values())
