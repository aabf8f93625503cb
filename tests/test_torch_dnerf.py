"""The port's D-NeRF slice against the JAX package on the CPU.

Small width throughout: 4 levels at 2^11 entries, a 32 x 2 deformation MLP,
32^3 grids, 32 px images of ``make_dynamic_textured_scene`` (8 train views at
t = 0, 1/7, ..., 1; 2 test views at t = 0 and 1). Weights come from a numpy
seed and are carried to the port by the checkpoint tree. Both packages run
exact corners (STOCHASTIC_CORNERS=0, D-NeRF's default).

* Building blocks: the frequency encoding (1e-6), the deformation (identity
  at init and at t = 0; 1e-5 of JAX's after a shared perturbation), the
  field with timestamps and a grid refresh at a given time (densities and
  colours by ``_assert_bf16_close``), the offset prior on given points
  (1e-5 relative), a rendered test view (>= 45 dB),
  ``optax_exponential_decay`` (1e-6 relative over 0..N) and the loader's
  normalised timestamps.
* Training: one exact step through the trainer's own code with the JAX
  step's march seed and offset-prior points. Loss to 1e-5 relative, every
  gradient (deformation MLP included, all non-zero) to FROBENIUS_RTOL
  relative Frobenius error, the bf16 noise floor of tests/
  test_torch_training.py. (The deformation's gradient, which flows through
  the cancelling sum of the position gradient, is noisier: JAX's own
  jitted and eager gradients of this step differ by up to 2.9e-2 in its
  first layer over seeds 7-16; at seed 7 both they and the port stay
  below 1e-2.) The two-group Adam's first update moves each
  group by its own rate; its state survives the resume file.
* The whole trainer: ``nerficg_torch.scripts.train.main`` and the JAX trainer
  for 200 iterations from seed 0. The test PSNRs must lie within
  PSNR_BAND_DB, twice the JAX package's own spread over seeds 0-2 at this
  config (19.54, 19.89, 20.45 dB: 0.91 dB): the two trainers draw
  different march jitter, refresh times and prior points. The port's
  final.ckpt loads in the JAX model, and the JAX one in the port.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerficg_torch.core.config import ConfigNode as TConfigNode
from nerficg_torch.core.config import save_config
from nerficg_torch.core.logging import Logger as TLogger
from nerficg_torch.core.registry import Datasets as TDatasets
from nerficg_torch.core.registry import Methods as TMethods
from nerficg_torch.data.synthetic import make_dynamic_textured_scene
from nerficg_torch.ops.encoding import frequency_encode
from nerficg_torch.optim.lr import optax_exponential_decay
from nerficg_tpu.core.config import ConfigNode as JConfigNode
from nerficg_tpu.core.registry import Datasets as JDatasets
from nerficg_tpu.core.registry import Methods as JMethods
from nerficg_tpu.core.setup import Directories as JDirectories
from nerficg_tpu.data import synthetic as jsynthetic
from nerficg_tpu.ops import encoding as jencoding
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TLogger.set_level('SILENT')

LOSS_RTOL = 1e-5
FROBENIUS_RTOL = 2e-2
MIN_PSNR_DB = 45.0
BF16_FLIP_RTOL = 2e-3
PSNR_BAND_DB = 2 * 0.91
MLPS = ('density_mlp', 'color_mlp', 'deform_mlp')


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp('dynamic32')
    return make_dynamic_textured_scene(root, image_size=32, n_train=8,
                                       n_test=2)


def _config(scene, iterations=200, seed=0):
    return {'GLOBAL': {'METHOD_TYPE': 'DNeRF', 'DATASET_TYPE': 'DNeRF',
                       'RANDOM_SEED': seed, 'LOG_LEVEL': 'SILENT',
                       'NUM_DEVICES': 1},
            'DATASET': {'PATH': str(scene)},
            'MODEL': {'NUM_LEVELS': 4, 'LOG2_HASHMAP_SIZE': 11,
                      'BASE_RESOLUTION': 4, 'TARGET_RESOLUTION': 64,
                      'GRID_RESOLUTION': 32, 'SCALE': 1.0,
                      'DEFORM_WIDTH': 32, 'DEFORM_LAYERS': 2},
            'RENDERER': {'MAX_SAMPLES': 64, 'RAY_BATCH_SIZE': 1024,
                         'OCCUPANCY_SAMPLES': 4096},
            'TRAINING': {'NUM_ITERATIONS': iterations,
                         'INITIAL_RAYS_PER_BATCH': 256,
                         'TARGET_BATCH_SIZE': 8192, 'RENDER_TESTSET': True,
                         'MODEL_NAME': 'parity'}}


def _shell_grid(resolution, cascades, scale):
    """1e3 on a 6-cell shell at radius 0.8 * scale in every cascade."""
    grids = []
    for c in range(cascades):
        half = scale / 2 ** (cascades - 1) * 2 ** c
        ax = ((np.arange(resolution) + 0.5) / resolution - 0.5) * 2 * half
        x, y, z = np.meshgrid(ax, ax, ax, indexing='ij')
        r = np.sqrt(x * x + y * y + z * z)
        cell = 2 * half / resolution
        grids.append(np.where(np.abs(r - 0.8 * scale) <= 3 * cell, 1e3, 0.0)
                     .reshape(-1))
    return np.concatenate(grids).astype(np.float32)


def _tree(shapes, seed=0, deform_out=0.05):
    """Table U(-0.1, 0.1), He-uniform MLPs, the deformation's output layer
    U(-deform_out, deform_out) (so that every layer has a gradient)."""
    rng = np.random.default_rng(seed)

    def he_uniform(w):
        bound = np.sqrt(6.0 / w.shape[0])
        return rng.uniform(-bound, bound, w.shape).astype(np.float32)
    tree = {'hash_table': rng.uniform(-0.1, 0.1, shapes['hash_table'].shape
                                      ).astype(np.float32)}
    for name in MLPS:
        tree[name] = [he_uniform(np.asarray(w)) for w in shapes[name]]
    tree['deform_mlp'][-1] = rng.uniform(
        -deform_out, deform_out, tree['deform_mlp'][-1].shape).astype(
        np.float32)
    return tree


def _assert_bf16_close(got, want):
    """99.9% of the elements to 1e-5 relative, all to BF16_FLIP_RTOL: the
    deformation's sin/cos may differ by an ulp between XLA and torch, and
    where that flips the bf16 rounding of an MLP operand, the output moves
    by a fraction of 2^-8 of one product."""
    got, want = np.asarray(got), np.asarray(want)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-6)
    assert float((rel <= 1e-5).mean()) >= 0.999
    assert float(rel.max()) <= BF16_FLIP_RTOL, float(rel.max())


def _jax_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _models(scene, seed=0):
    """A JAX and a port model with the same weights and shell grid."""
    cfg = _config(scene)
    jm = JMethods.get_model(JConfigNode(cfg))
    tm = TMethods.get_model(TConfigNode(cfg), device='cpu')
    tree = _tree(jm.params, seed)
    jm.params = _jax_tree(tree)
    tm.load_params_tree(tree)
    grid = _shell_grid(32, jm.cascades, 1.0)
    jm.buffers['density_grid'] = jnp.asarray(grid)
    tm.buffers['density_grid'] = torch.from_numpy(grid)
    return cfg, jm, tm


def test_frequency_encode_matches():
    x = np.random.default_rng(0).uniform(-1.5, 1.5, (257, 3)).astype(
        np.float32)
    for freqs, include in ((6, True), (4, False), (0, True)):
        want = np.asarray(jencoding.frequency_encode(jnp.asarray(x), freqs,
                                                     include_input=include))
        got = frequency_encode(torch.from_numpy(x), freqs, include).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_deform_identity_then_matches_jax(scene):
    """Identity at init (zero output layer) at every time; with the same
    random weights, identity at t = 0 and JAX's warp elsewhere to 1e-5."""
    cfg = _config(scene)
    tm = TMethods.get_model(TConfigNode(cfg), device='cpu')
    rng = np.random.default_rng(1)
    pos = rng.uniform(-1, 1, (512, 3)).astype(np.float32)
    times = rng.uniform(0, 1, 512).astype(np.float32)
    times[:64] = 0.0
    p_t, t_t = torch.from_numpy(pos), torch.from_numpy(times)
    with torch.no_grad():
        assert torch.equal(tm.deform(p_t, t_t), p_t)
    _, jm, tm = _models(scene, seed=2)
    want = np.asarray(jm.deform(jm.params, jnp.asarray(pos),
                                jnp.asarray(times)))
    with torch.no_grad():
        got = tm.deform(p_t, t_t).numpy()
    np.testing.assert_array_equal(got[:64], pos[:64])
    assert np.abs(got[64:] - pos[64:]).max() > 1e-3
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_field_with_timestamps_matches_jax(scene):
    _, jm, tm = _models(scene, seed=3)
    rng = np.random.default_rng(3)
    pos = rng.uniform(-0.9, 0.9, (2048, 3)).astype(np.float32)
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    times = rng.uniform(0, 1, 2048).astype(np.float32)
    sigma_j, rgb_j = jm.field(jm.params, jnp.asarray(pos), jnp.asarray(d),
                              timestamps=jnp.asarray(times))
    with torch.no_grad():
        sigma_t, rgb_t = tm.field(torch.from_numpy(pos), torch.from_numpy(d),
                                  timestamps=torch.from_numpy(times))
    _assert_bf16_close(rgb_t.numpy(), rgb_j)
    _assert_bf16_close(sigma_t.numpy(), sigma_j)


def test_render_with_timestamps_matches_jax(scene, tmp_path):
    """The t = 1 test view from one JAX checkpoint rendered by both
    packages: rgb and alpha to MIN_PSNR_DB."""
    cfg, jm, _ = _models(scene, seed=4)
    ckpt = tmp_path / 'final.ckpt'
    jm.save(ckpt)
    view_j = JDatasets.get_dataset(JConfigNode(cfg)).subsets['test'][1]
    view_t = TDatasets.get_dataset(TConfigNode(cfg)).subsets['test'][1]
    assert view_t.timestamp == view_j.timestamp == 1.0
    want = JMethods.get_renderer(JConfigNode(cfg), jm).render_image(view_j)
    tm = TMethods.get_model(TConfigNode(cfg), checkpoint=str(ckpt),
                            device='cpu')
    got = TMethods.get_renderer(TConfigNode(cfg), tm).render_image(view_t)
    assert float(got['alpha'].mean()) > 0.01
    for key in ('rgb', 'alpha'):
        a, b = np.asarray(want[key]), got[key].numpy()
        psnr = -10 * np.log10(max(float(np.mean((a - b) ** 2)), 1e-20))
        assert psnr >= MIN_PSNR_DB, f'{key}: {psnr:.1f} dB'


@pytest.mark.parametrize('warmup,key', [(True, 0), (False, 3)])
def test_grid_refresh_at_a_time_matches_jax(scene, warmup, key):
    """One D-NeRF grid refresh with JAX's draws, its time (fold_in 13) and
    the port's refresh at that time: grids to 1e-5 relative."""
    from test_torch_occupancy import _jax_grid_draws
    cfg, jm, tm = _models(scene, seed=5)
    jr = JMethods.get_renderer(JConfigNode(cfg), jm)
    tr = TMethods.get_renderer(TConfigNode(cfg), tm)
    rng = np.random.default_rng(5)
    total = jm.buffers['density_grid'].shape[0]
    grid = np.where(rng.uniform(size=total) < 0.3,
                    rng.uniform(0, 2, total), 0.0).astype(np.float32)
    jkey = jax.random.PRNGKey(key)
    want = jr._update_grid_impl(jm.params, jnp.asarray(grid), jkey,
                                warmup=warmup)
    time = float(jax.random.uniform(jax.random.fold_in(jkey, 13), ()))
    draws = _jax_grid_draws(jkey, grid.shape[0], int(jr.OCCUPANCY_SAMPLES),
                            warmup, float(jr.OCCUPANCY_OCCUPIED_BIAS), grid,
                            0.0)
    got = tr._update_grid_impl(torch.from_numpy(grid), draws, 0, time=time)
    assert draws.biased == (not warmup)
    _assert_bf16_close(got.numpy(), want)


def _trainers(scene, seed=0):
    """A JAX and a port trainer with the same weights and density grid,
    ray pools built."""
    cfg = _config(scene)
    jt = JMethods.get_training_instance(JConfigNode(cfg))
    tt = TMethods.get_training_instance(TConfigNode(cfg), device='cpu')
    tree = _tree(jt.model.params, seed)
    jt.model.params = _jax_tree(tree)
    tt.model.load_params_tree(tree)
    grid = _shell_grid(32, 2, 1.0)
    jt.model.buffers['density_grid'] = jnp.asarray(grid)
    tt.model.buffers['density_grid'] = torch.from_numpy(grid)
    jt.opt_state = None
    jt._init_samplers(JDatasets.get_dataset(JConfigNode(cfg)))
    tt._init_samplers(TDatasets.get_dataset(TConfigNode(cfg)))
    return jt, tt


def test_offset_prior_matches_jax(scene):
    """The prior on the points JAX draws from a key, given to the port."""
    jt, tt = _trainers(scene, seed=6)
    key = jax.random.PRNGKey(6)
    term, logs = jt._loss_extras(jt.model.params, key)
    kp, kt = jax.random.split(jax.random.fold_in(key, 0x0FF5E7))
    n = int(jt.OFFSET_REG_POINTS)
    pos = jax.random.uniform(kp, (n, 3), jnp.float32,
                             minval=jt.model.aabb_min,
                             maxval=jt.model.aabb_max)
    times = jax.random.uniform(kt, (n,), jnp.float32)
    pos_t = torch.from_numpy(np.array(pos))
    times_t = torch.from_numpy(np.array(times))
    with torch.no_grad():
        reg = tt.offset_prior(pos_t, times_t)
        assert float(reg) > 0.0
        assert float(reg) == pytest.approx(float(logs['offset_reg']),
                                           rel=1e-5)
        tt._draw_offset_points = lambda _: (pos_t, times_t)
        t_term, t_logs = tt._loss_extras()
    assert float(t_term) == pytest.approx(float(term), rel=1e-5)
    assert set(t_logs) == set(logs) == {'offset_reg'}


def _grad_tree(module):
    from nerficg_torch.methods.instant_ngp.convert import params_to_numpy
    return params_to_numpy({k: p.grad for k, p in module.named_parameters()})


def test_one_step_matches_jax(scene):
    """One exact training step: loss to LOSS_RTOL, every gradient to
    FROBENIUS_RTOL relative Frobenius error and non-zero."""
    jt, tt = _trainers(scene, seed=7)
    key = jax.random.PRNGKey(11)
    ids = jt._np_rng.integers(0, jt._pool_size, size=256)
    bg = jt._np_rng.random(3).astype(np.float32)
    jr = jt.renderer
    n = ids.shape[0]
    spr = min(max(int(jt.TARGET_BATCH_SIZE) // n, 4), int(jr.MAX_SAMPLES))
    pool = jt._pool
    target = pool['rgb'][ids] * pool['alpha'][ids] + \
        jnp.asarray(bg) * (1.0 - pool['alpha'][ids])
    grid = jr.grid_binary()
    times = pool['timestamps'][ids]
    assert float(jnp.max(times)) == 1.0 and float(jnp.min(times)) == 0.0

    @jax.jit
    def loss_fn(p):       # nerficg_tpu trainer.py:172-192
        out = jr._render_rays_impl(p, grid, pool['origins'][ids],
                                   pool['directions'][ids], key,
                                   jnp.asarray(bg), randomized=True,
                                   num_rays=n, samples_per_ray=spr,
                                   timestamps=times)
        mask = out['ray_mask']
        color = jnp.sum((out['rgb'] - target) ** 2 * mask) / \
            jnp.maximum(jnp.sum(mask) * 3.0, 1.0)
        extra, _ = jt._loss_extras(p, key)
        return color + float(jt.WEIGHT_DECAY) * \
            jr.model.mlp_weight_squares(p) + extra

    loss_j, grads_j = jax.value_and_grad(loss_fn)(jt.model.params)
    kp, kt = jax.random.split(jax.random.fold_in(key, 0x0FF5E7))
    m = int(jt.OFFSET_REG_POINTS)
    pos = np.array(jax.random.uniform(kp, (m, 3), jnp.float32,
                                      minval=jt.model.aabb_min,
                                      maxval=jt.model.aabb_max))
    t_reg = np.array(jax.random.uniform(kt, (m,), jnp.float32))
    tt._draw_offset_points = lambda _: (torch.from_numpy(pos),
                                        torch.from_numpy(t_reg))
    logs = tt.loss_and_grads(torch.from_numpy(ids), torch.from_numpy(bg),
                             int(jax.random.bits(key, dtype=jnp.uint32)), 0)
    assert float(logs['num_samples']) > 1000
    assert float(logs['total']) == pytest.approx(float(loss_j),
                                                 rel=LOSS_RTOL)
    got = _grad_tree(tt.model.module)
    for name in ('hash_table',) + MLPS:
        g_list = [got[name]] if name == 'hash_table' else got[name]
        w_list = [grads_j[name]] if name == 'hash_table' else grads_j[name]
        assert len(g_list) == len(w_list)
        for i, (g, w) in enumerate(zip(g_list, w_list)):
            w = np.asarray(w)
            norm = np.linalg.norm(w)
            assert norm > 0.0 and np.linalg.norm(g) > 0.0, f'{name}[{i}]'
            err = np.linalg.norm(g - w) / norm
            assert err <= FROBENIUS_RTOL, f'{name}[{i}]: {err:.2e}'


def test_exponential_decay_matches_optax():
    want = optax.exponential_decay(1e-3, transition_steps=300,
                                   decay_rate=0.1)
    got = optax_exponential_decay(1e-3, 300, 0.1)
    for step in range(301):
        assert got(step) == pytest.approx(float(want(step)), rel=1e-6)


def test_two_group_adam_and_resume(scene, tmp_path):
    """The first Adam update moves each group by about its own rate (LR
    for the field, DEFORM_LR for the deformation), and both groups' state
    survives the resume file."""
    cfg = TConfigNode(_config(scene, iterations=4))
    trainer = TMethods.get_training_instance(cfg, device='cpu')
    module = trainer.model.module
    before = {n: p.detach().clone() for n, p in module.named_parameters()}
    for p in module.parameters():
        p.grad = torch.ones_like(p)
    trainer.apply_update()
    for name, p in module.named_parameters():
        step = float((p.detach() - before[name]).abs().mean())
        lr = trainer.DEFORM_LR if name.startswith('deform_mlp.') \
            else trainer.LR
        assert step == pytest.approx(float(lr), rel=1e-2), name
    trainer.save_training_state(tmp_path / 'latest.train', iteration=1)
    resumed = TMethods.get_training_instance(cfg, device='cpu')
    resumed.load_training_state(tmp_path / 'latest.train')
    resumed._apply_pending_resume()
    assert resumed.updates == 1
    names = {n for n, _ in module.named_parameters()}
    assert any(n.startswith('deform_mlp.') for n in names)
    state = resumed.get_optimizer_state()
    assert set(state['exp_avg']) == names
    for group_a, group_b in zip(trainer.optimizer.param_groups,
                                resumed.optimizer.param_groups):
        for p, q in zip(group_a['params'], group_b['params']):
            for k in ('exp_avg', 'exp_avg_sq'):
                assert torch.equal(trainer.optimizer.state[p][k],
                                   resumed.optimizer.state[q][k])


def test_loader_normalises_timestamps(scene):
    """Timestamps divided by their maximum, as the JAX loader's, on a copy
    of the scene whose times are scaled by 4."""
    import json
    import shutil
    cfg = _config(scene)
    views = TDatasets.get_dataset(TConfigNode(cfg)).subsets
    jviews = JDatasets.get_dataset(JConfigNode(cfg)).subsets
    for split in ('train', 'test'):
        times = [v.timestamp for v in views[split]]
        assert times == [v.timestamp for v in jviews[split]]
    assert views['train'][0].timestamp == 0.0
    assert views['train'][-1].timestamp == 1.0
    scaled = Path(str(scene) + '_scaled')
    shutil.copytree(scene, scaled, dirs_exist_ok=True)
    for split in ('train', 'test'):
        path = scaled / f'transforms_{split}.json'
        meta = json.loads(path.read_text())
        for frame in meta['frames']:
            frame['time'] *= 4.0
        path.write_text(json.dumps(meta))
    cfg['DATASET']['PATH'] = str(scaled)
    again = TDatasets.get_dataset(TConfigNode(cfg)).subsets
    for split in ('train', 'test'):
        assert [v.timestamp for v in again[split]] == \
            [v.timestamp for v in views[split]]
    assert TDatasets.get_dataset(TConfigNode(cfg)).camera_settings \
        .background_color.tolist() == [1.0, 1.0, 1.0]


def test_dynamic_scene_bytes_match_jax(tmp_path):
    jsynthetic.make_dynamic_textured_scene(tmp_path / 'jax', image_size=24,
                                           n_train=3, n_test=2)
    make_dynamic_textured_scene(tmp_path / 'port', image_size=24, n_train=3,
                                n_test=2)
    files = sorted(p.relative_to(tmp_path / 'jax')
                   for p in (tmp_path / 'jax').rglob('*') if p.is_file())
    assert len(files) == 7
    for name in files:
        assert (tmp_path / 'jax' / name).read_bytes() == \
            (tmp_path / 'port' / name).read_bytes(), name


def test_pos_grad_needs_the_crossbar(scene):
    cfg = _config(scene)
    for backend in ('window', 'cell'):
        cfg['MODEL']['ENCODING_BACKEND'] = backend
        with pytest.raises(ValueError, match='position-gradient'):
            TMethods.get_model(TConfigNode(cfg), device='cpu')


def test_trainer_matches_jax_psnr(scene, tmp_path, monkeypatch):
    """200 iterations of each package's trainer, same config and seed;
    checkpoints swapped both ways."""
    from nerficg_torch.core.setup import Directories as TDirectories
    from nerficg_torch.scripts import train
    cfg = _config(scene)
    monkeypatch.setattr(JDirectories, 'base', tmp_path / 'jax')
    monkeypatch.setattr(TDirectories, 'base', tmp_path / 'port')
    jt = JMethods.get_training_instance(JConfigNode(cfg))
    jt.run(JDatasets.get_dataset(JConfigNode(cfg)))
    jax_line = (jt.output_dir / 'test' / 'metrics_8bit.txt').read_text(
        ).splitlines()[-1]
    jax_psnr = float(jax_line.split('PSNR=')[1].split()[0])

    save_config(TConfigNode(cfg), tmp_path / 'port.yaml')
    result = train.main(['-c', str(tmp_path / 'port.yaml'), '--device',
                         'cpu'])
    port_psnr = result['metrics']['PSNR']
    assert np.isfinite(port_psnr)
    assert abs(port_psnr - jax_psnr) <= PSNR_BAND_DB, (port_psnr, jax_psnr)
    trainer = result['trainer']
    losses = torch.stack(trainer.losses)
    assert losses[-20:].mean() < 0.5 * losses[:20].mean()
    assert float(trainer.model.module.deform_mlp[-1].weight.abs().max()) > 0

    run = Path(result['output_dir'])
    jm = JMethods.get_model(JConfigNode(cfg),
                            checkpoint=str(run / 'checkpoints' / 'final.ckpt'))
    tree = trainer.model.params_tree()
    for name in MLPS:
        for w_j, w_t in zip(jm.params[name], tree[name]):
            np.testing.assert_array_equal(np.asarray(w_j), w_t)
    tm = TMethods.get_model(
        TConfigNode(cfg), device='cpu',
        checkpoint=str(jt.output_dir / 'checkpoints' / 'final.ckpt'))
    for w_j, layer in zip(jt.model.params['deform_mlp'],
                          tm.module.deform_mlp):
        np.testing.assert_array_equal(np.asarray(w_j).T,
                                      layer.weight.detach().numpy())
