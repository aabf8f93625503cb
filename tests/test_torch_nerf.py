"""The port's vanilla NeRF slice against the JAX package on the CPU.

Inputs are made from numpy seeds and handed to both packages; random draws
(the stratified and PDF uniforms) are JAX's, passed to the port.

* Ops, 1e-6 absolute unless stated: ray/AABB and ray/sphere (hits,
  misses, zero direction components), stratified and PDF samples (JAX's
  uniforms, the deterministic draws, draws exactly on a CDF value, which
  take the bin to their right; on weights whose CDF is exact in f32, and
  at PDF_ATOL on others, see there), the sorted merge, compositing with a mask
  and early stopping and its gradients against ``jax.grad`` (1e-5), the
  distortion loss, ``mse`` and ``LossContainer``.
* NeRF: one library-width block's outputs with the weights carried by
  convert.py (99% within 1e-5, all within 1e-4: bf16 roundings, see the
  test); a deterministic render of a 3 x 64 model with a coarse block and
  48 samples (PSNR >= 45 dB and a mean absolute error <= 1e-4 in rgb and
  alpha: the fine samples follow the coarse weights, so a pixel whose
  weights moved in their last bits samples elsewhere); one
  training step with JAX's draws (loss 1e-5 relative; gradients 2e-2
  relative Frobenius, the bf16 floor of tests/test_torch_training.py); a
  100-iteration run of each package's trainer on a 32 px textured scene,
  whose test PSNRs must lie within PSNR_BAND_DB; checkpoints both ways.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerficg_torch.core.checkpoint import flatten_tree, load_checkpoint
from nerficg_torch.core.config import ConfigNode as TConfigNode
from nerficg_torch.core.config import save_config
from nerficg_torch.core.logging import Logger as TLogger
from nerficg_torch.core.registry import Datasets as TDatasets
from nerficg_torch.core.registry import Methods as TMethods
from nerficg_torch.data.synthetic import make_textured_scene
from nerficg_torch.methods.nerf.convert import (params_from_numpy,
                                                params_to_numpy)
from nerficg_torch.methods.nerf.model import NeRFBlock
from nerficg_torch.ops import compositing as tcomp
from nerficg_torch.ops import ray_aabb as tray
from nerficg_torch.ops import sampling as tsamp
from nerficg_torch.optim import losses as tloss
from nerficg_tpu.core.config import ConfigNode as JConfigNode
from nerficg_tpu.core.registry import Datasets as JDatasets
from nerficg_tpu.core.registry import Methods as JMethods
from nerficg_tpu.core.setup import Directories as JDirectories
from nerficg_tpu.methods.nerf import model as jmodel
from nerficg_tpu.ops import compositing as jcomp
from nerficg_tpu.ops import ray_aabb as jray
from nerficg_tpu.ops import sampling as jsamp
from nerficg_tpu.optim import losses as jloss
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

TLogger.set_level('SILENT')

ATOL = 1e-6
GRAD_ATOL = 1e-5
BLOCK_ATOL = 1e-5
BLOCK_SHARE = 0.99
RENDER_MAE = 1e-4
MIN_PSNR_DB = 45.0
LOSS_RTOL = 1e-5
FROBENIUS_RTOL = 2e-2
# Twice the JAX package's own spread of the test PSNR over seeds 1-3 at
# this config (19.498, 19.464 and 19.716 dB: 0.253 dB), as
# tests/test_torch_training.py sets its band: the two trainers draw
# different samples.
PSNR_BAND_DB = 2 * 0.253


def t(x):
    return torch.from_numpy(np.array(x))


def close(got, want, atol=ATOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0,
                               atol=atol)


# -- ops ----------------------------------------------------------------------

def _rays(n, seed=0):
    rng = np.random.default_rng(seed)
    o = rng.uniform(-3, 3, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[:8, rng.integers(0, 3, 8)] = 0.0           # zero components
    d[8:12, 0] = -0.0
    return o, d


def test_ray_aabb_intersect():
    o, d = _rays(512)
    lo = np.asarray([-1.0, -0.5, -1.5], np.float32)
    hi = np.asarray([1.0, 0.7, 0.5], np.float32)
    want = jray.ray_aabb_intersect(jnp.asarray(o), jnp.asarray(d),
                                   jnp.asarray(lo), jnp.asarray(hi), 0.05)
    got = tray.ray_aabb_intersect(t(o), t(d), t(lo), t(hi), 0.05)
    hits = np.asarray(want[0] < want[1])
    assert 0 < hits.sum() < len(hits)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=ATOL)


def test_ray_sphere_intersect():
    o, d = _rays(512, seed=1)
    c = np.asarray([0.2, -0.1, 0.3], np.float32)
    want = jray.ray_sphere_intersect(jnp.asarray(o), jnp.asarray(d),
                                     jnp.asarray(c), 1.2, 0.1)
    got = tray.ray_sphere_intersect(t(o), t(d), t(c), 1.2, 0.1)
    hits = np.asarray(want[1]) > 0
    assert 0 < hits.sum() < len(hits)
    for g, w in zip(got, want):
        close(g, w, 1e-5)


def test_stratified_samples():
    key = jax.random.PRNGKey(3)
    u = np.asarray(jax.random.uniform(key, (64, 24)))
    near, far = np.float32(2.0), np.float32(6.0)
    want = jsamp.stratified_samples(key, 64, 24, near, far, True)
    close(tsamp.stratified_samples(None, 64, 24, float(near), float(far),
                                   u=t(u)), want)
    close(tsamp.stratified_samples(None, 64, 24, torch.tensor(2.0),
                                   torch.tensor(6.0), randomized=False),
          jsamp.stratified_samples(key, 64, 24, near, far, False))
    gen = torch.Generator().manual_seed(0)
    drawn = tsamp.stratified_samples(gen, 64, 24, 2.0, 6.0)
    assert drawn.shape == (64, 24) and bool((drawn[:, 1:] > drawn[:, :-1])
                                            .all())


def _pdf_inputs(seed=0, rays=48, segments=16):
    rng = np.random.default_rng(seed)
    bins = np.sort(rng.uniform(2, 6, (rays, segments + 1)), -1).astype(
        np.float32)
    w = rng.uniform(0, 1, (rays, segments)).astype(np.float32)
    w[rng.uniform(size=w.shape) < 0.4] = 0.0
    w[0] = 0.0                                  # all-zero weights
    return bins, w


def _dyadic_pdf_inputs(seed=0, rays=48, segments=16):
    """Weights in multiples of 2^-10 that, with DYADIC_EPS added to each,
    sum to 1: every PDF and CDF value is exact in f32 whatever the order
    of the sums."""
    bins, _ = _pdf_inputs(seed, rays, segments)
    rng = np.random.default_rng(seed + 100)
    counts = rng.multinomial(1024 - segments, np.ones(segments) / segments,
                             rays)
    counts[1] = 0
    counts[1, 3] = 1024 - segments               # one spike
    return bins, (counts * DYADIC_EPS).astype(np.float32)


DYADIC_EPS = 2.0 ** -10
# Where the CDF is not exact, the packages sum in another order (JAX on the
# CPU left to right in f32; torch's CPU cumsum accumulates in f64 and its
# sum is pairwise), so a CDF value may differ in its last bit, which moves
# a sample by up to an ulp over the span of its bin, times the bin's width.
PDF_ATOL = 1e-4


def test_sample_pdf():
    key = jax.random.PRNGKey(5)
    u = np.asarray(jax.random.uniform(key, (48, 32)))
    bins, w = _dyadic_pdf_inputs()
    for randomized in (True, False):
        want = jsamp.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 32,
                                randomized, eps=DYADIC_EPS)
        got = tsamp.sample_pdf(None, t(bins), t(w), 32, randomized,
                               eps=DYADIC_EPS, u=t(u) if randomized else None)
        close(got, want)
    bins, w = _pdf_inputs()
    want = jsamp.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 32, True)
    close(tsamp.sample_pdf(None, t(bins), t(w), 32, u=t(u)), want, PDF_ATOL)
    close(tsamp.sample_pdf(None, t(bins), t(w), 32, randomized=False),
          jsamp.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 32,
                           False), PDF_ATOL)


def test_sample_pdf_on_cdf_values(monkeypatch):
    """Draws equal to a CDF value take the bin to their right in both
    packages (searchsorted side='right'): the sample is that bin's start."""
    bins, w = _dyadic_pdf_inputs(seed=1, segments=8)
    u = np.cumsum(w + np.float32(DYADIC_EPS), -1)[:, :7]
    # JAX draws its uniforms inside sample_pdf: hand it these values.
    monkeypatch.setattr(jax.random, 'uniform', lambda *a, **k: jnp.asarray(u))
    want = jsamp.sample_pdf(jax.random.PRNGKey(0), jnp.asarray(bins),
                            jnp.asarray(w), 7, True, eps=DYADIC_EPS)
    got = tsamp.sample_pdf(None, t(bins), t(w), 7, eps=DYADIC_EPS, u=t(u))
    close(got, want)
    np.testing.assert_array_equal(got.numpy(), bins[:, 1:8])


def test_merge_sorted_samples():
    rng = np.random.default_rng(2)
    a = np.sort(rng.uniform(2, 6, (32, 16)), -1).astype(np.float32)
    b = rng.uniform(2, 6, (32, 24)).astype(np.float32)
    close(tsamp.merge_sorted_samples(t(a), t(b)),
          jsamp.merge_sorted_samples(jnp.asarray(a), jnp.asarray(b)), 0.0)


def _composite_inputs(seed=0, rays=32, samples=40):
    rng = np.random.default_rng(seed)
    rgb = rng.uniform(0, 1, (rays, samples, 3)).astype(np.float32)
    sigma = rng.exponential(2.0, (rays, samples)).astype(np.float32)
    sigma[:4] *= 50.0                           # opaque rays stop early
    depths = np.sort(rng.uniform(2, 6, (rays, samples)), -1).astype(
        np.float32)
    deltas = np.diff(depths, axis=-1, append=6.0).astype(np.float32)
    mask = (rng.uniform(size=(rays, samples)) < 0.8).astype(np.float32)
    bg = np.asarray([0.2, 0.5, 0.9], np.float32)
    return rgb, sigma, depths, deltas, mask, bg


@pytest.mark.parametrize('masked,eps', [(False, 0.0), (True, 1e-4)])
def test_composite_rays(masked, eps):
    rgb, sigma, depths, deltas, mask, bg = _composite_inputs()
    m = mask if masked else None
    want = jcomp.composite_rays(
        jnp.asarray(rgb), jnp.asarray(sigma), jnp.asarray(depths),
        jnp.asarray(deltas), jnp.asarray(bg),
        None if m is None else jnp.asarray(m), eps)
    got = tcomp.composite_rays(t(rgb), t(sigma), t(depths), t(deltas), t(bg),
                               None if m is None else t(m), eps)
    for key in ('rgb', 'alpha', 'weights'):
        close(got[key], want[key])
    close(got['depth'], want['depth'], 1e-5)     # depths up to 6

    def jloss_fn(rgb_, sigma_):
        out = jcomp.composite_rays(rgb_, sigma_, jnp.asarray(depths),
                                   jnp.asarray(deltas), jnp.asarray(bg),
                                   None if m is None else jnp.asarray(m),
                                   eps)
        return jnp.sum(out['rgb'] ** 2) + jnp.sum(out['depth']) * 0.1
    g_rgb, g_sigma = jax.grad(jloss_fn, argnums=(0, 1))(jnp.asarray(rgb),
                                                        jnp.asarray(sigma))
    rgb_t, sigma_t = t(rgb).requires_grad_(), t(sigma).requires_grad_()
    out = tcomp.composite_rays(rgb_t, sigma_t, t(depths), t(deltas), t(bg),
                               None if m is None else t(m), eps)
    (torch.sum(out['rgb'] ** 2) + torch.sum(out['depth']) * 0.1).backward()
    close(rgb_t.grad, g_rgb, GRAD_ATOL)
    close(sigma_t.grad, g_sigma, GRAD_ATOL)


def test_distortion_loss():
    _, sigma, depths, deltas, mask, _ = _composite_inputs(seed=3)
    w = np.asarray(jcomp.densities_to_weights(jnp.asarray(sigma),
                                              jnp.asarray(deltas)))
    mids = depths + 0.5 * deltas
    for m in (None, mask):
        want = jcomp.distortion_loss(
            jnp.asarray(w), jnp.asarray(mids), jnp.asarray(deltas),
            None if m is None else jnp.asarray(m))
        close(tcomp.distortion_loss(t(w), t(mids), t(deltas),
                                    None if m is None else t(m)), want, 1e-5)
    close(tcomp.densities_to_weights(t(sigma), t(deltas)), w)


def test_mse_and_loss_container():
    rng = np.random.default_rng(4)
    a, b = (rng.uniform(size=(64, 3)).astype(np.float32) for _ in range(2))
    mask = (rng.uniform(size=(64, 1)) < 0.5).astype(np.float32)
    close(tloss.mse(t(a), t(b)), jloss.mse(jnp.asarray(a), jnp.asarray(b)))
    close(tloss.mse(t(a), t(b), t(mask)),
          jloss.mse(jnp.asarray(a), jnp.asarray(b), jnp.asarray(mask)))
    containers = []
    for mod, conv in ((tloss, t), (jloss, jnp.asarray)):
        c = mod.LossContainer().add_loss('color', mod.mse, 1.0)
        c.add_loss('coarse', mod.mse, 0.5).add_metric('l1', mod.l1)
        total, logs = c(color={'pred': conv(a), 'target': conv(b)},
                        coarse={'pred': conv(b), 'target': conv(a * 0.5)},
                        l1={'pred': conv(a), 'target': conv(b)}, alpha=None)
        assert set(logs) == {'color', 'coarse', 'l1', 'total'}
        c.accumulate(logs)
        c.accumulate(logs)
        containers.append((total, logs, c.flush()))
    (tt, tl, tf), (jt, jl, jf) = containers
    close(tt, jt)
    for key in jl:
        close(tl[key], jl[key])
        assert tf[key] == pytest.approx(jf[key], abs=ATOL)
    assert tloss.LossTerm('x', tloss.mse).weight == 1.0


# -- NeRF ---------------------------------------------------------------------

def _random_tree(shapes, seed=0):
    """A JAX NeRF param tree of U(-1/sqrt(in), 1/sqrt(in)) from numpy."""
    rng = np.random.default_rng(seed)

    def layer(p):
        bound = 1.0 / np.sqrt(p['w'].shape[0])
        return {k: rng.uniform(-bound, bound, p[k].shape).astype(np.float32)
                for k in ('w', 'b')}
    return {name: {k: ([layer(p) for p in v] if k == 'trunk' else layer(v))
                   for k, v in block.items()}
            for name, block in shapes.items()}


def test_block_matches_jax():
    """The library width (8 x 256, skip at 5, 10 and 4 frequencies):
    BLOCK_SHARE of the outputs within BLOCK_ATOL, all within 1e-4. Both
    packages round every layer's operands to bf16; where their f32 sums
    (or the frequency encodings, which agree to 4e-7) differ in the last
    bit, an activation can round to the neighbouring bf16 value, 2^-8 of
    it, which moves a few outputs further."""
    jparams = jmodel.init_nerf_block(jax.random.PRNGKey(0))
    tree = _random_tree({'fine': jparams})['fine']
    rng = np.random.default_rng(1)
    pos = rng.uniform(-1.5, 1.5, (512, 3)).astype(np.float32)
    dirs = rng.normal(size=(512, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    want = jmodel.apply_nerf_block(jax.tree_util.tree_map(jnp.asarray, tree),
                                   jnp.asarray(pos), jnp.asarray(dirs))
    block = NeRFBlock()
    state = params_from_numpy({'fine': tree})
    block.load_state_dict({k[len('fine.'):]: v for k, v in state.items()})
    with torch.no_grad():
        got = block(t(pos), t(dirs))
    assert float(want[0].max()) > 0.0
    for g, w in zip(got, want):
        err = np.abs(g.numpy() - np.asarray(w))
        assert (err <= BLOCK_ATOL).mean() >= BLOCK_SHARE, err.max()
        assert err.max() <= 1e-4


def _config(scene, seed=0, iterations=100):
    return {'GLOBAL': {'METHOD_TYPE': 'NeRF', 'DATASET_TYPE': 'NeRF',
                       'RANDOM_SEED': seed, 'LOG_LEVEL': 'SILENT'},
            'DATASET': {'PATH': str(scene)},
            'MODEL': {'NUM_LAYERS': 3, 'WIDTH': 64, 'SKIP_LAYER': 2,
                      'POSITION_FREQUENCIES': 6, 'DIRECTION_FREQUENCIES': 2,
                      'USE_COARSE': True},
            'RENDERER': {'RAY_BATCH_SIZE': 1024, 'N_SAMPLES': 48,
                         'COARSE_RATIO': 0.5},
            'TRAINING': {'NUM_ITERATIONS': iterations, 'RAYS_PER_BATCH': 128,
                         'LR_INIT': 5e-3, 'LR_FINAL': 5e-4,
                         'RENDER_TESTSET': True, 'MODEL_NAME': 'parity'}}


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    root = tmp_path_factory.mktemp('textured32_nerf')
    return make_textured_scene(root, image_size=32, n_train=8, n_test=2)


def _models(scene):
    """A JAX and a port NeRF model with the same random weights; the
    density heads' biases at 0.1, so that the rays see some density."""
    cfg = _config(scene)
    jm = JMethods.get_model(JConfigNode(cfg))
    tm = TMethods.get_model(TConfigNode(cfg), device='cpu')
    tree = _random_tree(jax.tree_util.tree_map(np.asarray, jm.params))
    for block in tree.values():
        block['density']['b'][:] = 0.1
    jm.params = jax.tree_util.tree_map(jnp.asarray, tree)
    tm.load_params_tree(tree)
    return cfg, jm, tm


def test_render_matches_jax(scene):
    cfg, jm, tm = _models(scene)
    view_j = JDatasets.get_dataset(JConfigNode(cfg)).subsets['test'][0]
    jr = JMethods.get_renderer(JConfigNode(cfg), jm)
    want = jr.render_image(view_j)
    tr = TMethods.get_renderer(TConfigNode(cfg), tm)
    got = tr.render_image(TDatasets.get_dataset(TConfigNode(cfg))
                          .subsets['test'][0])
    assert float(got['alpha'].mean()) > 0.05
    for key in ('rgb', 'alpha'):
        a, b = np.asarray(want[key]), got[key].numpy()
        psnr = -10 * np.log10(max(float(np.mean((a - b) ** 2)), 1e-20))
        assert psnr >= MIN_PSNR_DB, f'{key}: {psnr:.1f} dB'
        assert float(np.abs(a - b).mean()) <= RENDER_MAE


def test_training_step_matches_jax(scene):
    """One step's loss and gradients, the port handed JAX's uniforms."""
    cfg, jm, tm = _models(scene)
    jt = JMethods.get_training_instance(JConfigNode(cfg))
    tt = TMethods.get_training_instance(TConfigNode(cfg), device='cpu')
    jt.model.params, tt.model = jm.params, tm
    tt.renderer.model = tm
    tt.optimizer = torch.optim.Adam(tm.module.parameters(), eps=1e-8)
    jt._init_samplers(JDatasets.get_dataset(JConfigNode(cfg)))
    tt._init_samplers(TDatasets.get_dataset(TConfigNode(cfg)))
    ids = np.random.default_rng(9).integers(0, tt._pool_size, 256)
    key = jax.random.PRNGKey(11)
    jr = jt.renderer
    pool = jt._pool
    target = pool['rgb'][ids] * pool['alpha'][ids] + \
        jt._bg * (1 - pool['alpha'][ids])

    @jax.jit
    def loss_fn(p):       # nerficg_tpu trainer.py:126-141
        out = jr._render_rays_impl(p, pool['origins'][ids],
                                   pool['directions'][ids], key, jt._near,
                                   jt._far, jt._bg, randomized=True)
        return jnp.mean((out['rgb'] - target) ** 2) + \
            jnp.mean((out['coarse_rgb'] - target) ** 2)

    loss_j, grads_j = jax.value_and_grad(loss_fn)(jt.model.params)
    k_coarse, k_pdf, _ = jax.random.split(key, 3)
    draws = {'coarse': t(jax.random.uniform(k_coarse, (256, 24))),
             'fine': t(jax.random.uniform(k_pdf, (256, 24)))}
    logs = tt.loss_and_grads(torch.from_numpy(ids), draws)
    assert float(logs['total']) == pytest.approx(float(loss_j),
                                                 rel=LOSS_RTOL)
    grads_t = params_to_numpy({k: p.grad for k, p in
                               tm.module.named_parameters()})
    flat_t = flatten_tree(grads_t)
    flat_j = flatten_tree(jax.tree_util.tree_map(np.asarray, grads_j))
    assert set(flat_t) == set(flat_j)
    for name, want in flat_j.items():
        err = np.linalg.norm(flat_t[name] - want) / max(
            np.linalg.norm(want), 1e-30)
        assert err <= FROBENIUS_RTOL, f'{name}: {err:.2e}'


def test_trainer_matches_jax_psnr(scene, tmp_path, monkeypatch):
    """100 iterations of each package's trainer, same config and seed,
    through the port's training and inference entry points."""
    from nerficg_torch.core.setup import Directories as TDirectories
    from nerficg_torch.scripts import inference, train
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
    assert abs(port_psnr - jax_psnr) <= PSNR_BAND_DB, (port_psnr, jax_psnr)
    losses = torch.stack(result['trainer'].losses)
    assert losses[-20:].mean() < 0.5 * losses[:20].mean()
    served = inference.main(['-d', str(result['output_dir']), '-s', 'test',
                             '-m', '-b', '--repeats', '1', '--device',
                             'cpu'])
    assert served['metrics']['test']['PSNR'] == pytest.approx(port_psnr,
                                                              abs=1e-4)
    assert served['fps'] > 0


def test_checkpoints_both_ways(scene, tmp_path):
    cfg, jm, tm = _models(scene)
    jm.save(tmp_path / 'jax.ckpt')
    loaded = TMethods.get_model(TConfigNode(cfg),
                                checkpoint=str(tmp_path / 'jax.ckpt'),
                                device='cpu')
    want = flatten_tree(jax.tree_util.tree_map(np.asarray, jm.params))
    got = flatten_tree(loaded.params_tree())
    assert set(got) == set(want) and 'coarse/trunk/2/w' in got
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])

    tm.save(tmp_path / 'port.ckpt')
    assert set(flatten_tree(load_checkpoint(tmp_path / 'port.ckpt')
                            ['params'])) == set(want)
    back = JMethods.get_model(JConfigNode(cfg),
                              checkpoint=str(tmp_path / 'port.ckpt'))
    assert back.WIDTH == 64
    for key, value in flatten_tree(jax.tree_util.tree_map(
            np.asarray, back.params)).items():
        np.testing.assert_array_equal(value, want[key])


def test_training_state_round_trip(scene, tmp_path, monkeypatch):
    """The resume file carries parameters, Adam's moments and step count;
    the validation callback renders and logs."""
    from nerficg_torch.core.setup import Directories as TDirectories
    monkeypatch.setattr(TDirectories, 'base', tmp_path)
    cfg = _config(scene)
    cfg['TRAINING']['VALIDATION_INTERVAL'] = 1
    dataset = TDatasets.get_dataset(TConfigNode(cfg))
    tt = TMethods.get_training_instance(TConfigNode(cfg), device='cpu')
    tt._init_samplers(dataset)
    for i in range(3):
        tt.training_iteration(dataset, i)
    tt._validate(dataset, 2)
    tt.iteration = 3
    tt.save_training_state(tmp_path / 'state.train')
    back = TMethods.get_training_instance(TConfigNode(cfg), device='cpu')
    back.load_training_state(tmp_path / 'state.train')
    back._apply_pending_resume()
    assert back.updates == tt.updates == 3 and back.iteration == 3
    params = dict(tt.model.module.named_parameters())
    for name, p in back.model.module.named_parameters():
        assert torch.equal(p, params[name])
        want = tt.optimizer.state[params[name]]
        got = back.optimizer.state[p]
        for key in ('exp_avg', 'exp_avg_sq'):
            assert torch.equal(got[key], want[key])
