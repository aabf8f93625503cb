"""Mip-NeRF 360 in the port (``methods/mipnerf360``, ``ops/frustum.py`` and
the new functions of ``ops/encoding.py``, ``ops/sampling.py`` and
``ops/compositing.py``), on the CPU at tiny widths: a 2 x 16 proposal MLP,
a 3 x 32 NeRF MLP with its skip, 64 rays, 8 + 8 proposal samples and 4
NeRF samples. The JAX package has no Mip-NeRF 360; the plain reference is
the benchmark's (``nerfbench/reference/mipnerf360.py``).

* One training step's loss, every leaf's gradient and one clipped Adam
  update against the reference on the same seeded weights, rays and
  jitters: with every linear layer in float32, to float32 round-off; in
  the port's bf16-operand form, within what bf16 rounding moves.
* The frustum's mean and covariance against a Monte Carlo integral over
  the cone; the contraction's Jacobian against autograd's; the integrated
  positional encoding against a sampled expectation; the interlevel bound
  against the O(n^2) sum over overlapping intervals.
* ``scripts.train`` for a few iterations on a MipNeRF360-format capture
  (COLMAP, images_4), then ``scripts.inference`` and ``render_image``.
"""

import math

import numpy as np
import pytest
import torch

from nerfbench.reference import mipnerf360 as ref
from nerfbench.reference.optim import Adam
from nerficg_torch.core.config import ConfigNode
from nerficg_torch.core.logging import Logger
from nerficg_torch.core.registry import Datasets, Methods
from nerficg_torch.data.synthetic import make_textured_scene
from nerficg_torch.methods.base.callbacks import PRE, gather_callbacks
from nerficg_torch.methods.mipnerf360 import model as mip_model
from nerficg_torch.ops.compositing import interlevel_bound, interlevel_loss
from nerficg_torch.ops.encoding import integrated_pos_encode
from nerficg_torch.ops.frustum import (conical_frustum_gaussians, contract,
                                       contract_gaussians, contract_jacobian)
from nerficg_torch.ops.sampling import sample_intervals
from torch_threads import one_torch_thread  # noqa: F401  (autouse)

Logger.set_level('SILENT')

MODEL = {'PROPOSAL_LAYERS': 2, 'PROPOSAL_WIDTH': 16, 'NUM_LAYERS': 3,
         'WIDTH': 32, 'SKIP_LAYER': 2, 'BOTTLENECK_WIDTH': 16,
         'VIEW_WIDTH': 16}
RENDERER = {'PROPOSAL_SAMPLES': [8, 8], 'NERF_SAMPLES': 4}
RAYS = 64


def _config(path, dataset='NeRF') -> dict:
    return {'GLOBAL': {'METHOD_TYPE': 'MipNeRF360', 'DATASET_TYPE': dataset,
                       'RANDOM_SEED': 3, 'LOG_LEVEL': 'SILENT'},
            'DATASET': {'PATH': str(path)},
            'MODEL': dict(MODEL), 'RENDERER': dict(RENDERER),
            'TRAINING': {'RAYS_PER_BATCH': RAYS, 'RENDER_TESTSET': False,
                         'LR_DELAY_STEPS': 4}}


@pytest.fixture(scope='module')
def scene(tmp_path_factory):
    return make_textured_scene(tmp_path_factory.mktemp('mip_scene'),
                               image_size=32, n_train=4, n_test=1)


def _trainer(scene):
    cfg = ConfigNode(_config(scene))
    dataset = Datasets.get_dataset(cfg)
    torch.manual_seed(5)        # the model's He-uniform draw
    trainer = Methods.get_training_instance(cfg, device='cpu')
    for _, callback in gather_callbacks(trainer, PRE):
        callback(dataset)
    return trainer, dataset


def _f32_linear(layer, x):
    return x @ layer.weight.T + layer.bias


# -- one step against the reference ------------------------------------------

@pytest.mark.parametrize('operands', ['float32', 'bfloat16'])
def test_training_step_matches_the_reference(scene, operands, monkeypatch):
    if operands == 'float32':
        monkeypatch.setattr(mip_model, '_linear', _f32_linear)
    trainer, _ = _trainer(scene)
    pool = trainer._pool
    gen = torch.Generator().manual_seed(11)
    ids = torch.randint(0, trainer._pool_size, (RAYS,), generator=gen)
    draws = [torch.rand(RAYS, generator=gen) for _ in range(3)]
    params = dict(trainer.model.module.named_parameters())
    leaves = {k: v.detach().clone().requires_grad_(True)
              for k, v in params.items()}
    start = {k: v.detach().clone() for k, v in params.items()}

    logs = trainer.loss_and_grads(ids, draws)
    out = ref.render_rays(leaves, pool['origins'][ids],
                          pool['directions'][ids], pool['radii'][ids], draws,
                          trainer.model.default_parameters() | dict(MODEL),
                          trainer.renderer.default_parameters() |
                          dict(RENDERER), getattr(torch, operands))
    train_cfg = trainer.default_parameters() | {'RAYS_PER_BATCH': RAYS}
    loss = ref.block_loss(out, pool['rgb'][ids], train_cfg, RAYS)
    grads = dict(zip(leaves, torch.autograd.grad(loss,
                                                 list(leaves.values()))))
    if operands == 'bfloat16':
        # One operand's bf16 rounding flipped by an ulp of f32 moves its
        # layer's output by up to 2^-8 of that operand, and a proposal
        # density so moved moves the next round's samples; the gradients
        # are rounded to bf16 at every layer's input (1.1e-2 at most over
        # three seeds of 64 rays).
        assert float(logs['total']) == pytest.approx(float(loss.detach()),
                                                     rel=1e-3)
        for name, p in params.items():
            gap = torch.linalg.norm(p.grad - grads[name]) / \
                torch.linalg.norm(grads[name])
            assert gap < 3e-2, (name, float(gap))
        return
    assert float(logs['total']) == pytest.approx(float(loss.detach()),
                                                 rel=2e-6)
    # An ulp of a contracted mean (~1.2e-7) is 2^11 times that in the
    # encoding's highest degree, so the first layer's inputs, and with
    # them the gradients and the update, agree to ~1e-4 (2.3e-5-1.3e-4
    # over seeds).
    for name, p in params.items():
        gap = torch.linalg.norm(p.grad - grads[name]) / \
            torch.linalg.norm(grads[name])
        assert gap < 1e-3, (name, float(gap))

    trainer.apply_update()
    clipped = ref.clip(grads, 1e-3)
    Adam(leaves, eps=1e-6).step(clipped, {k: trainer.schedule(0)
                                          for k in leaves})
    for name, p in params.items():
        want = leaves[name].detach() - start[name]
        gap = torch.linalg.norm(p.detach() - start[name] - want) / \
            torch.linalg.norm(want)
        assert gap < 1e-3, (name, float(gap))


def test_pool_radii_are_the_cameras(scene):
    trainer, dataset = _trainer(scene)
    camera = dataset.subsets['train'][0].camera
    radii = camera.local_ray_radii()
    n = camera.width * camera.height
    assert torch.equal(trainer._pool['radii'],
                       radii.repeat(len(dataset.subsets['train'])))
    # at the image centre a pixel spans 1/f at unit distance
    centre = (camera.height // 2) * camera.width + camera.width // 2
    assert float(radii[centre]) == pytest.approx(
        2.0 / math.sqrt(12.0) / camera.focal_x, rel=1e-3)
    assert radii.shape == (n,) and bool((radii[:-1] > 0).all())


def test_pool_radii_over_two_cameras():
    """Views of two cameras, interleaved: each ray's radius is its own
    camera's, in view order (the grouped path of ``precompute_rays``)."""
    from nerficg_torch.cameras.perspective import PerspectiveCamera
    from nerficg_torch.data.base import BaseDataset
    from nerficg_torch.data.types import View
    cameras = [PerspectiveCamera(8, 6, 7.0, 7.0),
               PerspectiveCamera(5, 4, 3.0, 3.5)]
    views = [View(cameras[i % 2], np.eye(4), frame_idx=i) for i in range(3)]

    class Three(BaseDataset):
        def load(self):
            self.subsets['train'] = views

    pool = Three(ConfigNode({'DATASET': {}}), path='.').precompute_rays(
        radii=True)
    want = torch.cat([v.camera.local_ray_radii() for v in views])
    assert torch.equal(pool.rays.radii[:, 0], want)
    assert pool.rays.origins.shape[0] == want.shape[0] == 48 + 20 + 48


# -- the pieces against their definitions ------------------------------------

def test_frustum_moments_match_monte_carlo():
    gen = torch.Generator().manual_seed(0)
    count = 400_000
    origin = torch.tensor([0.3, -0.2, 0.1], dtype=torch.float64)
    d = torch.tensor([0.6, -1.1, 0.8], dtype=torch.float64)  # not unit
    radius, t0, t1 = 0.05, 0.7, 1.9
    u, v, phi = torch.rand((3, count), generator=gen, dtype=torch.float64)
    t = (t0 ** 3 + u * (t1 ** 3 - t0 ** 3)) ** (1.0 / 3.0)   # density ~ t^2
    rho = radius * t * torch.sqrt(v)          # uniform over the disk
    e1 = torch.linalg.cross(d, torch.tensor([0.0, 0.0, 1.0],
                                            dtype=torch.float64))
    e1 = e1 / torch.linalg.norm(e1)
    e2 = torch.linalg.cross(d / torch.linalg.norm(d), e1)
    phi = 2 * math.pi * phi
    x = origin + t[:, None] * d + rho[:, None] * (
        torch.cos(phi)[:, None] * e1 + torch.sin(phi)[:, None] * e2)
    mc_mean = x.mean(0)
    mc_cov = torch.cov(x.T)
    mean, cov = conical_frustum_gaussians(
        origin[None].float(), d[None].float(), torch.tensor([radius]),
        torch.tensor([[t0]]), torch.tensor([[t1]]))
    assert torch.allclose(mean[0, 0].double(), mc_mean, atol=3e-3)
    # in the frame of the ray: along it, and across it twice
    frame = torch.stack([d / torch.linalg.norm(d), e1, e2], -1)
    got = frame.T @ cov[0, 0].double() @ frame
    want = frame.T @ mc_cov @ frame
    scale = torch.sqrt(torch.diagonal(want)[:, None] *
                       torch.diagonal(want)[None, :])
    assert torch.allclose(got / scale, want / scale, atol=1e-2), \
        (got / scale - want / scale)


def test_contraction_jacobian_matches_autograd():
    gen = torch.Generator().manual_seed(1)
    x = torch.randn((40, 3), generator=gen, dtype=torch.float64) * 1.5
    x[0] = torch.tensor([0.2, 0.1, -0.3])       # inside
    x[1] = torch.tensor([3.0, -4.0, 12.0])      # far outside
    jac = contract_jacobian(x)
    for i in range(x.shape[0]):
        want = torch.autograd.functional.jacobian(contract, x[i])
        assert torch.allclose(jac[i], want, atol=1e-12), i
    covs = torch.randn((40, 3, 3), generator=gen, dtype=torch.float64)
    covs = covs @ covs.transpose(-1, -2)
    means, out, outside = contract_gaussians(x, covs)
    assert torch.allclose(means, contract(x))
    assert torch.allclose(out, jac @ covs @ jac.transpose(-1, -2))
    assert torch.equal(outside, torch.linalg.norm(x, dim=-1) > 1)
    assert bool((torch.linalg.norm(means, dim=-1) < 2).all())


def test_integrated_encoding_matches_sampled_expectation():
    gen = torch.Generator().manual_seed(2)
    mean = torch.tensor([0.4, -1.3, 0.9])
    var = torch.tensor([0.02, 0.3, 0.005])
    degrees = 4
    got = integrated_pos_encode(mean[None], var[None], degrees)[0]
    assert got.shape == (2 * 3 * degrees,)
    x = mean + torch.sqrt(var) * torch.randn((400_000, 3), generator=gen)
    want = []
    for fn in (torch.sin, torch.cos):
        for level in range(degrees):
            want.append(fn(2.0 ** level * x).mean(0))
    want = torch.cat(want)
    assert torch.allclose(got, want, atol=4e-3), (got - want).abs().max()


def test_interlevel_bound_matches_the_overlap_sum():
    gen = torch.Generator().manual_seed(4)
    rays, n, m = 16, 6, 9

    def edges(k):
        e = torch.sort(torch.rand((rays, k + 1), generator=gen), -1).values
        e[:3, 0], e[:3, -1] = 0.0, 1.0
        return e

    s, s_env = edges(n), edges(m)
    s[5] = s_env[5, :n + 1]         # edges that meet the proposal's
    w = torch.rand((rays, n), generator=gen)
    w_env = torch.rand((rays, m), generator=gen)
    got = interlevel_bound(s, s_env, w_env)
    want = torch.zeros(rays, n)
    for r in range(rays):
        for i in range(n):
            for j in range(m):
                if s_env[r, j] <= s[r, i + 1] and s_env[r, j + 1] > s[r, i]:
                    want[r, i] += w_env[r, j]
    assert torch.allclose(got, want, atol=1e-6)
    w_env.requires_grad_(True)
    w.requires_grad_(True)
    loss = interlevel_loss(s, w, s_env, w_env).sum()
    loss.backward()
    assert w.grad is None and w_env.grad is not None
    eps = torch.finfo(torch.float32).eps
    assert float(loss.detach()) == pytest.approx(float(
        (torch.clamp(w.detach() - want, min=0) ** 2 /
         (w.detach() + eps)).sum()), rel=1e-5)


def test_sample_intervals_from_one_interval():
    """From [0, 1] at weight 1 the centres are the quantiles themselves:
    s_i = (i + j) / n, edges at their midpoints, the outer two mirrored."""
    jitter = torch.tensor([0.0, 0.25, 0.999])
    out = sample_intervals(None, torch.tensor([[0.0, 1.0]]).expand(3, 2),
                           torch.ones(3, 1), 4, u=jitter)
    centres = (torch.arange(4.0)[None] + jitter[:, None]) / 4
    mids = 0.5 * (centres[:, 1:] + centres[:, :-1])
    assert torch.allclose(out[:, 1:-1], mids)
    assert torch.allclose(out[:, 0], torch.clamp(
        2 * centres[:, 0] - mids[:, 0], min=0))
    assert torch.allclose(out[:, -1], torch.clamp(
        2 * centres[:, -1] - mids[:, -1], max=1))
    assert bool((out[:, 1:] >= out[:, :-1]).all())


# -- the entry points --------------------------------------------------------

def test_train_and_serve_a_capture(tmp_path, monkeypatch):
    from nerficg_torch.core.setup import Directories
    from nerficg_torch.scripts import inference, train
    from test_torch_colmap import write_capture
    scene = make_textured_scene(tmp_path / 'scene', image_size=32,
                                n_train=4, n_test=1)
    write_capture(tmp_path / 'capture', scene, image_dir='images_4',
                  model_scale=4, rows=(4, 28), n_points=200)
    monkeypatch.setattr(Directories, 'base', tmp_path / 'output')
    overrides = [f'MODEL.{k}={v}' for k, v in MODEL.items()] + [
        'RENDERER.PROPOSAL_SAMPLES=[8,8]', 'RENDERER.NERF_SAMPLES=4',
        f'TRAINING.RAYS_PER_BATCH={RAYS}', 'TRAINING.NUM_ITERATIONS=12',
        'TRAINING.LR_DELAY_STEPS=4']
    result = train.main(['-c', 'nerficg_torch/configs/mipnerf360.yaml',
                         '--device', 'cpu',
                         f'DATASET.PATH={tmp_path / "capture"}', *overrides])
    trainer = result['trainer']
    assert len(trainer.losses) == 12 and trainer.updates == 12
    assert all(math.isfinite(float(v)) for v in trainer.losses)
    psnr = result['metrics']['PSNR']
    served = inference.main(['-d', str(result['output_dir']), '-s', 'test',
                             '-m', '--device', 'cpu'])
    assert served['metrics']['test']['PSNR'] == pytest.approx(psnr,
                                                              abs=1e-4)
    view = Datasets.get_dataset(trainer._config).subsets['test'][0]
    image = trainer.renderer.render_image(view)
    assert image['rgb'].shape == (24, 32, 3)
    assert bool(torch.isfinite(image['rgb']).all())
    assert float(image['rgb'].min()) >= -0.001
    assert float(image['rgb'].max()) <= 1.001
