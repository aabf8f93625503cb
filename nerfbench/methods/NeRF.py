"""Vanilla NeRF cells: the program's trainer on a procedural NeRF-Synthetic
scene, what a run records of it, the reference's readings, and the work
the per-layer metrics divide by.

The configuration's ``scene`` block sizes it: ``views`` RGBA training
images of ``width`` x ``height`` (``scene.images``) seen from the upper
hemisphere at ``camera_radius`` (a Fibonacci lattice, looking at the
origin), the focal length, and near, far and the background.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nerfbench import scene
from nerfbench.common import (adam_first_grad_norms, compare_train,
                              port_config, scene_dataset, trainer_seed)
from nerfbench.reference import nerf as ref
from nerfbench.reference.optim import Adam

__all__ = ['build_train', 'reference_train', 'compare_train', 'train_work']


def _poses(cfg: dict) -> list[np.ndarray]:
    s = cfg['scene']
    n, out = s['views'], []
    golden = math.pi * (3.0 - math.sqrt(5.0))
    for i in range(n):
        z = 0.05 + 0.9 * (i + 0.5) / n
        r = math.sqrt(1.0 - z * z)
        eye = s['camera_radius'] * np.array(
            [r * math.cos(golden * i), r * math.sin(golden * i), z])
        out.append(scene.look_at(eye))
    return out


def _images(cfg: dict, seed: int, device, indices=None) -> torch.Tensor:
    s = cfg['scene']
    params = scene.image_params(seed, s['views'], device)
    if indices is not None:
        params = params[indices]
    return scene.images(params, s['width'], s['height'], alpha=True)


def _weights(cfg: dict, seed: int, device) -> dict:
    return scene.mlp_weights(seed, cfg['port_config']['MODEL'], device)


class TrainSession:
    """The program's NeRF trainer from iteration 0, its weights made from
    the seed, its ray pool built by its own pre-training callbacks from
    the in-memory views, as ``BaseTrainer.run`` builds it."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from nerficg_torch.cameras.perspective import PerspectiveCamera
        from nerficg_torch.core.registry import Methods
        from nerficg_torch.data.types import ImageData, View
        s = cfg['scene']
        pool = s['views'] * s['width'] * s['height']
        rays = int(cfg['port_config']['TRAINING']['RAYS_PER_BATCH'])
        self.seed = trainer_seed(seed, rays, pool)
        port = port_config(cfg, self.seed, device)
        images = _images(cfg, seed, device).cpu().numpy()

        def views_of(settings):
            camera = PerspectiveCamera(s['width'], s['height'], s['focal'],
                                       s['focal'], settings=settings)
            return {'train': [
                View(camera, c2w, frame_idx=i,
                     rgb=ImageData(data=images[i, ..., :3]),
                     alpha=ImageData(data=images[i, ..., 3:]))
                for i, c2w in enumerate(_poses(cfg))]}

        self.dataset = scene_dataset(port, views_of)
        trainer = Methods.get_training_instance(port, device=device)
        weights = _weights(cfg, seed, device)
        params = dict(trainer.model.module.named_parameters())
        if set(params) != set(weights):
            raise RuntimeError(f'the NeRF model has leaves {sorted(params)}; '
                               f'the configuration makes {sorted(weights)}')
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(weights[name])
        self.trainer = trainer
        self.names = {id(p): n for n, p in params.items()}
        self.cfg, self.data_seed, self.device = cfg, seed, device
        self.losses: list[float] = []
        self.grad_norms: dict = {}
        self.update_norms: dict = {}

    def record(self, step: int) -> None:
        trainer = self.trainer
        self.losses.append(float(trainer.losses[-1]))
        if step == 1:
            self.grad_norms = adam_first_grad_norms(trainer.optimizer,
                                                    self.names)
        if step == 3:
            start = _weights(self.cfg, self.data_seed, self.device)
            with torch.no_grad():
                for name, p in trainer.model.module.named_parameters():
                    self.update_norms[name] = float(torch.linalg.norm(
                        p.detach() - start[name]))

    def records(self) -> dict:
        return {'losses': self.losses, 'grad_norms': self.grad_norms,
                'update_norms': self.update_norms, 'seed': self.seed}


def build_train(cfg: dict, traffic: dict, seed: int, device) -> TrainSession:
    return TrainSession(cfg, traffic, seed, device)


def _ray_ids(trainer_seed_: int, pool: int, rays: int, steps: int):
    rng = np.random.default_rng(trainer_seed_)
    return [rng.integers(0, pool, size=rays) for _ in range(steps)]


def _rays(cfg: dict, ids: np.ndarray, device):
    """Origins and unit directions of pool rays ``ids`` (view-major,
    row-major pixels): every view's directions rotated in one batched
    product and normalised, as the program's pool makes them, then
    gathered."""
    s = cfg['scene']
    per_view = s['width'] * s['height']
    view = torch.as_tensor(ids // per_view, device=device)
    pix = torch.as_tensor(ids % per_view, device=device)
    c2w = torch.as_tensor(np.stack(_poses(cfg)), dtype=torch.float32,
                          device=device)
    local = scene.pinhole_directions(s['width'], s['height'], s['focal'],
                                     device)
    d = torch.einsum('nj,vij->vni', local, c2w[:, :3, :3])
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    return c2w[view, :3, 3], d[view, pix], view, pix


def reference_train(cfg: dict, traffic: dict, seed: int, records: dict,
                    device, dtype=torch.bfloat16,
                    fault: str | None = None) -> dict:
    """The reference's first steps on the same rays and uniforms: each
    step's loss, the first gradients, the change after three steps.
    ``dtype`` is the MLPs' operand precision (the configuration's bf16;
    float8 e4m3 is the lower-precision control);
    ``fault`` 'half_batch' takes the loss over the first half of the rays
    alone."""
    s, port = cfg['scene'], cfg['port_config']
    model_cfg, train_cfg = port['MODEL'], port['TRAINING']
    rays = int(train_cfg['RAYS_PER_BATCH'])
    n_samples = int(port['RENDERER']['N_SAMPLES'])
    n_coarse = max(int(n_samples * float(port['RENDERER']['COARSE_RATIO'])),
                   1)
    steps = len(records['losses'])
    pool = s['views'] * s['width'] * s['height']
    ids = _ray_ids(records['seed'], pool, rays, steps)
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in _weights(cfg, seed, device).items()}
    start = {k: v.detach().clone() for k, v in leaves.items()}
    gen = torch.Generator(device=device).manual_seed(records['seed'])
    bg = torch.as_tensor(s['background'], dtype=torch.float32, device=device)
    lr = [math.exp((1 - t) * math.log(train_cfg['LR_INIT']) +
                   t * math.log(train_cfg['LR_FINAL']))
          for t in (min(i / train_cfg['NUM_ITERATIONS'], 1.0)
                    for i in range(steps))]
    adam = Adam(leaves, eps=1e-8)
    losses, grad_norms = [], {}
    images = _images(cfg, seed, device)
    images = images.reshape(images.shape[0], -1, 4)
    for step in range(steps):
        origins, dirs, view, pix = _rays(cfg, ids[step], device)
        px = images[view, pix]
        target = px[:, :3] * px[:, 3:] + bg * (1 - px[:, 3:])
        u_coarse = torch.rand((rays, n_coarse), generator=gen, device=device)
        u_fine = torch.rand((rays, n_samples - n_coarse), generator=gen,
                            device=device)
        coarse, fine = ref.render_rays(leaves, origins, dirs,
                                       float(s['near']), float(s['far']), bg,
                                       u_coarse, u_fine, model_cfg, dtype)
        if fault == 'half_batch':
            half = rays // 2
            coarse, fine, target = coarse[:half], fine[:half], target[:half]
        loss = ref.train_loss(coarse, fine, target,
                              float(train_cfg['COARSE_LOSS_WEIGHT']))
        grads = dict(zip(leaves, torch.autograd.grad(
            loss, list(leaves.values()))))
        if step == 0:
            grad_norms = {k: float(torch.linalg.norm(g))
                          for k, g in grads.items()}
        adam.step(grads, {k: lr[step] for k in leaves})
        losses.append(float(loss.detach()))
    update_norms = {k: float(torch.linalg.norm(leaves[k].detach() - start[k]))
                    for k in leaves}
    return {'losses': losses, 'grad_norms': grad_norms,
            'update_norms': update_norms}


def step_flops(cfg: dict) -> float:
    """Matrix-multiply FLOPs of one training step: per sample evaluation
    of a block, 2 x the multiply-adds of its linear layers forward and
    twice that backward (input and weight gradients); the coarse block at
    the coarse samples, the fine block at all samples of every ray."""
    port = cfg['port_config']
    macs = sum(math.prod(shape) for name, shape in
               scene.mlp_leaves(port['MODEL'])
               if name.startswith('fine.') and name.endswith('weight'))
    n_samples = int(port['RENDERER']['N_SAMPLES'])
    n_coarse = max(int(n_samples * float(port['RENDERER']['COARSE_RATIO'])),
                   1)
    rays = int(port['TRAINING']['RAYS_PER_BATCH'])
    return 6.0 * macs * rays * (n_coarse + n_samples)


def train_work(cfg: dict, traffic: dict, seed: int, records: dict,
               steps: list[int], device) -> list[dict]:
    return [{'flops': step_flops(cfg)} for _ in steps]
