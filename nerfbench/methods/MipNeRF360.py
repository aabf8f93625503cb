"""Mip-NeRF 360 cells: the program's trainer on a procedural unbounded
360-degree capture, what a run records of it, the reference's readings,
and the work the per-layer metrics divide by.

The configuration's ``scene`` block sizes it: ``views`` RGB training
images of ``width`` x ``height`` (``scene.images``) from an inward-facing
ring (``scene.ring_poses``) at ``camera_radius`` and ``camera_height``,
with a focal length of ``focal_over_width`` x width. ``reference_block``
rays at a time go through the reference, their gradients summed.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nerfbench import scene
from nerfbench.common import (adam_first_grad_norms, compare_train,
                              port_config, scene_dataset, trainer_seed)
from nerfbench.reference import mipnerf360 as ref
from nerfbench.reference.optim import Adam

__all__ = ['build_train', 'reference_train', 'compare_train', 'train_work',
           'step_flops']


def _poses(cfg: dict) -> list[np.ndarray]:
    s = cfg['scene']
    return scene.ring_poses(s['views'], s['camera_radius'],
                            s['camera_height'], s['camera_height_swing'])


def _focal(cfg: dict) -> float:
    return cfg['scene']['focal_over_width'] * cfg['scene']['width']


def _images(cfg: dict, seed: int, device) -> torch.Tensor:
    s = cfg['scene']
    return scene.images(scene.image_params(seed, s['views'], device),
                        s['width'], s['height'], alpha=False)


def _weights(cfg: dict, seed: int, device) -> dict:
    """He-uniform weights U(-sqrt(6 / in), +) and zero biases, as the
    released code initialises its dense layers, from one draw."""
    leaves = ref.mlp_leaves(cfg['port_config']['MODEL'])
    total = sum(math.prod(shape) for _, shape in leaves if len(shape) == 2)
    flat = torch.rand(total, generator=scene.generator(seed, 'mipnerf360',
                                                       device),
                      device=device)
    out, offset = {}, 0
    for name, shape in leaves:
        if len(shape) == 1:
            out[name] = torch.zeros(shape, device=device)
            continue
        size = math.prod(shape)
        bound = math.sqrt(6.0 / shape[1])
        out[name] = flat[offset:offset + size].view(shape) * (2 * bound) \
            - bound
        offset += size
    return out


class TrainSession:
    """The program's Mip-NeRF 360 trainer from iteration 0, its weights
    made from the seed, its ray pool (with the cones' radii) built by its
    own pre-training callbacks from the in-memory views."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from nerficg_torch.cameras.perspective import PerspectiveCamera
        from nerficg_torch.core.registry import Methods
        from nerficg_torch.data.types import ImageData, View
        s = cfg['scene']
        pool = s['views'] * s['width'] * s['height']
        rays = int(cfg['port_config']['TRAINING']['RAYS_PER_BATCH'])
        self.seed = trainer_seed(seed, rays, pool)
        port = port_config(cfg, self.seed, device)
        trainer = Methods.get_training_instance(port, device=device)
        weights = _weights(cfg, seed, device)
        params = dict(trainer.model.module.named_parameters())
        if set(params) != set(weights):
            raise RuntimeError(f'the Mip-NeRF 360 model has leaves '
                               f'{sorted(params)}; the configuration makes '
                               f'{sorted(weights)}')
        with torch.no_grad():
            for name, p in params.items():
                p.copy_(weights[name])
        del weights
        images = _images(cfg, seed, device).cpu().numpy()

        def views_of(settings):
            camera = PerspectiveCamera(s['width'], s['height'], _focal(cfg),
                                       _focal(cfg), settings=settings)
            return {'train': [View(camera, c2w, frame_idx=i,
                                   rgb=ImageData(data=images[i]))
                              for i, c2w in enumerate(_poses(cfg))]}

        self.dataset = scene_dataset(port, views_of)
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


def _local(cfg: dict, dx: float, dy: float, device) -> torch.Tensor:
    """(H*W, 3) camera-space directions through the pixel centres moved
    by (dx, dy) pixels, at depth 1."""
    s = cfg['scene']
    w, h, f = s['width'], s['height'], _focal(cfg)
    x = (torch.arange(w, dtype=torch.float32, device=device) + 0.5 + dx
         - w / 2.0) / f
    y = (torch.arange(h, dtype=torch.float32, device=device) + 0.5 + dy
         - h / 2.0) / f
    yy, xx = torch.meshgrid(y, x, indexing='ij')
    return torch.stack([xx.reshape(-1), yy.reshape(-1),
                        torch.ones_like(xx).reshape(-1)], -1)


def _rays(cfg: dict, ids: np.ndarray, device):
    """Origins, unit directions and base radii of pool rays ``ids``
    (view-major, row-major pixels), and their views and pixels."""
    s = cfg['scene']
    per_view = s['width'] * s['height']
    view = torch.as_tensor(ids // per_view, device=device)
    pix = torch.as_tensor(ids % per_view, device=device)
    c2w = torch.as_tensor(np.stack(_poses(cfg)), dtype=torch.float32,
                          device=device)
    local = _local(cfg, 0.0, 0.0, device)
    d = torch.einsum('nj,nij->ni', local[pix], c2w[view, :3, :3])
    d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
    radii = ref.ray_radii(local[pix], _local(cfg, 1.0, 0.0, device)[pix],
                          _local(cfg, 0.0, 1.0, device)[pix])
    return c2w[view, :3, 3], d, radii, view, pix


def _schedule(train_cfg: dict, step: int) -> float:
    """Log-linear LR_INIT -> LR_FINAL with mip-NeRF's sine warm-up."""
    t = min(step / train_cfg['NUM_ITERATIONS'], 1.0)
    ramp = min(step / train_cfg['LR_DELAY_STEPS'], 1.0)
    mult = train_cfg['LR_DELAY_MULT']
    delay = mult + (1.0 - mult) * math.sin(0.5 * math.pi * ramp)
    return delay * math.exp((1 - t) * math.log(train_cfg['LR_INIT']) +
                            t * math.log(train_cfg['LR_FINAL']))


def reference_train(cfg: dict, traffic: dict, seed: int, records: dict,
                    device, dtype=torch.bfloat16,
                    fault: str | None = None) -> dict:
    """The reference's first steps on the same rays and jitters: each
    step's loss, the first (clipped) gradients, the change after three
    steps. ``dtype`` is the MLPs' operand precision (the configuration's
    bf16; float8 e4m3 is the lower-precision control); ``fault``
    'half_batch' takes the loss over the first half of the rays alone."""
    s, port = cfg['scene'], cfg['port_config']
    model_cfg, render_cfg = port['MODEL'], port['RENDERER']
    train_cfg = port['TRAINING']
    rays = int(train_cfg['RAYS_PER_BATCH'])
    used = rays // 2 if fault == 'half_batch' else rays
    block = int(cfg['reference_block'])
    rounds = len(render_cfg['PROPOSAL_SAMPLES']) + 1
    steps = len(records['losses'])
    rng = np.random.default_rng(records['seed'])
    ids = [rng.integers(0, s['views'] * s['width'] * s['height'], size=rays)
           for _ in range(steps)]
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in _weights(cfg, seed, device).items()}
    start = {k: v.detach().clone() for k, v in leaves.items()}
    gen = torch.Generator(device=device).manual_seed(records['seed'])
    adam = Adam(leaves, eps=1e-6)
    images = _images(cfg, seed, device)
    images = images.reshape(images.shape[0], -1, 3)
    losses, grad_norms = [], {}
    for step in range(steps):
        origins, dirs, radii, view, pix = _rays(cfg, ids[step], device)
        target = images[view, pix]
        jitters = [torch.rand((rays,), generator=gen, device=device)
                   for _ in range(rounds)]
        grads = {k: torch.zeros_like(v) for k, v in leaves.items()}
        loss_value = 0.0
        for lo in range(0, used, block):
            sl = slice(lo, min(lo + block, used))
            out = ref.render_rays(leaves, origins[sl], dirs[sl], radii[sl],
                                  [j[sl] for j in jitters], model_cfg,
                                  render_cfg, dtype)
            loss = ref.block_loss(out, target[sl], train_cfg, used)
            for k, g in zip(leaves, torch.autograd.grad(
                    loss, list(leaves.values()))):
                grads[k] += g
            loss_value += float(loss.detach())
            del out, loss
        grads = ref.clip(grads, float(train_cfg['GRAD_MAX_NORM']))
        if step == 0:
            grad_norms = {k: float(torch.linalg.norm(g))
                          for k, g in grads.items()}
        lr = _schedule(train_cfg, step)
        adam.step(grads, {k: lr for k in leaves})
        losses.append(loss_value)
    update_norms = {k: float(torch.linalg.norm(leaves[k].detach() - start[k]))
                    for k in leaves}
    return {'losses': losses, 'grad_norms': grad_norms,
            'update_norms': update_norms}


def step_flops(cfg: dict) -> float:
    """Matrix-multiply FLOPs of one training step: 6 x the multiply-adds
    of each MLP's linear layers (forward, and the input and weight
    gradients) x the samples it evaluates, the proposal MLP at every
    proposal round's samples and the NeRF MLP at the NeRF round's."""
    port = cfg['port_config']
    render = port['RENDERER']
    rays = int(port['TRAINING']['RAYS_PER_BATCH'])
    macs = {'proposal': 0, 'nerf': 0}
    for name, shape in ref.mlp_leaves(port['MODEL']):
        if name.endswith('weight'):
            macs[name.split('.')[0]] += math.prod(shape)
    samples = {'proposal': rays * sum(int(n) for n in
                                      render['PROPOSAL_SAMPLES']),
               'nerf': rays * int(render['NERF_SAMPLES'])}
    return 6.0 * sum(macs[k] * samples[k] for k in macs)


def train_work(cfg: dict, traffic: dict, seed: int, records: dict,
               steps: list[int], device) -> list[dict]:
    port = cfg['port_config']
    nerf_samples = int(port['TRAINING']['RAYS_PER_BATCH']) * \
        int(port['RENDERER']['NERF_SAMPLES'])
    return [{'flops': step_flops(cfg), 'nerf_samples': nerf_samples}
            for _ in steps]
