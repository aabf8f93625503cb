"""3D Gaussian Splatting cells: the program's objects on the procedural
capture, what a run records of them, the reference's readings, and the
work the per-layer metrics divide by.

The configuration's ``scene`` block sizes the capture: ``count`` Gaussians
(``scene.gaussian_leaf``), ``views`` training poses of ``width`` x
``height`` on an inward-facing ring (``scene.ring_poses``); a serving
traffic mix names its ellipse of poses and its resolution.
"""

from __future__ import annotations

import numpy as np
import torch

from nerfbench import roofline, scene
from nerfbench.common import (adam_first_grad_norms, compare_train,
                              port_config, scene_dataset, trainer_seed,
                              view_constants)
from nerfbench.reference import gs as ref
from nerfbench.reference.optim import Adam

__all__ = ['build_train', 'build_render', 'reference_train',
           'compare_train', 'reference_frames', 'train_work', 'render_work']

LEAVES = scene.GAUSSIAN_LEAVES


def _spec(cfg: dict) -> dict:
    return {**cfg['scene'], 'sh_degree': cfg['port_config']['MODEL']
            ['SH_DEGREE']}


def _train_poses(cfg: dict) -> list[np.ndarray]:
    s = cfg['scene']
    return scene.ring_poses(s['views'], s['camera_radius'],
                            s['camera_height'], s['camera_height_swing'])


def _serve_poses(cfg: dict, traffic: dict) -> list[np.ndarray]:
    e = traffic['path']
    return scene.ellipse_poses(e['poses'], e['semi_x'], e['semi_y'],
                               e['height'], e['height_swing'])


def _focal(cfg: dict, width: int) -> float:
    """The capture's horizontal field of view at ``width`` pixels."""
    return cfg['scene']['focal_over_width'] * width


def _leaves(cfg: dict, seed: int, device) -> dict:
    return {name: scene.gaussian_leaf(name, seed, _spec(cfg), device)
            for name in LEAVES}


def _views(cfg, poses, width, height, settings):
    from nerficg_torch.cameras.perspective import PerspectiveCamera
    from nerficg_torch.data.types import View
    focal = _focal(cfg, width)
    camera = PerspectiveCamera(width, height, focal, focal,
                               settings=settings)
    return [View(camera, c2w, frame_idx=i) for i, c2w in enumerate(poses)]


def _load_model(model, cfg: dict, seed: int, device) -> None:
    """The procedural Gaussians as the model's parameters, every SH band
    active (the state of a capture after its first 3,000 iterations)."""
    params = {k: torch.nn.Parameter(v) for k, v in
              _leaves(cfg, seed, device).items()}
    model._set_params(params)
    model.num_active = int(params['positions'].shape[0])
    model.active_sh_degree = int(model.SH_DEGREE)


def _targets(cfg: dict, seed: int, device, indices=None) -> torch.Tensor:
    s = cfg['scene']
    params = scene.image_params(seed, s['views'], device)
    if indices is not None:
        params = params[indices]
    return scene.images(params, s['width'], s['height'], alpha=False)


# -- training ----------------------------------------------------------------

class TrainSession:
    """The program's trainer at ``traffic['start_iteration']``, resumed
    from the procedural capture as ``BaseTrainer.run`` resumes from a
    checkpoint, with every training image on the card."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from nerficg_torch.core.registry import Methods
        s = cfg['scene']
        self.seed = trainer_seed(seed, 1, s['views'])
        port = port_config(cfg, self.seed, device)
        self.dataset = scene_dataset(port, lambda settings: {
            'train': _views(cfg, _train_poses(cfg), s['width'], s['height'],
                            settings)})
        trainer = Methods.get_training_instance(port, device=device)
        start = int(traffic['start_iteration'])
        _load_model(trainer.model, cfg, seed, device)
        trainer.model.num_iterations_trained = start
        trainer.iteration = start
        # BaseTrainer.run's resume path: on_resume, then the saved state.
        trainer.on_resume(self.dataset)
        trainer.set_resume_metadata({
            'num_active': trainer.model.num_active,
            'active_sh_degree': trainer.model.active_sh_degree})
        trainer.updates = start
        # The images a run has uploaded by then: the trainer's per-view
        # cache of targets, filled on the card.
        images = _targets(cfg, seed, device)
        for i in range(images.shape[0]):
            trainer._targets[i] = images[i]
        del images
        self.trainer = trainer
        self.cfg, self.traffic, self.data_seed = cfg, traffic, seed
        self.device = device
        self.losses: list[float] = []
        self.grad_norms: dict = {}
        self.update_norms: dict = {}

    def record(self, step: int) -> None:
        """After each of the first steps: its loss; after the first, each
        leaf's gradient as Adam took it; after the third, each leaf's
        change."""
        trainer = self.trainer
        self.losses.append(float(trainer.losses[-1]))
        named = {id(p): g['name'] for g in trainer.optimizer.param_groups
                 for p in g['params']}
        if step == 1:
            self.grad_norms = adam_first_grad_norms(trainer.optimizer, named)
        if step == 3:
            with torch.no_grad():
                for name in LEAVES:
                    start = scene.gaussian_leaf(name, self.data_seed,
                                                _spec(self.cfg), self.device)
                    self.update_norms[name] = float(torch.linalg.norm(
                        trainer.model.params[name].detach() - start))
                    del start

    def records(self) -> dict:
        return {'losses': self.losses, 'grad_norms': self.grad_norms,
                'update_norms': self.update_norms, 'seed': self.seed}


def build_train(cfg: dict, traffic: dict, seed: int, device) -> TrainSession:
    return TrainSession(cfg, traffic, seed, device)


def _view_draws(trainer_seed_: int, views: int, count: int) -> list[int]:
    rng = np.random.default_rng(trainer_seed_)
    return [int(rng.integers(views)) for _ in range(count)]


def reference_train(cfg: dict, traffic: dict, seed: int, records: dict,
                    device, dtype=torch.float32, fault: str | None = None
                    ) -> dict:
    """The reference's three steps from the same capture and views: each
    step's loss, the first gradients, the change after three steps.
    ``dtype`` bfloat16 is the lower-precision control; ``fault``
    'half_batch' takes the loss over the image's upper half alone."""
    s, model_cfg = cfg['scene'], cfg['port_config']
    train_cfg, render_cfg = model_cfg['TRAINING'], model_cfg['RENDERER']
    start = int(traffic['start_iteration'])
    steps = len(records['losses'])
    draws = _view_draws(records['seed'], s['views'], steps)
    poses = _train_poses(cfg)
    focal = _focal(cfg, s['width'])
    raw = {k: v.to(dtype).requires_grad_(True)
           for k, v in _leaves(cfg, seed, device).items()}
    extent = ref.camera_extent([p[:3, 3] for p in poses])
    fixed = {'features_dc': train_cfg['FEATURE_LR'],
             'features_rest': train_cfg['FEATURE_LR'] / 20.0,
             'opacities': train_cfg['OPACITY_LR'],
             'scales': train_cfg['SCALING_LR'],
             'rotations': train_cfg['ROTATION_LR']}
    adam = Adam(raw, eps=1e-15)
    losses, grad_norms = [], {}
    sh = int(model_cfg['MODEL']['SH_DEGREE'])
    for step, index in enumerate(draws):
        view = view_constants(poses[index], s['width'], s['height'], focal,
                              (0.0, 0.0, 0.0), device)
        target = _targets(cfg, seed, device, [index])[0].to(dtype)
        out = ref.render(raw, view, render_cfg, sh)
        rgb = out['rgb']
        if fault == 'half_batch':
            rgb, target = rgb[:rgb.shape[0] // 2], target[:rgb.shape[0] // 2]
        loss = ref.train_loss(rgb, target, float(train_cfg['LAMBDA_DSSIM']))
        grads = dict(zip(raw, torch.autograd.grad(loss, list(raw.values()))))
        del out
        if step == 0:
            grad_norms = {k: float(torch.linalg.norm(g.float()))
                          for k, g in grads.items()}
        lrs = dict(fixed, positions=ref.position_lr(
            train_cfg['POSITION_LR_INIT'] * extent,
            train_cfg['POSITION_LR_FINAL'] * extent,
            int(train_cfg['NUM_ITERATIONS']), start + step))
        adam.step(grads, lrs)
        losses.append(float(loss.detach()))
        del grads, rgb
    with torch.no_grad():
        update_norms = {}
        for name in LEAVES:
            start_leaf = scene.gaussian_leaf(name, seed, _spec(cfg), device)
            update_norms[name] = float(torch.linalg.norm(
                raw[name].float() - start_leaf))
    return {'losses': losses, 'grad_norms': grad_norms,
            'update_norms': update_norms}


# -- serving -------------------------------------------------------------------

class RenderSession:
    """The program's renderer over the procedural capture and the viewer's
    poses at the traffic's resolution."""

    def __init__(self, cfg: dict, traffic: dict, seed: int, device):
        from nerficg_torch.cameras.base import SharedCameraSettings
        from nerficg_torch.core.registry import Methods
        port = port_config(cfg, seed % 2 ** 32, device)
        model = Methods.get_model(port, device=device)
        _load_model(model, cfg, seed, device)
        self.renderer = Methods.get_renderer(port, model)
        self.views = _views(cfg, _serve_poses(cfg, traffic),
                            traffic['width'], traffic['height'],
                            SharedCameraSettings())
        self.cfg, self.traffic, self.seed = cfg, traffic, seed

    def render(self, view) -> torch.Tensor:
        return self.renderer.render_image(view, benchmark=True)['rgb']


def build_render(cfg: dict, traffic: dict, seed: int, device):
    return RenderSession(cfg, traffic, seed, device)


def reference_frames(cfg: dict, traffic: dict, seed: int, poses: list[int],
                     device, dtype=torch.float32):
    """The reference's frame of each pose index, clamped to [0, 1]: one at
    a time (a generator, so only one frame is held)."""
    raw = {k: v.to(dtype) for k, v in _leaves(cfg, seed, device).items()}
    sh = int(cfg['port_config']['MODEL']['SH_DEGREE'])
    all_poses = _serve_poses(cfg, traffic)
    width, height = traffic['width'], traffic['height']
    with torch.no_grad():
        for i in poses:
            view = view_constants(all_poses[i], width, height,
                                  _focal(cfg, width), (0.0, 0.0, 0.0),
                                  device)
            out = ref.render(raw, view, cfg['port_config']['RENDERER'], sh,
                             packed=True)
            yield torch.clamp(out['rgb'].float(), 0.0, 1.0)


# -- work --------------------------------------------------------------------------

def _frame_work(raw, view, render_cfg, sh, packed) -> dict:
    """A step's (``packed`` False) or a served frame's (True) counts by
    the reference's geometry, with its FLOPs."""
    with torch.no_grad():
        fe = ref.frontend(raw, view['w2c'], view['cam_pos'],
                          view['intrinsics'], sh,
                          float(render_cfg['LOW_PASS_FILTER']))
        width, height = view['intrinsics'][4], view['intrinsics'][5]
        k = int(render_cfg['MAX_PER_TILE'])
        stream = ref.entry_stream(fe, width, height,
                                  int(render_cfg['MAX_TILES_PER_GAUSSIAN']),
                                  k, packed)
        pairs = ref.pair_counts(stream, k)
        counts = torch.clamp(stream['counts'], max=k)
        work = {'entries': pairs['entries'], 'passing': pairs['passing'],
                'num_tiles': stream['num_tiles'],
                'live_chunks': int((-(-counts // roofline.CHUNK)).sum()),
                'stream_entries': int(stream['attrs'].shape[0]),
                'gaussians': int(raw['positions'].shape[0]),
                'pixels': width * height,
                'overflow_gaussians': int(stream['overflow_gaussians']),
                'overflow_entries': int(stream['overflow_entries']),
                'valid_entries': stream['entries']}
    flops = roofline.gs_frame_flops if packed else roofline.gs_step_flops
    return dict(work, flops=flops(work))


def train_work(cfg: dict, traffic: dict, seed: int, records: dict,
               steps: list[int], device) -> list[dict]:
    """The compositor's work in each listed step (by the step's number
    from the first), by the reference's geometry at the capture's start."""
    s, model_cfg = cfg['scene'], cfg['port_config']
    draws = _view_draws(records['seed'], s['views'], max(steps) + 1)
    raw = _leaves(cfg, seed, device)
    poses = _train_poses(cfg)
    sh = int(model_cfg['MODEL']['SH_DEGREE'])
    cache: dict = {}
    out = []
    for step in steps:
        index = draws[step]
        if index not in cache:
            view = view_constants(poses[index], s['width'], s['height'],
                                  _focal(cfg, s['width']), (0.0, 0.0, 0.0),
                                  device)
            cache[index] = _frame_work(raw, view, model_cfg['RENDERER'], sh,
                                       packed=False)
        out.append(cache[index])
    return out


def render_work(cfg: dict, traffic: dict, seed: int, poses: list[int],
                device) -> list[dict]:
    raw = _leaves(cfg, seed, device)
    all_poses = _serve_poses(cfg, traffic)
    width, height = traffic['width'], traffic['height']
    sh = int(cfg['port_config']['MODEL']['SH_DEGREE'])
    cache: dict = {}
    out = []
    for i in poses:
        if i not in cache:
            view = view_constants(all_poses[i], width, height,
                                  _focal(cfg, width), (0.0, 0.0, 0.0),
                                  device)
            cache[i] = _frame_work(raw, view, cfg['port_config']['RENDERER'],
                                   sh, packed=True)
        out.append(cache[i])
    return out
