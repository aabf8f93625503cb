"""Pieces the method adapters share: seeds, the in-memory dataset, view
constants, and the norms the training comparison takes."""

from __future__ import annotations

import math
import statistics

import numpy as np
import torch

__all__ = ['rows_differ', 'trainer_seed', 'scene_dataset', 'w2c_of', 'view_constants',
           'leaf_gaps', 'adam_first_grad_norms', 'finite_or_inf',
           'port_config', 'compare_train']


def rows_differ(seed: int, draws: int, pool: int, count: int = 3) -> bool:
    """Whether the first ``count`` draws of the trainer's generator
    (``np.random.default_rng(seed).integers``, ``draws`` per step from
    ``pool``; one draw a step is a scalar) hit no row twice."""
    rng = np.random.default_rng(seed)
    rows = np.concatenate([np.atleast_1d(rng.integers(0, pool, size=draws)
                                         if draws > 1 else
                                         rng.integers(pool))
                           for _ in range(count)])
    return len(np.unique(rows)) == len(rows)


def trainer_seed(seed: int, draws: int, pool: int, count: int = 3) -> int:
    """The program's RANDOM_SEED for a run (under 2^32, as the port's
    setup takes it): the first of seed, seed + 1, ... (mod 2^32) whose
    checked steps see rows (views; rays) that all differ, as the check
    asks of them: a path that served a row again from a stale result, or
    dropped a repeated row, could otherwise agree with the reference on
    that row. The reference draws its rows from the same RANDOM_SEED, and
    a seed whose rows repeat is judged correct as well (a CPU test)."""
    s = int(seed) % 2 ** 32
    for _ in range(10000):
        if rows_differ(s, draws, pool, count):
            return s
        s = (s + 1) % 2 ** 32
    raise ValueError(f'no seed from {seed} on draws {count} x {draws} '
                     f'distinct rows of {pool}')


def scene_dataset(port, views_of):
    """A dataset of the port's type holding views made in memory:
    ``views_of(camera_settings)`` returns {subset: [View]}."""
    from nerficg_torch.data.base import BaseDataset

    class SceneDataset(BaseDataset):
        def load(self):
            for subset, views in views_of(self.camera_settings).items():
                self.subsets[subset] = list(views)

    return SceneDataset(port, path='.')


def w2c_of(c2w: np.ndarray) -> np.ndarray:
    """World-to-camera of a rigid (4, 4) camera-to-world, float64."""
    c2w = np.asarray(c2w, np.float64)
    out = np.zeros_like(c2w)
    rot_inv = c2w[:3, :3].T
    out[:3, :3] = rot_inv
    out[:3, 3:] = -rot_inv @ c2w[:3, 3:]
    out[3, 3] = 1.0
    return out


def view_constants(c2w, width: int, height: int, focal: float,
                   background, device) -> dict:
    return {'w2c': torch.as_tensor(w2c_of(c2w).astype(np.float32),
                                   device=device),
            'cam_pos': torch.as_tensor(np.asarray(c2w)[:3, 3]
                                       .astype(np.float32), device=device),
            'intrinsics': (float(focal), float(focal), width / 2.0,
                           height / 2.0, int(width), int(height)),
            'background': torch.as_tensor(np.asarray(background, np.float32),
                                          device=device)}


def adam_first_grad_norms(optimizer, named: dict) -> dict:
    """Each leaf's gradient as Adam took it in its first step, from its
    state: exp_avg = (1 - beta1) g after one step."""
    out = {}
    for group in optimizer.param_groups:
        beta1 = group['betas'][0]
        for p in group['params']:
            state = optimizer.state.get(p, {})
            out[named[id(p)]] = float(torch.linalg.norm(
                state['exp_avg'].float())) / (1.0 - beta1) \
                if 'exp_avg' in state else 0.0
    return out


def leaf_gaps(program: dict, reference: dict,
              keep: set | None = None) -> tuple[float, str]:
    """(worst gap, its leaf): per leaf |program norm - reference norm| over
    the larger of that leaf's reference norm and the median leaf's, over
    the leaves in ``keep`` (default all)."""
    names = [n for n in reference if keep is None or n in keep]
    median = statistics.median(reference[n] for n in names)
    worst, where = 0.0, ''
    for n in names:
        gap = finite_or_inf(abs(program[n] - reference[n]) /
                            max(reference[n], median, 1e-30))
        if gap >= worst:
            worst, where = gap, n
    return worst, where


def finite_or_inf(x: float) -> float:
    """``x``, or infinity where it is not a number: a NaN fails a limit."""
    return x if x == x else math.inf


def port_config(cfg: dict, seed: int, device):
    """The configuration as the port runs it, its framework set up as the
    entry points set it up (``core.setup``: TF32 off, seeds)."""
    from nerficg_torch.core.config import ConfigNode
    from nerficg_torch.core.setup import setup
    port = ConfigNode(cfg['port_config'])
    port.GLOBAL.RANDOM_SEED = int(seed)
    setup(config=port, device=device)
    return port


def compare_train(program: dict, reference: dict) -> dict:
    """The numbers the limits hold: the worst step's relative loss gap, the
    worst leaf's gap of first-gradient norms and of three-step change
    norms (leaves the reference's gradient leaves at round-off, under a
    thousandth of the median leaf's, are left out of the change)."""
    loss_gaps = [finite_or_inf(abs(p - r) / max(abs(r), 1e-30))
                 for p, r in zip(program['losses'], reference['losses'])]
    grad_gap, grad_leaf = leaf_gaps(program['grad_norms'],
                                    reference['grad_norms'])
    gnorms = reference['grad_norms']
    median = float(np.median(list(gnorms.values())))
    moving = {k for k, v in gnorms.items() if v >= 1e-3 * median}
    update_gap, update_leaf = leaf_gaps(program['update_norms'],
                                        reference['update_norms'], moving)
    return {'loss_rel_gap': max(loss_gaps), 'grad_norm_gap': grad_gap,
            'update_norm_gap': update_gap, 'loss_gap_by_step': loss_gaps,
            'where': {'grad_norm_gap': grad_leaf,
                      'update_norm_gap': update_leaf}}
