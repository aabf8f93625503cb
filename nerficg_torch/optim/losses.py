"""Losses, ported from nerficg_tpu/optim/losses.py: ``mse`` and ``l1``
(each with its mask form), ``dssim`` (:52; reference:
Optim/Losses/DSSIM.py:11-19, which wraps fused-ssim), the regularisers
``charbonnier``, ``background_entropy``, ``depth_smoothness``,
``magnitude`` and Barron's ``robust_loss`` (reference: Optim/Losses/
Charbonnier.py, BackgroundEntropy.py, DepthSmoothness.py, Magnitude.py,
Robust.py), ``vgg_perceptual`` over LPIPS's VGG16 trunk, and the named
weighted loss container (reference: Optim/Losses/Base.py:11-63)."""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Optional

import torch

from nerficg_torch.optim.metrics import ssim

__all__ = ['LossTerm', 'LossContainer', 'mse', 'l1', 'charbonnier', 'dssim',
           'background_entropy', 'depth_smoothness', 'magnitude',
           'robust_loss', 'vgg_perceptual']


def mse(pred: torch.Tensor, target: torch.Tensor,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared error; with ``mask`` (broadcast over the last axis),
    the masked sum over max(sum(mask) * channels, 1e-8)."""
    err = (pred - target) ** 2
    if mask is not None:
        return (err * mask).sum() / torch.clamp(mask.sum() * err.shape[-1],
                                                min=1e-8)
    return torch.mean(err)


def l1(pred: torch.Tensor, target: torch.Tensor,
       mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean absolute error; with ``mask``, as ``mse``'s mask form."""
    err = torch.abs(pred - target)
    if mask is not None:
        return (err * mask).sum() / torch.clamp(mask.sum() * err.shape[-1],
                                                min=1e-8)
    return torch.mean(err)


def charbonnier(pred: torch.Tensor, target: torch.Tensor,
                eps: float = 1e-3) -> torch.Tensor:
    return torch.mean(torch.sqrt((pred - target) ** 2 + eps * eps))


def dssim(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Structural dissimilarity (1 - SSIM) / 2 of (H, W, C) images."""
    return (1.0 - ssim(pred, target)) / 2.0


def background_entropy(alpha: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """Binary entropy of alpha, pushing it to 0 or 1."""
    a = torch.clamp(alpha, eps, 1.0 - eps)
    return torch.mean(-a * torch.log(a) - (1.0 - a) * torch.log(1.0 - a))


def depth_smoothness(depth: torch.Tensor, rgb: torch.Tensor) -> torch.Tensor:
    """Edge-aware smoothness of an (H, W, 1) depth under (H, W, 3) rgb."""
    ddx = torch.abs(depth[:, 1:] - depth[:, :-1])
    ddy = torch.abs(depth[1:, :] - depth[:-1, :])
    wx = torch.exp(-torch.mean(torch.abs(rgb[:, 1:] - rgb[:, :-1]), -1,
                               keepdim=True))
    wy = torch.exp(-torch.mean(torch.abs(rgb[1:, :] - rgb[:-1, :]), -1,
                               keepdim=True))
    return torch.mean(ddx * wx) + torch.mean(ddy * wy)


def magnitude(values: torch.Tensor, order: int = 1) -> torch.Tensor:
    """Mean |values| (order 1) or mean values^2."""
    return torch.mean(torch.abs(values) if order == 1 else values ** 2)


def robust_loss(x: torch.Tensor, alpha: float = 1.0,
                scale: float = 1.0) -> torch.Tensor:
    """Barron's general robust loss; alpha 2, 0 and -inf are its limits."""
    sq = (x / scale) ** 2
    if alpha == 2.0:
        return torch.mean(0.5 * sq)
    if alpha == 0.0:
        return torch.mean(torch.log1p(0.5 * sq))
    if alpha == -math.inf:
        return torch.mean(1.0 - torch.exp(-0.5 * sq))
    beta = abs(alpha - 2.0)
    return torch.mean((beta / alpha) * ((sq / beta + 1.0) ** (alpha / 2.0)
                                        - 1.0))


def vgg_perceptual(pred: torch.Tensor, target: torch.Tensor,
                   params: dict | None = None) -> torch.Tensor:
    """Mean L1 over the five VGG16 blocks' activations of (H, W, 3) or
    (N, H, W, 3) images in [0, 1] (reference: Optim/Losses/VGG.py:22,
    which uses VGG19 with the same five-block protocol). ``params``
    defaults to the LPIPS weights file on the images' device; without one
    it raises."""
    from nerficg_torch.optim.lpips import load_weights, vgg_features
    if params is None:
        params = load_weights(device=pred.device)
    if params is None:
        raise RuntimeError(
            'vgg_perceptual needs VGG16 weights: set NERFICG_LPIPS_WEIGHTS '
            'to a weights npz (optim/lpips.py save_weights_npz)')
    if pred.ndim == 3:
        pred, target = pred[None], target[None]
    fa = vgg_features(params, pred * 2.0 - 1.0)
    fb = vgg_features(params, target * 2.0 - 1.0)
    total = pred.new_zeros(())
    for a, b in zip(fa, fb):
        total = total + torch.mean(torch.abs(a - b))
    return total


@dataclass
class LossTerm:
    name: str
    fn: Callable[..., torch.Tensor]
    weight: float = 1.0
    is_metric: bool = False   # logged, not summed into the loss


class LossContainer:
    """Named weighted loss terms and quality metrics:
        total, logs = container(name1=dict(pred=..., target=...), ...)
    ``accumulate`` and ``flush`` average logged values on the host."""

    def __init__(self):
        self.terms: dict[str, LossTerm] = {}
        self._accum: dict[str, list[float]] = {}

    def add_loss(self, name: str, fn: Callable,
                 weight: float = 1.0) -> 'LossContainer':
        self.terms[name] = LossTerm(name, fn, weight, is_metric=False)
        return self

    def add_metric(self, name: str, fn: Callable) -> 'LossContainer':
        self.terms[name] = LossTerm(name, fn, 0.0, is_metric=True)
        return self

    def __call__(self, **term_kwargs) -> tuple[torch.Tensor,
                                               dict[str, torch.Tensor]]:
        total = torch.zeros(())
        logs: dict[str, torch.Tensor] = {}
        for name, kwargs in term_kwargs.items():
            if kwargs is None:
                continue
            term = self.terms[name]
            value = term.fn(**kwargs)
            logs[name] = value
            if not term.is_metric:
                total = total + term.weight * value
        logs['total'] = total
        return total, logs

    def accumulate(self, logs: dict) -> None:
        for key, value in logs.items():
            self._accum.setdefault(key, []).append(float(value))

    def flush(self) -> dict[str, float]:
        out = {k: sum(v) / len(v) for k, v in self._accum.items() if v}
        self._accum.clear()
        return out
