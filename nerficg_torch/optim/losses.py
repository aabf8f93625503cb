"""Losses, ported from nerficg_tpu/optim/losses.py: ``mse`` (with its
mask form), ``l1`` and ``dssim`` (:52; reference: Optim/Losses/DSSIM.py:
11-19, which wraps fused-ssim), and the named weighted loss container
(reference: Optim/Losses/Base.py:11-63)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import torch

from nerficg_torch.optim.metrics import ssim

__all__ = ['LossTerm', 'LossContainer', 'mse', 'l1', 'dssim']


def mse(pred: torch.Tensor, target: torch.Tensor,
        mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean squared error; with ``mask`` (broadcast over the last axis),
    the masked sum over max(sum(mask) * channels, 1e-8)."""
    err = (pred - target) ** 2
    if mask is not None:
        return (err * mask).sum() / torch.clamp(mask.sum() * err.shape[-1],
                                                min=1e-8)
    return torch.mean(err)


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def dssim(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Structural dissimilarity (1 - SSIM) / 2 of (H, W, C) images."""
    return (1.0 - ssim(pred, target)) / 2.0


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
