"""Photometric losses of the 3DGS trainer, ported from
nerficg_tpu/optim/losses.py (``l1``, ``dssim`` :52; reference:
Optim/Losses/DSSIM.py:11-19, which wraps fused-ssim)."""

from __future__ import annotations

import torch

from nerficg_torch.optim.metrics import ssim

__all__ = ['l1', 'dssim']


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return torch.mean(torch.abs(pred - target))


def dssim(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Structural dissimilarity (1 - SSIM) / 2 of (H, W, C) images."""
    return (1.0 - ssim(pred, target)) / 2.0
