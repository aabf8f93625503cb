"""Image-quality metrics: PSNR and SSIM, ported from
nerficg_tpu/optim/metrics.py (reference: Base/Renderer.py:103-161, which
uses torchmetrics). LPIPS needs VGG weights that no run here can fetch, so
it is reported as NaN, as the JAX package does without its weight file."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ['mse_to_psnr', 'psnr', 'ssim', 'compute_all_metrics']


def mse_to_psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def psnr(pred: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2) / (max_val ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def _gaussian_kernel(size: int = 11, sigma: float = 1.5) -> torch.Tensor:
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return g / g.sum()


def _filter2d_separable(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable gaussian filter on (H, W, C), 'valid' padding, as k shifted
    multiply-adds per axis."""
    k = kernel.shape[0]
    x = img.permute(2, 0, 1)                           # (C, H, W)
    w_out = x.shape[2] - k + 1
    acc = kernel[0] * x[:, :, 0:w_out]
    for i in range(1, k):
        acc = acc + kernel[i] * x[:, :, i:i + w_out]
    h_out = x.shape[1] - k + 1
    out = kernel[0] * acc[:, 0:h_out]
    for i in range(1, k):
        out = out + kernel[i] * acc[:, i:i + h_out]
    return out.permute(1, 2, 0)


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03) -> torch.Tensor:
    """Gaussian-windowed SSIM on (H, W, C) images (torchmetrics defaults)."""
    kernel = _gaussian_kernel(kernel_size, sigma).to(pred.device)
    mu_p = _filter2d_separable(pred, kernel)
    mu_t = _filter2d_separable(target, kernel)
    mu_pp = _filter2d_separable(pred * pred, kernel)
    mu_tt = _filter2d_separable(target * target, kernel)
    mu_pt = _filter2d_separable(pred * target, kernel)
    var_p = mu_pp - mu_p * mu_p
    var_t = mu_tt - mu_t * mu_t
    cov = mu_pt - mu_p * mu_t
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    ssim_map = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / \
               ((mu_p * mu_p + mu_t * mu_t + c1) * (var_p + var_t + c2))
    return ssim_map.mean()


def compute_all_metrics(pred: np.ndarray, target: np.ndarray,
                        device: torch.device | str = 'cpu') -> dict[str, float]:
    """PSNR/SSIM/LPIPS for one (H, W, 3) image pair in [0, 1]."""
    p = torch.as_tensor(np.asarray(pred, np.float32), device=device)
    t = torch.as_tensor(np.asarray(target, np.float32), device=device)
    return {'PSNR': float(psnr(p, t)), 'SSIM': float(ssim(p, t)),
            'LPIPS': float('nan')}
