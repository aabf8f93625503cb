"""Image-quality metrics: PSNR, SSIM and LPIPS, ported from
nerficg_tpu/optim/metrics.py (reference: Base/Renderer.py:103-161, which
uses torchmetrics). LPIPS comes from the VGG weights file of
``optim/lpips.py``, else from the optional ``lpips`` package, else it is
NaN."""

from __future__ import annotations

import functools

import numpy as np
import torch

from nerficg_torch.optim.lpips import lpips_vgg, lpips_weights_available

__all__ = ['mse_to_psnr', 'psnr', 'ssim', 'lpips', 'lpips_available',
           'compute_all_metrics']


def mse_to_psnr(mse: torch.Tensor) -> torch.Tensor:
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


def psnr(pred: torch.Tensor, target: torch.Tensor,
         max_val: float = 1.0) -> torch.Tensor:
    mse = torch.mean((pred - target) ** 2) / (max_val ** 2)
    return -10.0 * torch.log10(torch.clamp(mse, min=1e-12))


@functools.lru_cache(maxsize=None)
def _gaussian_kernel(size: int, sigma: float,
                     device: torch.device) -> torch.Tensor:
    """The 1-D window on ``device``, made once per device: a copy from the
    host would synchronise the stream at every call."""
    x = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    return (g / g.sum()).to(device)


def _filter2d_separable(img: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Separable gaussian filter over the (H, W) axes of (..., H, W, C),
    'valid' padding, as k shifted multiply-adds per axis, W first."""
    k = kernel.shape[0]
    w_out = img.shape[-2] - k + 1
    acc = kernel[0] * img[..., 0:w_out, :]
    for i in range(1, k):
        acc = acc + kernel[i] * img[..., i:i + w_out, :]
    h_out = img.shape[-3] - k + 1
    out = kernel[0] * acc[..., 0:h_out, :, :]
    for i in range(1, k):
        out = out + kernel[i] * acc[..., i:i + h_out, :, :]
    return out


def ssim(pred: torch.Tensor, target: torch.Tensor, max_val: float = 1.0,
         kernel_size: int = 11, sigma: float = 1.5,
         k1: float = 0.01, k2: float = 0.03,
         return_map: bool = False) -> torch.Tensor:
    """Gaussian-windowed SSIM on (H, W, C) images (torchmetrics defaults);
    with ``return_map``, the (H - 10, W - 10, C) map instead of its mean."""
    kernel = _gaussian_kernel(kernel_size, sigma, pred.device)
    # The five moments filtered as two stacks, the three that carry pred's
    # gradient and the two that do not: each element is computed as alone,
    # in a third of the launches, and each moment stays one dense block.
    mu_p, mu_pp, mu_pt = _filter2d_separable(
        torch.stack([pred, pred * pred, pred * target]), kernel)
    mu_t, mu_tt = _filter2d_separable(
        torch.stack([target, target * target]), kernel)
    var_p = mu_pp - mu_p * mu_p
    var_t = mu_tt - mu_t * mu_t
    cov = mu_pt - mu_p * mu_t
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    ssim_map = ((2 * mu_p * mu_t + c1) * (2 * cov + c2)) / \
               ((mu_p * mu_p + mu_t * mu_t + c1) * (var_p + var_t + c2))
    if return_map:
        return ssim_map
    return ssim_map.mean()


# The optional ``lpips`` package's model, tried once.
_lpips_model = None
_lpips_checked = False


def _lpips_package_model():
    global _lpips_model, _lpips_checked
    if not _lpips_checked:
        _lpips_checked = True
        try:
            import lpips as lpips_pkg
            _lpips_model = lpips_pkg.LPIPS(net='vgg', verbose=False).eval()
        except Exception:
            _lpips_model = None
    return _lpips_model


def lpips_available() -> bool:
    """Whether ``lpips`` scores: a weights file (``optim/lpips.py``) or the
    ``lpips`` package. (The JAX package's counts only the package, so its
    sweep and mLPIPS stay NaN with the weights file alone.)"""
    return lpips_weights_available() or _lpips_package_model() is not None


def lpips(pred, target, device: torch.device | str | None = None) -> float:
    """LPIPS-VGG of two (H, W, 3) images in [0, 1] on ``device`` (default:
    a tensor's own, else the CPU): from the weights file if there is one,
    else through the ``lpips`` package, else NaN."""
    if lpips_weights_available():
        return lpips_vgg(pred, target, device=device)
    model = _lpips_package_model()
    if model is None:
        return float('nan')
    if device is None:
        device = pred.device if isinstance(pred, torch.Tensor) else 'cpu'
    model = model.to(device)
    with torch.no_grad():
        p, t = (torch.as_tensor(x, dtype=torch.float32, device=device)
                .permute(2, 0, 1)[None] * 2 - 1 for x in (pred, target))
        return float(model(p, t).item())


def compute_all_metrics(pred: np.ndarray, target: np.ndarray,
                        device: torch.device | str = 'cpu') -> dict[str, float]:
    """PSNR/SSIM/LPIPS for one (H, W, 3) image pair in [0, 1], on
    ``device``."""
    p = torch.as_tensor(np.asarray(pred, np.float32), device=device)
    t = torch.as_tensor(np.asarray(target, np.float32), device=device)
    return {'PSNR': float(psnr(p, t)), 'SSIM': float(ssim(p, t)),
            'LPIPS': lpips(p, t)}
