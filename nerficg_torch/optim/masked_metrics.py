"""Masked image metrics for dynamic scenes: mPSNR, mSSIM and mLPIPS, the
port of nerficg_tpu/optim/masked_metrics.py (reference:
src/Optim/MaskedMetrics.py:36-215, itself adapted from dycheck): PSNR over
the masked pixels, and SSIM from partial-convolution windows whose
statistics never mix masked and unmasked pixels. mLPIPS scores both images
with the mask applied.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from nerficg_torch.optim.lpips import f32_convolutions

__all__ = ['masked_psnr', 'masked_ssim', 'compute_masked_metrics']


def _binary_mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """mask > 0.5 as ``like``'s dtype, (H, W) made (H, W, 1)."""
    mask = (mask > 0.5).to(like.dtype)
    return mask[..., None] if mask.ndim == 2 else mask


def masked_psnr(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                max_val: float = 1.0) -> torch.Tensor:
    """PSNR over the pixels where mask > 0.5."""
    mask = _binary_mask(mask, pred)
    err = ((pred - target) ** 2) * mask
    denom = torch.clamp(mask.sum() * pred.shape[-1] / mask.shape[-1],
                        min=1.0)
    mse = err.sum() / denom
    return -10.0 * torch.log10(torch.clamp(mse / max_val ** 2, min=1e-12))


def _conv_valid(img: torch.Tensor, kernel_2d: torch.Tensor) -> torch.Tensor:
    """VALID per-channel 2-D convolution of (H, W, C) with one small
    kernel, in float32."""
    t = img.permute(2, 0, 1)[None]                            # (1, C, H, W)
    k = kernel_2d[None, None].expand(t.shape[1], 1, *kernel_2d.shape)
    with f32_convolutions():
        out = F.conv2d(t, k.contiguous(), groups=t.shape[1])
    return out[0].permute(1, 2, 0)


def _partial_filter(x: torch.Tensor, mask: torch.Tensor,
                    filt: torch.Tensor) -> torch.Tensor:
    """dycheck's separable partial-convolution Gaussian filter: each 1-D
    pass filters x * m and renormalises by the count of unmasked pixels
    under a ones kernel (times the filter's size), and the mask is made
    binary again between the passes."""
    size = filt.shape[0]
    ones = torch.ones_like(filt)

    def one_pass(z, m, horizontal):
        f2 = filt[None, :] if horizontal else filt[:, None]
        o2 = ones[None, :] if horizontal else ones[:, None]
        z_ = _conv_valid(z * m, f2)
        m_ = _conv_valid(m, o2)
        z_out = torch.where(m_ != 0,
                            z_ * float(size) / torch.clamp(m_, min=1e-12),
                            torch.zeros_like(z_))
        return z_out, (m_ != 0).to(x.dtype)

    m3 = mask.expand(x.shape)
    z, m = one_pass(x, m3, True)
    z, _ = one_pass(z, m, False)
    return z


def masked_ssim(pred: torch.Tensor, target: torch.Tensor, mask: torch.Tensor,
                max_val: float = 1.0, window: int = 11,
                filter_sigma: float = 1.5, k1: float = 0.01,
                k2: float = 0.03) -> torch.Tensor:
    """SSIM from Gaussian-window (sigma 1.5) partial-convolution statistics,
    dycheck's protocol, so that mSSIM is comparable with published tables.
    Its quirks are kept: a fully masked window scores 1, and the score is
    the mean over all windows."""
    mask = _binary_mask(mask, pred)
    hw = window // 2
    shift = (2 * hw - window + 1) / 2
    f_i = ((torch.arange(window, dtype=pred.dtype, device=pred.device)
            - hw + shift) / filter_sigma) ** 2
    filt = torch.exp(-0.5 * f_i)
    filt = filt / filt.sum()

    mu_p = _partial_filter(pred, mask, filt)
    mu_t = _partial_filter(target, mask, filt)
    s_pp = torch.clamp(_partial_filter(pred * pred, mask, filt)
                       - mu_p * mu_p, min=0.0)
    s_tt = torch.clamp(_partial_filter(target * target, mask, filt)
                       - mu_t * mu_t, min=0.0)
    s_pt = _partial_filter(pred * target, mask, filt) - mu_p * mu_t
    s_pt = torch.sign(s_pt) * torch.minimum(torch.sqrt(s_pp * s_tt),
                                            torch.abs(s_pt))
    c1 = (k1 * max_val) ** 2
    c2 = (k2 * max_val) ** 2
    ssim_map = ((2 * mu_p * mu_t + c1) * (2 * s_pt + c2)) / \
               ((mu_p ** 2 + mu_t ** 2 + c1) * (s_pp + s_tt + c2))
    return ssim_map.mean()


def compute_masked_metrics(pred: np.ndarray, target: np.ndarray,
                           mask: np.ndarray,
                           device: torch.device | str = 'cpu'
                           ) -> dict[str, float]:
    """mPSNR, mSSIM and mLPIPS of one (H, W, 3) image pair in [0, 1] under
    an (H, W) or (H, W, 1) mask, on ``device`` (``generate_tables``'s
    masked columns)."""
    from nerficg_torch.optim.metrics import lpips, lpips_available
    p = torch.as_tensor(np.asarray(pred, np.float32), device=device)
    t = torch.as_tensor(np.asarray(target, np.float32), device=device)
    m = torch.as_tensor(np.asarray(mask, np.float32), device=device)
    out = {'mPSNR': float(masked_psnr(p, t, m)),
           'mSSIM': float(masked_ssim(p, t, m))}
    if lpips_available():
        m3 = m[..., None] if m.ndim == 2 else m
        out['mLPIPS'] = lpips(p * m3, t * m3)
    else:
        out['mLPIPS'] = float('nan')
    return out
