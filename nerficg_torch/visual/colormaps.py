"""Color maps for depth and error visualization, ported from
nerficg_tpu/visual/colormaps.py (reference: src/Visual/ColorMap.py,
src/Visual/utils.py:8-34). The 256-entry LUTs come from matplotlib when it
is installed, else a grayscale ramp, as in the JAX package."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from nerficg_torch.core.errors import VisualizationError

__all__ = ['ColorMap', 'apply_color_map']

_MPL_NAMES = {
    'TURBO': 'turbo', 'SPECTRAL': 'Spectral', 'MAGMA': 'magma',
    'INFERNO': 'inferno', 'PLASMA': 'plasma', 'VIRIDIS': 'viridis',
    'CIVIDIS': 'cividis', 'TWILIGHT': 'twilight', 'JET': 'jet',
    'GRAY': 'gray',
}


@lru_cache(maxsize=None)
def _lut(name: str) -> np.ndarray:
    """256x3 float32 LUT."""
    key = name.upper()
    if key not in _MPL_NAMES:
        raise VisualizationError(
            f'unknown colormap {name!r}; options: {sorted(_MPL_NAMES)}')
    try:
        import matplotlib
    except ImportError:
        ramp = np.linspace(0, 1, 256, dtype=np.float32)
        return np.stack([ramp, ramp, ramp], axis=-1)
    cmap = matplotlib.colormaps[_MPL_NAMES[key]]
    return cmap(np.linspace(0, 1, 256))[:, :3].astype(np.float32)


class ColorMap:
    """(reference: Visual/ColorMap.py:8-87)"""

    options = sorted(_MPL_NAMES)

    @staticmethod
    def get(name: str) -> np.ndarray:
        return _lut(name)

    @staticmethod
    def apply(values: torch.Tensor, name: str = 'TURBO',
              interpolate: bool = True) -> torch.Tensor:
        """Map values in [0, 1] (...,) -> colors (..., 3): linear between
        LUT entries, or with ``interpolate=False`` the nearest entry."""
        lut = torch.as_tensor(_lut(name), device=values.device)
        v = torch.clamp(values, 0.0, 1.0)
        if not interpolate:
            return lut[torch.clamp((v * 255.0 + 0.5).long(), 0, 255)]
        pos = v * 255.0
        lo = torch.clamp(torch.floor(pos).long(), 0, 255)
        hi = torch.clamp(lo + 1, 0, 255)
        frac = (pos - lo.to(pos.dtype))[..., None]
        return lut[lo] * (1.0 - frac) + lut[hi] * frac


def apply_color_map(values: torch.Tensor, name: str = 'TURBO',
                    min_value: float | None = None,
                    max_value: float | None = None,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Min/max normalize (..., 1) or (...,) values and colorize -> (..., 3).
    With a boolean ``mask`` the min and max are taken over the masked
    values only, and colors outside it are zero."""
    values = values.float()
    if values.ndim >= 1 and values.shape[-1] == 1:
        values = values[..., 0]
    if mask is not None:
        lo = torch.where(mask, values, torch.inf).min() \
            if min_value is None else min_value
        hi = torch.where(mask, values, -torch.inf).max() \
            if max_value is None else max_value
    else:
        lo = values.min() if min_value is None else min_value
        hi = values.max() if max_value is None else max_value
    norm = (values - lo) / max(float(hi - lo), 1e-12)
    colors = ColorMap.apply(norm, name)
    if mask is not None:
        colors = torch.where(mask[..., None], colors, 0.0)
    return colors
