"""Color maps for depth visualization, ported from
nerficg_tpu/visual/colormaps.py (reference: src/Visual/ColorMap.py,
src/Visual/utils.py:8-34). The 256-entry LUTs come from matplotlib when it
is installed, else a grayscale ramp, as in the JAX package."""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from nerficg_torch.core.errors import VisualizationError

__all__ = ['apply_color_map']

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


def apply_color_map(values: torch.Tensor, name: str = 'TURBO',
                    min_value: float | None = None,
                    max_value: float | None = None) -> torch.Tensor:
    """Min/max normalize (..., 1) or (...,) values and colorize with linear
    interpolation between LUT entries -> (..., 3)."""
    values = values.float()
    if values.ndim >= 1 and values.shape[-1] == 1:
        values = values[..., 0]
    lo = values.min() if min_value is None else min_value
    hi = values.max() if max_value is None else max_value
    norm = (values - lo) / max(float(hi - lo), 1e-12)
    lut = torch.as_tensor(_lut(name), device=values.device)
    pos = torch.clamp(norm, 0.0, 1.0) * 255.0
    idx_lo = torch.clamp(torch.floor(pos).long(), 0, 255)
    idx_hi = torch.clamp(idx_lo + 1, 0, 255)
    frac = (pos - idx_lo.float())[..., None]
    return lut[idx_lo] * (1.0 - frac) + lut[idx_hi] * frac
