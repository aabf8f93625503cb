"""Pose helpers, ported from nerficg_tpu/cameras/pose.py (the part
the serving path uses; reference: src/Cameras/utils.py:225-234)."""

from __future__ import annotations

import math

__all__ = ['fov_to_focal']


def fov_to_focal(fov_rad: float, size: float) -> float:
    """(reference: Cameras/utils.py:225-234)"""
    return 0.5 * size / math.tan(0.5 * fov_rad)

