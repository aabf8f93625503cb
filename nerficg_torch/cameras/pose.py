"""Pose helpers, ported from nerficg_tpu/cameras/pose.py (the part
the serving and 3DGS paths use; reference: src/Cameras/utils.py:180-234)."""

from __future__ import annotations

import math

import numpy as np

__all__ = ['fov_to_focal', 'quaternion_to_rotation_matrix',
           'invert_3d_affine']


def quaternion_to_rotation_matrix(q) -> np.ndarray:
    """wxyz quaternion(s) -> rotation matrix, float64 (reference:
    Cameras/utils.py:180-208)."""
    q = np.asarray(q, dtype=np.float64)
    q = q / (np.linalg.norm(q, axis=-1, keepdims=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rot = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1)
    return rot.reshape(*q.shape[:-1], 3, 3)


def invert_3d_affine(mat: np.ndarray) -> np.ndarray:
    """Inverse of a 4x4 rigid transform (reference: Cameras/utils.py:211)."""
    mat = np.asarray(mat)
    rot_inv = np.swapaxes(mat[..., :3, :3], -1, -2)
    out = np.zeros_like(mat)
    out[..., :3, :3] = rot_inv
    out[..., :3, 3:] = -rot_inv @ mat[..., :3, 3:]
    out[..., 3, 3] = 1.0
    return out


def fov_to_focal(fov_rad: float, size: float) -> float:
    """(reference: Cameras/utils.py:225-234)"""
    return 0.5 * size / math.tan(0.5 * fov_rad)

