"""Pose math: rotations, look-at, affine inverses, FOV helpers, and the
scene alignments of the COLMAP loaders (recentering, PCA, the unit cube).

Port of nerficg_tpu/cameras/pose.py (reference: src/Cameras/utils.py:145-253,
src/Datasets/utils.py:192-204,465-533). Numpy float64 on the host, so the
two packages give the same poses bit for bit. Coordinate convention: COLMAP
right-handed, x right / y down / z forward.
"""

from __future__ import annotations

import math

import numpy as np

__all__ = [
    'look_at', 'quaternion_to_rotation_matrix', 'rotation_matrix_to_quaternion',
    'invert_3d_affine', 'fov_to_focal', 'focal_to_fov', 'average_pose',
    'recenter_poses', 'transform_poses_pca', 'rescale_poses_to_unit_cube',
]


def look_at(eye: np.ndarray, target: np.ndarray,
            up: np.ndarray | None = None) -> np.ndarray:
    """4x4 c2w matrix looking from eye to target (reference: Cameras/utils.py:145).

    Camera convention: x right, y down, z forward (COLMAP).
    """
    eye = np.asarray(eye, dtype=np.float64)
    target = np.asarray(target, dtype=np.float64)
    if up is None:
        up = np.array([0.0, -1.0, 0.0])
    forward = target - eye
    forward = forward / (np.linalg.norm(forward) + 1e-12)
    right = np.cross(-up, forward)
    right = right / (np.linalg.norm(right) + 1e-12)
    down = np.cross(forward, right)
    c2w = np.eye(4, dtype=np.float64)
    c2w[:3, 0] = right
    c2w[:3, 1] = down
    c2w[:3, 2] = forward
    c2w[:3, 3] = eye
    return c2w


def quaternion_to_rotation_matrix(q) -> np.ndarray:
    """wxyz quaternion(s) -> rotation matrix (reference: Cameras/utils.py:180-208)."""
    q = np.asarray(q, dtype=np.float64)
    q = q / (np.linalg.norm(q, axis=-1, keepdims=True) + 1e-12)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rot = np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1)
    return rot.reshape(*q.shape[:-1], 3, 3)


def rotation_matrix_to_quaternion(m: np.ndarray) -> np.ndarray:
    """3x3 rotation matrix -> wxyz quaternion (stable branch selection)."""
    m = np.asarray(m, dtype=np.float64)
    t = np.trace(m)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        return np.array([0.25 * s, (m[2, 1] - m[1, 2]) / s,
                         (m[0, 2] - m[2, 0]) / s, (m[1, 0] - m[0, 1]) / s])
    i = int(np.argmax(np.diag(m)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(m[i, i] - m[j, j] - m[k, k] + 1.0, 1e-12)) * 2
    q = np.empty(4)
    q[0] = (m[k, j] - m[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (m[j, i] + m[i, j]) / s
    q[1 + k] = (m[k, i] + m[i, k]) / s
    return q


def invert_3d_affine(mat: np.ndarray) -> np.ndarray:
    """Fast inverse of a 4x4 rigid/affine transform (reference: Cameras/utils.py:211)."""
    mat = np.asarray(mat)
    rot = mat[..., :3, :3]
    t = mat[..., :3, 3:]
    rot_inv = np.swapaxes(rot, -1, -2)
    out = np.zeros_like(mat)
    out[..., :3, :3] = rot_inv
    out[..., :3, 3:] = -rot_inv @ t
    out[..., 3, 3] = 1.0
    return out


def fov_to_focal(fov_rad: float, size: float) -> float:
    """(reference: Cameras/utils.py:225-234)"""
    return 0.5 * size / math.tan(0.5 * fov_rad)


def focal_to_fov(focal: float, size: float) -> float:
    return 2.0 * math.atan2(0.5 * size, focal)


def average_pose(c2ws: np.ndarray) -> np.ndarray:
    """Mean camera pose (reference: Datasets/utils.py:192-204)."""
    c2ws = np.asarray(c2ws, dtype=np.float64)
    center = c2ws[:, :3, 3].mean(0)
    forward = c2ws[:, :3, 2].mean(0)
    down = c2ws[:, :3, 1].mean(0)
    forward = forward / (np.linalg.norm(forward) + 1e-12)
    right = np.cross(down, forward)
    right = right / (np.linalg.norm(right) + 1e-12)
    down = np.cross(forward, right)
    avg = np.eye(4)
    avg[:3, 0], avg[:3, 1], avg[:3, 2], avg[:3, 3] = right, down, forward, center
    return avg


def recenter_poses(c2ws: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Recenter all poses around their average (reference: Datasets/utils.py:192-204).

    Returns (new_c2ws, applied_transform).
    """
    avg = average_pose(c2ws)
    transform = invert_3d_affine(avg)
    return transform[None] @ c2ws, transform


def transform_poses_pca(c2ws: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """PCA-align poses so the ground plane is xy (reference: Datasets/utils.py:474-533,
    Zip-NeRF-style). Returns (aligned_c2ws, transform)."""
    c2ws = np.asarray(c2ws, dtype=np.float64)
    t = c2ws[:, :3, 3]
    t_mean = t.mean(0)
    t_centered = t - t_mean
    eigval, eigvec = np.linalg.eigh(t_centered.T @ t_centered)
    # Sort eigenvectors by descending eigenvalue.
    rot = eigvec[:, np.argsort(eigval)[::-1]].T
    if np.linalg.det(rot) < 0:
        rot = np.diag(np.array([1.0, 1.0, -1.0])) @ rot
    transform = np.eye(4)
    transform[:3, :3] = rot
    transform[:3, 3] = -rot @ t_mean
    aligned = transform[None] @ c2ws
    # Flip so that the average camera "down" (+y in COLMAP convention, which
    # corresponds to -z world up) points consistently: keep mean y-axis down.
    if aligned[:, 2, 1].mean() < 0:
        flip = np.diag(np.array([1.0, -1.0, -1.0, 1.0]))
        aligned = flip[None] @ aligned
        transform = flip @ transform
    # Scale translations into [-1, 1].
    scale = 1.0 / max(np.abs(aligned[:, :3, 3]).max(), 1e-12)
    aligned[:, :3, 3] *= scale
    scale_mat = np.diag(np.array([scale, scale, scale, 1.0]))
    transform = scale_mat @ transform
    return aligned, transform


def rescale_poses_to_unit_cube(c2ws: np.ndarray,
                               aabb: np.ndarray | None = None
                               ) -> tuple[np.ndarray, np.ndarray]:
    """Recenter + scale so camera positions (or aabb) fit in [-1,1]^3
    (reference: Datasets/utils.py:465). Returns (new_c2ws, transform)."""
    c2ws = np.asarray(c2ws, dtype=np.float64).copy()
    pts = c2ws[:, :3, 3] if aabb is None else np.asarray(aabb).reshape(-1, 3)
    center = 0.5 * (pts.min(0) + pts.max(0))
    scale = 1.0 / max((pts.max(0) - pts.min(0)).max() * 0.5, 1e-12)
    transform = np.eye(4)
    transform[:3, :3] *= scale
    transform[:3, 3] = -center * scale
    c2ws[:, :3, 3] = (c2ws[:, :3, 3] - center) * scale
    return c2ws, transform
