"""k-nearest-neighbour distances for the Gaussians' initial scales.

Port of nerficg_tpu/ops/knn.py (reference: the simple-knn CUDA package, used
once at init for the RMS distance of the k=3 neighbours,
src/Methods/GaussianSplatting/Model.py:94-119). The JAX package asks
sklearn, or falls back to a chunked brute force that is slow over 100k
points; the port asks scipy's k-d tree for the same exact distances.
"""

from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

__all__ = ['knn_mean_sq_distance']


def knn_mean_sq_distance(points: np.ndarray, k: int = 3) -> np.ndarray:
    """(N,) f32 mean squared distance to the k nearest other points."""
    points = np.asarray(points, np.float32)
    n = points.shape[0]
    if n <= k:
        d = np.linalg.norm(points[:, None] - points[None, :], axis=-1)
        np.fill_diagonal(d, np.inf)
        d = np.sort(d, axis=-1)[:, :max(n - 1, 1)]
        return (d ** 2).mean(-1)
    dist, _ = cKDTree(points.astype(np.float64)).query(points, k=k + 1)
    return (dist[:, 1:] ** 2).mean(-1).astype(np.float32)
