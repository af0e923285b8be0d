"""k-nearest-neighbour mean squared distance (simple-knn replacement).

The reference initializes Gaussian scales from `simple_knn._C.distCUDA2`
(scene/gaussian_model.py:148): the mean squared distance from each point to
its 3 nearest neighbours, self excluded. The port computes it exactly with
scipy's cKDTree on the host (O(N log N); it runs once, when a model is
created from a point cloud). Not a kernel: the JAX package's blocked
brute-force form (wheat3dgs_tpu/ops/knn.py) is plain XLA too.
"""

from __future__ import annotations

import numpy as np


def knn_mean_sq_dist(points: np.ndarray, k: int = 3) -> np.ndarray:
    """(N, 3) points -> (N,) float32 mean squared distance to the k nearest
    other points."""
    from scipy.spatial import cKDTree

    pts = np.asarray(points, np.float64)
    d, _ = cKDTree(pts).query(pts, k=k + 1)
    return (d[:, 1:] ** 2).mean(axis=1).astype(np.float32)
