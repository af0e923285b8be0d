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


def knn_mean_sq_dist_bf16(points: np.ndarray, k: int = 3,
                          block: int = 1024, device="cpu") -> np.ndarray:
    """JAX's knn_mean_sq_dist as it runs on a TPU: the blocked brute force
    |a|^2 + |b|^2 - 2 a.b in float32, whose a.b matmul takes the TPU's
    default precision for float32 (one bfloat16 pass: both operands
    rounded to bfloat16, products summed in float32). Its error, ~2^-8
    |a||b|, exceeds the squared spacing of a dense plot, so most of the k
    smallest values come out at or below zero. Used only to rebuild scenes
    that JAX's generator wrote on a TPU (io/synthetic.py)."""
    import torch

    pts = torch.as_tensor(np.asarray(points, np.float32), device=device)
    sq = (pts * pts).sum(-1)
    low = pts.to(torch.bfloat16).float()
    out = []
    for start in range(0, len(pts), block):
        rows = low[start:start + block]
        d2 = (sq[start:start + block, None] + sq[None, :]
              - 2.0 * (rows @ low.T))
        own = torch.arange(len(rows), device=pts.device)
        d2[own, own + start] = float("inf")
        out.append(-torch.topk(-d2, k, dim=1).values.mean(1))
    return torch.cat(out).cpu().numpy()
