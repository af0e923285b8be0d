"""Structural trait extraction (reference:
wheatheadsmorphology/traits_extraction_functions.py).

Counterpart of wheat3dgs_tpu/morphology/traits.py, without sklearn: the
3-component PCA (`pca3`, shared with `bbox.py`) follows scikit-learn 1.9's
`PCA(n_components=3).fit` step for step in numpy float64 (BSD-3-Clause,
Copyright (c) 2007-2024 The scikit-learn developers;
`sklearn/decomposition/_pca.py::_fit`, `_fit_full`,
`sklearn/utils/extmath.py::svd_flip`), so its components carry sklearn's
signs, which the inclination and the oriented box depend on.

Traits per head:
  length      — integrated arc length of a smoothing spline fitted to the
                point cloud projected onto the PCA P1-P2 plane;
  width       — 2x the distance_percentile of the point-to-(P1,P2)-plane
                distances;
  volume      — convex-hull volume (scipy Qhull);
  curvature   — spline length / chord length;
  inclination — angle between PCA-1 and the world Z axis, degrees.
"""

from __future__ import annotations

import dataclasses

import numpy as np
from scipy import linalg
from scipy.interpolate import splev, splrep


@dataclasses.dataclass
class PCA3:
    """A fitted 3-component PCA: `components_` (3, 3), rows the axes by
    falling variance, and `mean_` (3,), as sklearn names them."""

    components_: np.ndarray
    mean_: np.ndarray

    def transform(self, X: np.ndarray) -> np.ndarray:
        out = X @ self.components_.T
        out -= np.reshape(self.mean_, (1, -1)) @ self.components_.T
        return out


def pca3(X: np.ndarray) -> PCA3:
    """sklearn's `PCA(n_components=3).fit(X)` for (n, 3) float64 X: the
    covariance eigensolver from 30 points on ("auto" picks it when n >= 10
    x the features), the full SVD below; signs by `svd_flip(u_based_decision
    =False)`, the largest-magnitude entry of each component positive."""
    X = np.asarray(X, dtype=np.float64)
    n, n_features = X.shape
    if not 3 <= min(n, n_features):
        raise ValueError(f"n_components=3 must be between 0 and "
                         f"min(n_samples, n_features)={min(n, n_features)}")
    mean = np.mean(X, axis=0)
    if n >= 10 * n_features:
        C = X.T @ X
        C -= n * np.reshape(mean, (-1, 1)) * np.reshape(mean, (1, -1))
        C /= n - 1
        eigenvals, eigenvecs = np.linalg.eigh(C)
        eigenvecs = np.flip(eigenvecs, axis=1)
        Vt = eigenvecs.T
    else:
        centered = np.array(X, copy=True)
        centered -= mean
        _, _, Vt = linalg.svd(centered, full_matrices=False)
    rows = np.argmax(np.abs(Vt), axis=1)
    signs = np.sign(np.take(np.reshape(Vt, (-1,)),
                            rows + np.arange(Vt.shape[0]) * Vt.shape[1]))
    Vt *= signs[:, np.newaxis]
    # sklearn keeps a copy in the view's memory order (np.asarray(...,
    # copy=True)); the transform's matmul bits depend on that layout.
    return PCA3(components_=Vt[:3].copy(order="K"), mean_=mean)


def run_pca(data: np.ndarray):
    pts = data[:, :3]
    centered = pts - pts.mean(axis=0)
    pca = pca3(centered)
    return pca.transform(centered), pca


def compute_length(pcd_pca_3d: np.ndarray, splines_smoothing_value: float):
    xy = pcd_pca_3d[:, :2]
    order = np.argsort(xy[:, 0])
    x_sorted, y_sorted = xy[order, 0], xy[order, 1]
    tck = splrep(x_sorted, y_sorted, s=splines_smoothing_value)
    x_fine = np.linspace(np.percentile(x_sorted, 0.5),
                         np.percentile(x_sorted, 99.5), 1000)
    y_fine = splev(x_fine, tck)
    axis_pts = np.stack([x_fine, y_fine], axis=1)
    seg = np.diff(axis_pts, axis=0)
    length = float(np.linalg.norm(seg, axis=1).sum())
    return length, tck, axis_pts


def compute_curvature(length: float, axis_pts: np.ndarray) -> float:
    chord = float(np.linalg.norm(axis_pts[-1] - axis_pts[0]))
    return length / chord


def compute_inclination_angle(pca: PCA3) -> float:
    p1 = pca.components_[0]
    cosang = np.dot(p1 / np.linalg.norm(p1), np.array([0.0, 0.0, 1.0]))
    return float(np.degrees(np.arccos(cosang)))


def convex_hull_volume(data: np.ndarray) -> float:
    from scipy.spatial import ConvexHull

    return float(ConvexHull(data[:, :3]).volume)


def compute_width_pca(data: np.ndarray, percentile: float = 95) -> float:
    pts = data[:, :3]
    centered = pts - pts.mean(axis=0)
    normal = pca3(centered).components_[2]
    dist = np.abs(centered @ normal)
    return float(2.0 * np.percentile(dist, percentile))


def compute_traits(data: np.ndarray, distance_percentile: float,
                   splines_smoothing_value: float) -> list:
    pcd_pca_3d, pca = run_pca(data)
    length, _, axis_pts = compute_length(pcd_pca_3d, splines_smoothing_value)
    curvature = compute_curvature(length, axis_pts)
    width = compute_width_pca(data, percentile=distance_percentile)
    try:
        volume = convex_hull_volume(data)
    except Exception as e:  # degenerate clouds (reference behaves the same)
        volume = 0
        print(f"Error estimating volume: {e}")
    inclination = compute_inclination_angle(pca)
    return [length, width, volume, inclination, curvature]
