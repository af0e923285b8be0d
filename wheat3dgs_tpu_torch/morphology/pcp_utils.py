"""Point-cloud pre-processing (reference:
wheatheadsmorphology/point_cloud_processing_utils.py).

Counterpart of wheat3dgs_tpu/morphology/pcp_utils.py, without sklearn: the
clusterers and the k-NN distances come from `cluster.py`, whose distance
work runs on `device`. The SOR statistics run on the host in numpy/scipy,
as the JAX package computes them, so the kept mask is bit-identical.
"""

from __future__ import annotations

import numpy as np
from scipy import stats

from .cluster import dbscan_labels, hdbscan_labels, knn_distances


def subsample_pcd(data: np.ndarray, subsampling_threshold: int,
                  rng=None) -> np.ndarray:
    """At most subsampling_threshold rows, drawn without replacement from
    `rng` (a np.random.RandomState; numpy's global state when None)."""
    if data.shape[0] > subsampling_threshold:
        rng = rng or np.random
        idx = rng.choice(data.shape[0], subsampling_threshold, replace=False)
        return data[idx]
    return data


def main_cluster_extraction(data: np.ndarray, clusterer_definition: dict,
                            device="cuda") -> np.ndarray:
    """Keep only the largest DBSCAN/HDBSCAN cluster (reference :55-84),
    with sklearn 1.9.0's labels (`cluster.py`)."""
    kind = clusterer_definition["type"]
    min_samples = clusterer_definition.get("min_samples")
    if kind == "dbscan":
        labels = dbscan_labels(
            data[:, :3], eps=clusterer_definition["epsilon"],
            min_samples=min_samples, device=device)
    elif kind == "hdbscan":
        labels = hdbscan_labels(
            data[:, :3],
            min_cluster_size=clusterer_definition["min_cluster_size"],
            min_samples=min_samples,
            cluster_selection_epsilon=clusterer_definition["epsilon_hdbscan"],
            allow_single_cluster=True, device=device)
    else:
        raise ValueError(f"unknown clusterer type {kind!r}")
    unique, counts = np.unique(labels, return_counts=True)
    largest = unique[np.argmax(counts)]
    return data[labels == largest]


def statistical_outlier_removal(data: np.ndarray, k: int = 10,
                                std_ratio: float = 2.0, device="cuda"):
    """Robust (median/MAD) SOR filter (reference :11-42): drop points whose
    mean k-NN distance exceeds median + std_ratio * (MAD * 1.4826)."""
    pts = data[:, :3]
    dists = knn_distances(pts, k + 1, device=device)
    avg = dists[:, 1:].mean(axis=1)
    med = np.median(avg)
    mad = stats.median_abs_deviation(avg) * 1.4826
    mask = avg < med + std_ratio * mad
    return data[mask], data[~mask]
