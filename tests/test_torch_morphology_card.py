"""The port's clusterers on the card against the same code on the CPU.

Marked `gpu`; each test skips itself when no CUDA device is present. This
file imports neither jax, the JAX package nor sklearn, so it also runs on
a machine that has only the port's dependencies:

    python -m pytest --noconftest -q tests/test_torch_morphology_card.py

On the card, HDBSCAN's Prim step is captured as a CUDA graph and replayed
for every point, and every distance is a float64 op whose rounding must be
the CPU's (the CPU tests hold the CPU path to sklearn bit for bit): the
single-linkage tree, the HDBSCAN and DBSCAN labels and the k-NN distances
are equal exactly.
"""

import numpy as np
import pytest
import torch

from wheat3dgs_tpu_torch.morphology import cluster as C


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _cloud(seed, n, dup=0):
    """Blobs of unequal size and spread plus uniform noise; `dup` points
    repeated (tied weights)."""
    rng = np.random.default_rng(seed)
    parts = [rng.uniform(-0.15, 0.15, 3)
             + rng.uniform(0.004, 0.03) * rng.standard_normal((m, 3))
             for m in (n // 2, n // 4, n // 8)]
    parts.append(rng.uniform(-0.2, 0.2, (n - sum(len(p) for p in parts), 3)))
    x = np.concatenate(parts)
    return np.concatenate([x, x[:dup]])


@pytest.mark.gpu
@pytest.mark.parametrize("n,dup", [(3000, 0), (1500, 400), (2, 0), (3, 1)])
def test_single_linkage_tree_equal_on_card(n, dup):
    dev = _card()
    x = _cloud(n, n, dup)
    ms = min(15, len(x))
    trees = []
    for d in (dev, "cpu"):
        pts = C._as_points(x, d)
        trees.append(C._single_linkage(C._prim_mst(
            pts, C._core_distances(pts, ms))))
    for f in ("left_node", "right_node", "value", "cluster_size"):
        np.testing.assert_array_equal(trees[0][f], trees[1][f], f)


@pytest.mark.gpu
@pytest.mark.parametrize("mcs,ms,eps", [(50, 5, 0.0), (250, 15, 0.015)])
def test_hdbscan_and_dbscan_labels_equal_on_card(mcs, ms, eps):
    dev = _card()
    x = _cloud(7, 2500, 300)
    got = C.hdbscan_labels(x, mcs, ms, eps, True, device=dev)
    np.testing.assert_array_equal(
        got, C.hdbscan_labels(x, mcs, ms, eps, True, device="cpu"))
    assert len(np.unique(got)) > 1
    np.testing.assert_array_equal(C.dbscan_labels(x, 0.01, 10, device=dev),
                                  C.dbscan_labels(x, 0.01, 10, device="cpu"))
    np.testing.assert_array_equal(C.knn_distances(x, 201, device=dev),
                                  C.knn_distances(x, 201, device="cpu"))
