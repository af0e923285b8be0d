"""The port's clusterers (wheat3dgs_tpu_torch.morphology.cluster, no
sklearn) against sklearn 1.9.0, which the JAX package's morphology calls.

- HDBSCAN and DBSCAN labels equal sklearn's exactly, directly and through
  JAX's main_cluster_extraction: on the three data_example heads, on
  seeded clouds of 2-4 Gaussian blobs of unequal size and density plus
  uniform noise (1500-3000 points) over min_cluster_size {50, 250} x
  min_samples {5, 15} x epsilon {0, 0.015}, and on a cloud with duplicated
  points (tied mutual-reachability weights); the single-linkage tree and
  the k-NN distances bit for bit.
- The errors sklearn raises (min_samples > n, one sample, bad parameters).
The rest of the morphology: tests/test_torch_morphology_pipeline.py.
"""

import os
import warnings

import numpy as np
import pytest
import torch
from sklearn.cluster import DBSCAN, HDBSCAN
from sklearn.neighbors import NearestNeighbors

from wheat3dgs_tpu.io.ply import read_ply
from wheat3dgs_tpu.morphology import pcp_utils as JP
from wheat3dgs_tpu_torch.morphology import cluster as TCl
from wheat3dgs_tpu_torch.morphology import pcp_utils as TP

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLE = os.path.join(ROOT, "wheatheadsmorphology", "data_example")
REF_CLUSTER = {"type": "hdbscan", "min_samples": 15, "min_cluster_size": 250,
               "epsilon_hdbscan": 0.015}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the clusterers' device loop runs small ops,
    where torch's thread pool only adds barrier waits."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _example(i: int) -> np.ndarray:
    v = read_ply(os.path.join(EXAMPLE, f"000{i}.ply"))
    return np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)


def _blobs(seed: int, n: int) -> np.ndarray:
    """2-4 Gaussian blobs of unequal size and spread at a head's scale,
    plus 15% uniform noise, shuffled."""
    rng = np.random.default_rng(seed)
    k = int(rng.integers(2, 5))
    sizes = rng.dirichlet(np.ones(k)) * n * 0.85
    parts = [rng.uniform(-0.15, 0.15, 3)
             + rng.uniform(0.004, 0.03) * rng.standard_normal(
                 (max(int(s), 10), 3)) for s in sizes]
    parts.append(rng.uniform(-0.2, 0.2, (int(n * 0.15), 3)))
    x = np.concatenate(parts)
    return x[rng.permutation(len(x))]


def _ties() -> np.ndarray:
    x = _blobs(7, 1500)
    return np.concatenate([x, x[:300], x[:100], x[:50]])


CLOUDS = {"blobs1500": lambda: _blobs(1, 1500),
          "blobs2200": lambda: _blobs(2, 2200),
          "blobs3000": lambda: _blobs(3, 3000)}


def _sk_hdbscan(x, mcs, ms, eps):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        return HDBSCAN(min_cluster_size=mcs, min_samples=ms,
                       allow_single_cluster=True,
                       cluster_selection_epsilon=eps).fit_predict(x)


@pytest.mark.parametrize("eps", [0.0, 0.015])
@pytest.mark.parametrize("ms", [5, 15])
@pytest.mark.parametrize("mcs", [50, 250])
@pytest.mark.parametrize("cloud", sorted(CLOUDS))
def test_hdbscan_labels_equal_sklearn(cloud, mcs, ms, eps):
    x = CLOUDS[cloud]()
    want = _sk_hdbscan(x, mcs, ms, eps)
    got = TCl.hdbscan_labels(x, mcs, ms, eps, allow_single_cluster=True,
                             device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mcs,ms,eps", [(50, 5, 0.0), (250, 15, 0.015)])
def test_hdbscan_labels_equal_sklearn_with_ties(mcs, ms, eps):
    x = _ties()
    want = _sk_hdbscan(x, mcs, ms, eps)
    assert len(np.unique(want)) > 1
    got = TCl.hdbscan_labels(x, mcs, ms, eps, allow_single_cluster=True,
                             device="cpu")
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("head", [1, 2, 3])
def test_main_cluster_extraction_matches_jax_on_examples(head):
    x = _example(head)
    want = _sk_hdbscan(x, 250, 15, 0.015)
    got = TCl.hdbscan_labels(x, 250, 15, 0.015, allow_single_cluster=True,
                             device="cpu")
    np.testing.assert_array_equal(got, want)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        jk = JP.main_cluster_extraction(x, REF_CLUSTER)
    np.testing.assert_array_equal(
        TP.main_cluster_extraction(x, REF_CLUSTER, device="cpu"), jk)


@pytest.mark.parametrize("eps", [0.01, 0.03])
@pytest.mark.parametrize("cloud", ["blobs1500", "blobs3000", "ties"])
def test_dbscan_labels_equal_sklearn(cloud, eps):
    x = _ties() if cloud == "ties" else CLOUDS[cloud]()
    want = DBSCAN(eps=eps, min_samples=10).fit_predict(x)
    assert len(np.unique(want)) > 2          # clusters and noise
    np.testing.assert_array_equal(TCl.dbscan_labels(x, eps, 10, "cpu"), want)
    cd = {"type": "dbscan", "epsilon": eps, "min_samples": 10}
    np.testing.assert_array_equal(
        TP.main_cluster_extraction(x, cd, device="cpu"),
        JP.main_cluster_extraction(x, cd))


def test_cluster_errors_match_sklearn():
    x = _blobs(1, 1500)[:10]
    with pytest.raises(ValueError) as sk:
        HDBSCAN(min_cluster_size=5, min_samples=11, copy=False).fit(x)
    with pytest.raises(ValueError) as port:
        TCl.hdbscan_labels(x, 5, 11, device="cpu")
    assert str(port.value) == str(sk.value)
    with pytest.raises(ValueError, match="more than one sample"):
        HDBSCAN(copy=False).fit(x[:1])
    with pytest.raises(ValueError, match="more than one sample"):
        TCl.hdbscan_labels(x[:1], 5, 1, device="cpu")
    for bad in (dict(min_cluster_size=1), dict(min_samples=0),
                dict(cluster_selection_epsilon=-1.0)):
        kw = dict(min_cluster_size=5, min_samples=3) | bad
        with pytest.raises(ValueError):
            HDBSCAN(copy=False, **kw).fit(x)
        with pytest.raises(ValueError):
            TCl.hdbscan_labels(x, **kw, device="cpu")
    with pytest.raises(ValueError):
        TCl.dbscan_labels(x, eps=0.0, device="cpu")
    with pytest.raises(ValueError):
        TCl.knn_distances(x, 11, device="cpu")


@pytest.mark.parametrize("cloud", ["blobs3000", "ties"])
def test_single_linkage_tree_and_knn_equal_sklearn(cloud):
    """Bit for bit: the tree's merge order, weights and sizes (so every
    float64 distance and Prim's order agree), and the k-NN distances."""
    x = _ties() if cloud == "ties" else CLOUDS[cloud]()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", FutureWarning)
        want = HDBSCAN(min_cluster_size=50, min_samples=15).fit(x)
    pts = TCl._as_points(x, "cpu")
    got = TCl._single_linkage(TCl._prim_mst(
        pts, TCl._core_distances(pts, 15)))
    for f in ("left_node", "right_node", "value", "cluster_size"):
        np.testing.assert_array_equal(got[f],
                                      want._single_linkage_tree_[f], f)
    np.testing.assert_array_equal(
        TCl.knn_distances(x, 21, device="cpu"),
        NearestNeighbors(n_neighbors=21).fit(x).kneighbors(x)[0])
