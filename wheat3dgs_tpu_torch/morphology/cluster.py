"""HDBSCAN, DBSCAN and k-nearest-neighbour distances without sklearn.

The JAX package's morphology (`wheat3dgs_tpu/morphology/pcp_utils.py`)
calls scikit-learn's `HDBSCAN`, `DBSCAN` and `NearestNeighbors`. This module
ports the algorithms so that they give the same labels and distances as
scikit-learn 1.9.0:

- `hdbscan_labels`: `HDBSCAN(min_cluster_size, min_samples,
  cluster_selection_epsilon, allow_single_cluster)` with the default
  "eom" selection, on the kd-tree path that `algorithm="auto"` takes for
  3-D Euclidean data (`hdbscan.py::_hdbscan_prims`, `_process_mst`;
  `_linkage.pyx::mst_from_data_matrix`, `make_single_linkage`;
  `_tree.pyx::tree_to_labels`, `_condense_tree`, `_compute_stability`,
  `_get_clusters`, `epsilon_search`, `_do_labelling`);
- `dbscan_labels`: `DBSCAN(eps, min_samples)` (`_dbscan.py`,
  `_dbscan_inner.pyx`);
- `knn_distances`: the sorted distances of `kneighbors(X)` on the
  training set itself (the point is its own first neighbour).

Each takes `device` (default "cuda", as every entry of the port; "cpu" on
request).

Ported from scikit-learn (https://scikit-learn.org), which is distributed
under the BSD 3-Clause licence: Copyright (c) 2007-2024 The scikit-learn
developers. All rights reserved. Redistribution and use in source and
binary forms, with or without modification, are permitted provided that
(1) redistributions of source code retain the above copyright notice, this
list of conditions and the following disclaimer; (2) redistributions in
binary form reproduce them in the documentation; (3) neither the name of
the copyright holder nor the names of its contributors may be used to
endorse or promote products derived from this software without specific
prior written permission. THIS SOFTWARE IS PROVIDED BY THE COPYRIGHT
HOLDERS AND CONTRIBUTORS "AS IS" AND ANY EXPRESS OR IMPLIED WARRANTIES ARE
DISCLAIMED; IN NO EVENT SHALL THEY BE LIABLE FOR ANY DAMAGES ARISING IN ANY
WAY OUT OF THE USE OF THIS SOFTWARE.

Ties decide the tree, and mutual-reachability weights tie often, so every
distance is rounded as sklearn's kd-tree rounds it: float64
`sqrt((dx*dx + dy*dy) + dz*dz)`, each step a separate eager tensor op on
the caller's device (never `torch.cdist` or a matmul expansion, whose bits
differ), in row blocks so that memory stays bounded. Prim's tree, the core
and k-NN distances and DBSCAN's neighbour tests run there; the single-
linkage tree, the condensed tree, the stabilities, the epsilon search and
the labelling run on the host in numpy, as sklearn runs them.
"""

from __future__ import annotations

import numpy as np
import torch

# Rows of the (rows, n) float64 distance block: 64 MiB at n = 8192.
ROW_BLOCK = 1024

MST_EDGE_DTYPE = np.dtype([("current_node", np.int64),
                           ("next_node", np.int64),
                           ("distance", np.float64)])
HIERARCHY_DTYPE = np.dtype([("left_node", np.intp), ("right_node", np.intp),
                            ("value", np.float64),
                            ("cluster_size", np.intp)])
CONDENSED_DTYPE = np.dtype([("parent", np.intp), ("child", np.intp),
                            ("value", np.float64),
                            ("cluster_size", np.intp)])


# ---------------------------------------------------------------- distances

def _as_points(X, device) -> torch.Tensor:
    """(3, n) float64 on the device: one contiguous row per coordinate."""
    x = np.ascontiguousarray(np.asarray(X, np.float64)[:, :3].T)
    return torch.as_tensor(x, device=device)


def _sq_dist(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """(b, n) squared distances ((dx*dx + dy*dy) + dz*dz) from the points
    `rows` (3, b) to every point of x (3, n), one op per rounding step."""
    d = rows[:, :, None] - x[:, None, :]
    d = d * d
    return (d[0] + d[1]) + d[2]


def _sqrt(t: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float64 sqrt, as C's and numpy's. CUDA's float64
    sqrt is; torch's CPU kernel (SIMD, about 1 in 140 results an ulp off)
    is not, so a CPU tensor takes numpy's."""
    if t.device.type == "cpu":
        return torch.from_numpy(np.sqrt(t.numpy()))
    return torch.sqrt(t)


def _row_blocks(n: int):
    for lo in range(0, n, ROW_BLOCK):
        yield lo, min(lo + ROW_BLOCK, n)


def knn_distances(X, k: int, device="cuda") -> np.ndarray:
    """(n, k) float64: each point's k smallest distances to the points of
    X, itself included, in ascending order (sklearn's
    `NearestNeighbors(n_neighbors=k).fit(X).kneighbors(X)[0]` on its
    kd-tree path)."""
    x = _as_points(X, device)
    n = x.shape[1]
    if not 1 <= k <= n:
        raise ValueError(f"Expected n_neighbors <= n_samples_fit, but "
                         f"n_neighbors = {k}, n_samples_fit = {n}")
    out = []
    for lo, hi in _row_blocks(n):
        s = _sq_dist(x, x[:, lo:hi])
        out.append(_sqrt(torch.topk(s, k, dim=1, largest=False,
                                         sorted=True).values))
    return torch.cat(out).cpu().numpy()


def _core_distances(x: torch.Tensor, min_samples: int) -> torch.Tensor:
    """Distance to the min_samples-th neighbour, the point itself first."""
    out = []
    for lo, hi in _row_blocks(x.shape[1]):
        s = _sq_dist(x, x[:, lo:hi])
        out.append(_sqrt(torch.kthvalue(s, min_samples, dim=1).values))
    return torch.cat(out)


def _prim_mst(x: torch.Tensor, core: torch.Tensor) -> np.ndarray:
    """`mst_from_data_matrix` (alpha 1): Prim's tree of the mutual-
    reachability graph from node 0, in the order sklearn adds the edges.

    A node's reach drops only on a strict `<`; the next node is the first
    index at the least reach (sklearn's scan keeps the first on a tie), its
    source the node that last lowered that reach. A step works in place on
    device tensors and reads nothing back, so on the card it is captured
    once as a CUDA graph and replayed for every node: its ~15 small ops
    would otherwise each cost a host launch."""
    n = x.shape[1]
    dev = x.device
    # Tree nodes get an infinite core distance (so no pair with them lowers
    # a reach again) and an infinite reach (so none is picked again). A
    # node's source is final once it joins the tree.
    core_open = core.clone()
    reach = torch.full((n,), float("inf"), dtype=torch.float64, device=dev)
    source = torch.ones(n, dtype=torch.int64, device=dev)
    dst = torch.empty(n - 1, dtype=torch.int64, device=dev)
    dist = torch.empty(n - 1, dtype=torch.float64, device=dev)
    cur = torch.zeros(1, dtype=torch.int64, device=dev)
    step_no = torch.zeros(1, dtype=torch.int64, device=dev)

    def step():
        core_open.index_fill_(0, cur, float("inf"))
        reach.index_fill_(0, cur, float("inf"))
        pair = _sqrt(_sq_dist(x, x.index_select(1, cur))[0])
        mrd = torch.maximum(
            torch.maximum(core.index_select(0, cur), core_open), pair)
        torch.where(mrd < reach, cur, source, out=source)
        torch.minimum(reach, mrd, out=reach)
        val, nxt = torch.min(reach, 0)
        dist.index_copy_(0, step_no, val.view(1))
        dst.index_copy_(0, step_no, nxt.view(1))
        cur.copy_(nxt.view(1))
        step_no.add_(1)

    if dev.type == "cuda" and n > 2:
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            step()                  # the first node, and the capture's warm-up
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            step()
        for _ in range(n - 2):
            graph.replay()
    else:
        for _ in range(n - 1):
            step()
    mst = np.empty(n - 1, dtype=MST_EDGE_DTYPE)
    mst["current_node"] = source.index_select(0, dst).cpu().numpy()
    mst["next_node"] = dst.cpu().numpy()
    mst["distance"] = dist.cpu().numpy()
    return mst


# ------------------------------------------------------- single linkage tree

def _single_linkage(mst: np.ndarray) -> np.ndarray:
    """`_process_mst`: sort the edges with numpy's default argsort (as
    sklearn does, so equal weights keep sklearn's order), then merge them
    with a union-find (`make_single_linkage`)."""
    mst = mst[np.argsort(mst["distance"])]
    n = mst.shape[0] + 1
    out = np.zeros(n - 1, dtype=HIERARCHY_DTYPE)
    par = [-1] * (2 * n - 1)            # merged nodes take labels n, n+1, ...
    sz = [1] * n + [0] * (n - 1)
    next_label = n

    def find(v):
        root = v
        while par[root] != -1:
            root = par[root]
        while v != root and par[v] != root:
            par[v], v = root, par[v]
        return root

    cur = mst["current_node"].tolist()
    nxt = mst["next_node"].tolist()
    rows = []
    for i in range(n - 1):
        a, b = find(cur[i]), find(nxt[i])
        rows.append((a, b, sz[a] + sz[b]))
        par[a] = par[b] = next_label
        sz[next_label] = sz[a] + sz[b]
        next_label += 1
    if rows:
        a, b, s = zip(*rows)
        out["left_node"], out["right_node"], out["cluster_size"] = a, b, s
    out["value"] = mst["distance"]
    return out


# ------------------------------------------------------------ tree to labels

def _bfs_from_hierarchy(left, right, root: int, n: int) -> list:
    result, queue = [], [root]
    while queue:
        result.extend(queue)
        queue = [x - n for x in queue if x >= n]
        if queue:
            nq = []
            for node in queue:
                nq.extend([left[node], right[node]])
            queue = nq
    return result


def _condense_tree(hierarchy: np.ndarray, min_cluster_size: int) -> np.ndarray:
    root = 2 * hierarchy.shape[0]
    n = hierarchy.shape[0] + 1
    next_label = n + 1
    left = hierarchy["left_node"].tolist()
    right = hierarchy["right_node"].tolist()
    value = hierarchy["value"].tolist()
    csize = hierarchy["cluster_size"].tolist()
    node_list = _bfs_from_hierarchy(left, right, root, n)
    relabel = [0] * (root + 1)
    relabel[root] = n
    ignore = [False] * len(node_list)
    result = []
    for node in node_list:
        if ignore[node] or node < n:
            continue
        h = node - n
        lft, rgt, distance = left[h], right[h], value[h]
        lam = 1.0 / distance if distance > 0.0 else np.inf
        lcount = csize[lft - n] if lft >= n else 1
        rcount = csize[rgt - n] if rgt >= n else 1
        if lcount >= min_cluster_size and rcount >= min_cluster_size:
            relabel[lft] = next_label
            next_label += 1
            result.append((relabel[node], relabel[lft], lam, lcount))
            relabel[rgt] = next_label
            next_label += 1
            result.append((relabel[node], relabel[rgt], lam, rcount))
            continue
        if lcount < min_cluster_size and rcount < min_cluster_size:
            drop = (lft, rgt)
        elif lcount < min_cluster_size:
            relabel[rgt] = relabel[node]
            drop = (lft,)
        else:
            relabel[lft] = relabel[node]
            drop = (rgt,)
        for side in drop:
            for sub in _bfs_from_hierarchy(left, right, side, n):
                if sub < n:
                    result.append((relabel[node], sub, lam, 1))
                ignore[sub] = True
    return np.array(result, dtype=CONDENSED_DTYPE)


def _compute_stability(tree: np.ndarray) -> dict:
    parents = tree["parent"]
    smallest = int(parents.min())
    largest_child = max(int(tree["child"].max()), smallest)
    births = np.full(largest_child + 1, np.nan)
    births[tree["child"]] = tree["value"]
    births[smallest] = 0.0
    result = [0.0] * (int(parents.max()) - smallest + 1)
    terms = (tree["value"] - births[parents]) * tree["cluster_size"]
    # One add per row in row order, as sklearn's loop accumulates.
    for p, t in zip((parents - smallest).tolist(), terms.tolist()):
        result[p] += t
    return {i + smallest: result[i] for i in range(len(result))}


def _bfs_from_cluster_tree(tree: np.ndarray, root: int) -> list:
    result = []
    queue = np.array([root], dtype=np.intp)
    children, parents = tree["child"], tree["parent"]
    while len(queue) > 0:
        result.extend(queue.tolist())
        queue = children[np.isin(parents, queue)]
    return result


def _traverse_upwards(tree, epsilon, leaf, allow_single_cluster):
    root = tree["parent"].min()
    parent = int(tree[tree["child"] == leaf]["parent"][0])
    if parent == root:
        return parent if allow_single_cluster else int(leaf)
    parent_eps = 1 / tree[tree["child"] == parent]["value"][0]
    if parent_eps > epsilon:
        return parent
    return _traverse_upwards(tree, epsilon, parent, allow_single_cluster)


def _epsilon_search(leaves: set, tree, epsilon, allow_single_cluster) -> set:
    selected, processed = [], []
    children, distances = tree["child"], tree["value"]
    for leaf in leaves:
        eps = 1 / distances[children == leaf][0]
        if eps < epsilon:
            if leaf not in processed:
                child = _traverse_upwards(tree, epsilon, leaf,
                                          allow_single_cluster)
                selected.append(child)
                for sub in _bfs_from_cluster_tree(tree, child):
                    if sub != child:
                        processed.append(sub)
        else:
            selected.append(leaf)
    return set(selected)


class _TreeUnionFind:
    def __init__(self, size):
        self.parent = list(range(size))
        self.rank = [0] * size

    def union(self, x, y):
        xr, yr = self.find(x), self.find(y)
        if self.rank[xr] < self.rank[yr]:
            self.parent[xr] = yr
        elif self.rank[xr] > self.rank[yr]:
            self.parent[yr] = xr
        else:
            self.parent[yr] = xr
            self.rank[xr] += 1

    def find(self, x):
        root = x
        while self.parent[root] != root:
            root = self.parent[root]
        while self.parent[x] != root:
            self.parent[x], x = root, self.parent[x]
        return root


def _do_labelling(tree, clusters: set, cluster_map: dict,
                  allow_single_cluster: bool, epsilon: float) -> np.ndarray:
    child_array, parent_array = tree["child"], tree["parent"]
    lambda_array = tree["value"]
    root_cluster = int(parent_array.min())
    uf = _TreeUnionFind(int(parent_array.max()) + 1)
    for parent, child in zip(parent_array.tolist(), child_array.tolist()):
        if child not in clusters:
            uf.union(parent, child)
    single = len(clusters) == 1 and allow_single_cluster
    if single:
        point_lambda = dict(zip(child_array.tolist(), lambda_array.tolist()))
    result = np.empty(root_cluster, dtype=np.intp)
    for n in range(root_cluster):
        cluster = uf.find(n)
        label = -1
        if cluster != root_cluster:
            label = cluster_map[cluster]
        elif single:
            if epsilon != 0.0:
                threshold = 1 / epsilon
            else:
                threshold = lambda_array[parent_array == cluster].max()
            if point_lambda[n] >= threshold:
                label = cluster_map[cluster]
        result[n] = label
    return result


def _get_clusters(tree: np.ndarray, stability: dict,
                  allow_single_cluster: bool, epsilon: float) -> np.ndarray:
    """`_get_clusters` for the "eom" method and no max_cluster_size."""
    node_list = sorted(stability.keys(), reverse=True)
    if not allow_single_cluster:
        node_list = node_list[:-1]
    cluster_tree = tree[tree["cluster_size"] > 1]
    is_cluster = {c: True for c in node_list}
    for node in node_list:
        selection = cluster_tree["parent"] == node
        subtree_stability = np.sum([stability[c] for c in
                                    cluster_tree["child"][selection]])
        if subtree_stability > stability[node]:
            is_cluster[node] = False
            stability[node] = subtree_stability
        else:
            for sub in _bfs_from_cluster_tree(cluster_tree, node):
                if sub != node:
                    is_cluster[sub] = False
    if epsilon != 0.0 and cluster_tree.shape[0] > 0:
        eom = [c for c in is_cluster if is_cluster[c]]
        selected = []
        if len(eom) == 1 and eom[0] == cluster_tree["parent"].min():
            if allow_single_cluster:
                selected = eom
        else:
            selected = _epsilon_search(set(eom), cluster_tree, epsilon,
                                       allow_single_cluster)
        for c in is_cluster:
            is_cluster[c] = c in selected
    clusters = {c for c in is_cluster if is_cluster[c]}
    cluster_map = {c: n for n, c in enumerate(sorted(clusters))}
    return _do_labelling(tree, clusters, cluster_map, allow_single_cluster,
                         epsilon)


# ------------------------------------------------------------------ entries

def _check_samples(X) -> np.ndarray:
    X = np.asarray(X, np.float64)
    if X.ndim != 2:
        raise ValueError(f"Expected 2D array, got array with shape "
                         f"{X.shape}")
    if X.shape[0] < 1:
        raise ValueError(f"Found array with 0 sample(s) (shape={X.shape}) "
                         "while a minimum of 1 is required.")
    if not np.isfinite(X).all():
        raise ValueError("Input contains NaN or infinity; the port clusters "
                         "finite points only")
    return X


def _check_int(name: str, value, low: int) -> None:
    if (isinstance(value, bool) or not isinstance(value, (int, np.integer))
            or value < low):
        raise ValueError(f"The '{name}' parameter must be an int in the "
                         f"range [{low}, inf). Got {value!r} instead.")


def hdbscan_labels(X, min_cluster_size: int = 5, min_samples=None,
                   cluster_selection_epsilon: float = 0.0,
                   allow_single_cluster: bool = False,
                   device="cuda") -> np.ndarray:
    """sklearn 1.9.0's `HDBSCAN(...).fit_predict(X[:, :3])` labels
    (eom selection, Euclidean), -1 for noise."""
    _check_int("min_cluster_size", min_cluster_size, 2)
    if min_samples is not None:
        _check_int("min_samples", min_samples, 1)
    if (isinstance(cluster_selection_epsilon, bool)
            or not isinstance(cluster_selection_epsilon,
                              (int, float, np.floating, np.integer))
            or cluster_selection_epsilon < 0):
        raise ValueError("The 'cluster_selection_epsilon' parameter must be "
                         "a float in the range [0, inf). Got "
                         f"{cluster_selection_epsilon!r} instead.")
    X = _check_samples(X)
    n = X.shape[0]
    if n == 1:
        raise ValueError(
            "n_samples=1 while HDBSCAN requires more than one sample")
    ms = min_cluster_size if min_samples is None else min_samples
    if ms > n:
        raise ValueError(f"min_samples ({ms}) must be at most the number of"
                         f" samples in X ({n})")
    x = _as_points(X, device)
    mst = _prim_mst(x, _core_distances(x, ms))
    tree = _condense_tree(_single_linkage(mst), min_cluster_size)
    return _get_clusters(tree, _compute_stability(tree),
                         bool(allow_single_cluster),
                         float(cluster_selection_epsilon))


def dbscan_labels(X, eps: float = 0.5, min_samples: int = 5,
                  device="cuda") -> np.ndarray:
    """sklearn 1.9.0's `DBSCAN(eps, min_samples).fit_predict(X[:, :3])`.

    A neighbour lies within eps when its squared distance is <= eps * eps
    (the kd-tree's leaf test), the point itself included in its count. Core
    points joined by such pairs form the clusters, numbered in the order of
    their lowest index; a border point takes the lowest-numbered cluster
    among its core neighbours, the one whose expansion reaches it first in
    sklearn's index-order traversal."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import connected_components

    if (isinstance(eps, bool) or not isinstance(
            eps, (int, float, np.floating, np.integer)) or not eps > 0):
        raise ValueError("The 'eps' parameter must be a float in the range "
                         f"(0.0, inf). Got {eps!r} instead.")
    _check_int("min_samples", min_samples, 1)
    X = _check_samples(X)
    x = _as_points(X, device)
    n = x.shape[1]
    r2 = float(eps) * float(eps)
    counts = torch.cat([(_sq_dist(x, x[:, lo:hi]) <= r2).sum(1)
                        for lo, hi in _row_blocks(n)])
    core = counts >= min_samples
    core_idx = torch.nonzero(core).flatten()
    m = core_idx.shape[0]
    labels = np.full(n, -1, dtype=np.intp)
    if m == 0:
        return labels
    xc = x.index_select(1, core_idx)
    rows, cols = [], []
    for lo, hi in _row_blocks(m):
        nz = torch.nonzero(_sq_dist(xc, xc[:, lo:hi]) <= r2)
        rows.append((nz[:, 0] + lo).cpu().numpy())
        cols.append(nz[:, 1].cpu().numpy())
    rows, cols = np.concatenate(rows), np.concatenate(cols)
    graph = csr_matrix((np.ones(rows.shape[0], np.int8), (rows, cols)),
                       shape=(m, m))
    _, comp = connected_components(graph, directed=False)
    # Number the components by their lowest core index (core_idx ascends).
    first = np.full(comp.max() + 1, m)
    np.minimum.at(first, comp, np.arange(m))
    rank = np.empty_like(first)
    rank[np.argsort(first)] = np.arange(first.shape[0])
    core_label = rank[comp]
    core_np = core_idx.cpu().numpy()
    labels[core_np] = core_label
    # Border points: the least label among core neighbours within eps.
    border = torch.nonzero(~core).flatten()
    lab = torch.as_tensor(core_label, dtype=torch.int64, device=x.device)
    for lo, hi in _row_blocks(border.shape[0]):
        rows_x = x.index_select(1, border[lo:hi])
        near = _sq_dist(xc, rows_x) <= r2
        best = torch.where(near, lab[None, :],
                           torch.full_like(near, n, dtype=torch.int64))
        best = best.min(1).values
        hit = best < n
        idx = border[lo:hi][hit].cpu().numpy()
        labels[idx] = best[hit].cpu().numpy()
    return labels
