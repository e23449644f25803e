"""Single-linkage hierarchical agglomerative clustering (counterpart of
raft_tpu/cluster/single_linkage.py; cluster/single_linkage.cuh,
detail/single_linkage.cuh:52-111).

The k-NN graph (or the complete graph), the Borůvka MST and the repair
of a disconnected forest (each pass links every component to its
nearest other component by the masked cross-component 1-NN) run on the
device. The components of a forest come from the Borůvka labels,
numbered by their lowest vertex as `scipy.sparse.csgraph` numbers them,
so the repair edges come in the JAX package's order. The dendrogram is
a sequential union-find over the weight-sorted edges: host work, in the
port's C++ host library (`raft_tpu_torch.native`) with the Python loops
below as its plain twins; so is the flat cut.

`single_linkage(..., stages=d)` fills the dict `d` with each stage's
seconds (the device synchronized at each stage's end), every repair
pass's component count, the graph the first MST ran on ("graph"), each
repair pass's new edges ("repair_edges") and the final forest ("tree"),
for the measurements on the card.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from raft_tpu_torch.core.validation import check_matrix


@dataclasses.dataclass
class SingleLinkageOutput:
    """Mirrors raft::cluster::linkage_output."""

    labels: torch.Tensor      # (n,) int32 flat clustering
    children: torch.Tensor    # (n-1, 2) int32 merge tree (scipy convention)
    deltas: torch.Tensor      # (n-1,) f32 merge distances
    sizes: torch.Tensor       # (n-1,) int32 merged cluster sizes
    n_clusters: int


def _mst_linkage_plain(n: int, src, dst, w):
    """The union-find dendrogram in Python (the native routine's twin):
    weight-sorted edges -> (children (m, 2) int64, deltas float64, sizes
    int64)."""
    parent = np.arange(2 * n - 1)
    size = np.ones(2 * n - 1, np.int64)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    children = np.zeros((n - 1, 2), np.int64)
    deltas = np.zeros(n - 1, np.float64)
    sizes = np.zeros(n - 1, np.int64)
    nxt = n
    m = 0
    for a, b, ww in zip(src, dst, w):
        if m == n - 1:
            break
        ra, rb = find(a), find(b)
        if ra == rb:
            continue
        children[m] = (ra, rb)
        deltas[m] = ww
        size[nxt] = size[ra] + size[rb]
        sizes[m] = size[nxt]
        parent[ra] = parent[rb] = nxt
        nxt += 1
        m += 1
    return children[:m], deltas[:m], sizes[:m]


def _mst_linkage(n: int, edges_src, edges_dst, edges_w):
    """Dendrogram of MST edges (detail/agglomerative.cuh): a stable sort by
    weight (equal weights keep their order), then the native merge loop,
    or its Python twin when the library is unavailable."""
    from raft_tpu_torch import native

    order = np.argsort(edges_w, kind="stable")
    src, dst, w = edges_src[order], edges_dst[order], edges_w[order]
    packed = native.mst_linkage(src, dst, w, n)
    if packed is not None:
        return packed
    return _mst_linkage_plain(n, src, dst, w)


def _cut_tree_plain(n: int, children, n_clusters: int) -> np.ndarray:
    """Flat labels from the first n - n_clusters merges, in Python."""
    parent = np.arange(2 * n - 1)

    def find(x):
        root = x
        while parent[root] != root:
            root = parent[root]
        while parent[x] != root:
            parent[x], x = root, parent[x]
        return root

    keep = max(0, len(children) - (n_clusters - 1))
    for m in range(keep):
        a, b = children[m]
        nxt = n + m
        parent[find(a)] = nxt
        parent[find(b)] = nxt
    roots = np.array([find(i) for i in range(n)])
    _, labels = np.unique(roots, return_inverse=True)
    return labels.astype(np.int32)


def _cut_tree(n: int, children, n_clusters: int) -> np.ndarray:
    from raft_tpu_torch import native

    labels = native.cut_tree(np.asarray(children), n, n_clusters)
    if labels is not None:
        return labels
    return _cut_tree_plain(n, children, n_clusters)


def _forest_components(comp: torch.Tensor) -> torch.Tensor:
    """Component labels 0..C-1 numbered by each component's lowest vertex
    (`scipy.sparse.csgraph.connected_components`' numbering) from any
    labelling of the vertices by component."""
    n = comp.shape[0]
    low = torch.full((n,), n, dtype=torch.int64, device=comp.device)
    low.scatter_reduce_(0, comp.long(), torch.arange(n, device=comp.device), "amin",
                        include_self=True)
    return torch.unique(low[comp.long()], sorted=True, return_inverse=True)[1]


class _Stages:
    def __init__(self, out: Optional[dict], dev: torch.device):
        self.out, self.dev = out, dev
        self.t = time.perf_counter()

    def mark(self, name: str, **extra) -> None:
        if self.out is None:
            return
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        now = time.perf_counter()
        if extra:
            self.out.setdefault(name, []).append(dict(extra, s=now - self.t))
        else:
            self.out[name] = self.out.get(name, 0.0) + now - self.t
        self.t = now


def single_linkage(X, n_clusters: int = 2, metric: str = "sqeuclidean",
                   connectivity: str = "knn", n_neighbors: int = 15, device=None,
                   stages: Optional[dict] = None) -> SingleLinkageOutput:
    """Fit single-linkage HAC; returns the flat labels and the dendrogram.

    connectivity='knn' builds a k-NN graph and repairs a disconnected
    forest (the reference's KNN_GRAPH mode, detail/connectivities.cuh);
    'pairwise' takes the complete graph (exact, O(n^2) edges)."""
    from raft_tpu_torch.sparse import neighbors as sp_neighbors
    from raft_tpu_torch.sparse.formats import CooMatrix
    from raft_tpu_torch.sparse.solver import _mst_impl

    x = check_matrix(X, device=device, name="X").float()
    n = x.shape[0]
    if n_clusters < 1 or n_clusters > n:
        raise ValueError(f"n_clusters={n_clusters} out of range")
    st = _Stages(stages, x.device)

    if connectivity == "pairwise":
        from raft_tpu_torch.distance.distance_types import resolve_metric
        from raft_tpu_torch.distance.pairwise import _pairwise_impl

        off = ~torch.eye(n, dtype=torch.bool, device=x.device)
        rows, cols = torch.nonzero(off, as_tuple=True)
        full = _pairwise_impl(x, x, resolve_metric(metric))
        coo = CooMatrix(rows.to(torch.int32), cols.to(torch.int32), full[rows, cols].float(),
                        (n, n))
        st.mark("pairwise_s")
    else:
        from raft_tpu_torch.sparse.linalg import symmetrize

        directed = sp_neighbors._directed_knn_coo(x, n_neighbors, metric)
        st.mark("knn_s")
        coo = symmetrize(directed, op="max")
        st.mark("symmetrize_s")

    if stages is not None:
        stages["graph"], stages["repair_edges"] = coo, []
    tree, comp = _mst_impl(coo)
    st.mark("mst_s")

    # repair the forest while the graph is disconnected (connect_components):
    # each pass links every component to its nearest other one, so a chain of
    # C components needs up to log2(C) passes
    passes = 0
    while tree.nnz < n - 1 and passes < 32:
        labels = _forest_components(comp)
        n_comp = int(labels.max()) + 1
        extra = sp_neighbors.connect_components(x, labels, metric=metric, device=x.device)
        coo = CooMatrix(torch.cat([tree.rows, extra.rows]), torch.cat([tree.cols, extra.cols]),
                        torch.cat([tree.vals, extra.vals]), (n, n))
        tree, comp = _mst_impl(coo)
        passes += 1
        if stages is not None:
            stages["repair_edges"].append(extra)
        st.mark("repair", components=n_comp, edges=int(extra.nnz))

    src, dst, w = tree.rows.cpu().numpy(), tree.cols.cpu().numpy(), tree.vals.cpu().numpy()
    children, deltas, sizes = _mst_linkage(n, src, dst, w)
    st.mark("dendrogram_s")
    labels = _cut_tree(n, children, n_clusters)
    st.mark("cut_s")
    if stages is not None:
        stages["tree"] = tree
    dev = x.device
    return SingleLinkageOutput(
        torch.as_tensor(labels, device=dev).to(torch.int32),
        torch.as_tensor(children, device=dev).to(torch.int32).reshape(-1, 2),
        torch.as_tensor(deltas.astype(np.float32), device=dev),
        torch.as_tensor(sizes, device=dev).to(torch.int32),
        int(labels.max()) + 1,
    )
