"""Spectral clustering and embedding (counterpart of raft_tpu/spectral):
`partition` (spectral/partition.cuh:49: Laplacian, Lanczos eigenvectors,
k-means on the embedding), `modularity_maximization`, the `analyze_*`
quality measures, the solver wrappers (eigen_solvers.cuh
lanczos_solver_t, cluster_solvers.cuh kmeans_solver_t) and
sparse/linalg/spectral.cuh's `fit_embedding`.

Everything runs on the adjacency's device: spmv (sparse/linalg), the
Lanczos solver (sparse/solver) and the port's Lloyd k-means
(cluster/kmeans, k-means++ from a `torch.Generator`). Lanczos draws its
start vector from a generator seeded with `seed` where the JAX package
draws from a JAX key (a comparison gives both the same start vector).
`partition` takes `tol` (None: the JAX program's fixed steps), the
port's addition: Lanczos runs on until the wanted pairs' residuals are
within it (`sparse.solver.lanczos`).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from raft_tpu_torch.sparse.formats import CooMatrix, CsrMatrix, coo_to_csr, csr_to_coo
from raft_tpu_torch.sparse.linalg import laplacian_matvec, spmv
from raft_tpu_torch.sparse.solver import lanczos

__all__ = [
    "EigenSolverConfig",
    "LanczosSolver",
    "KmeansSolver",
    "fit_embedding",
    "partition",
    "modularity_maximization",
    "analyze_partition",
    "modularity",
]


@dataclasses.dataclass
class EigenSolverConfig:
    """lanczos_solver_t config (spectral/eigen_solvers.hpp)."""

    n_eigenvecs: int = 2
    ncv: Optional[int] = None
    seed: int = 0


class LanczosSolver:
    """spectral::lanczos_solver_t parity; the operator runs on `device`."""

    def __init__(self, config: EigenSolverConfig, device=None):
        self.config = config
        self.device = device

    def _solve(self, matvec, n: int, which: str):
        return lanczos(matvec, n, self.config.n_eigenvecs, which, ncv=self.config.ncv,
                       seed=self.config.seed, device=self.device)

    def solve_smallest(self, matvec, n: int):
        return self._solve(matvec, n, "smallest")

    def solve_largest(self, matvec, n: int):
        return self._solve(matvec, n, "largest")


class KmeansSolver:
    """spectral::kmeans_solver_t parity: Lloyd k-means (k-means++ seeded
    from `seed`) and the nearest-centroid labels, int32."""

    def __init__(self, n_clusters: int, max_iter: int = 100, seed: int = 0):
        self.n_clusters = n_clusters
        self.max_iter = max_iter
        self.seed = seed

    def solve(self, embedding: torch.Tensor) -> torch.Tensor:
        from raft_tpu_torch.cluster import kmeans

        centers, _, _ = kmeans.fit(embedding, n_clusters=self.n_clusters,
                                   max_iter=self.max_iter, seed=self.seed,
                                   device=embedding.device)
        return kmeans.predict(embedding, centers, device=embedding.device)


def _as_csr(adj) -> CsrMatrix:
    return coo_to_csr(adj) if isinstance(adj, CooMatrix) else adj


def _row_normalize(emb: torch.Tensor) -> torch.Tensor:
    return emb / torch.clamp(torch.linalg.vector_norm(emb, dim=1, keepdim=True), min=1e-12)


def fit_embedding(adj: CsrMatrix, n_components: int = 2, seed: int = 0,
                  normalized: bool = True) -> torch.Tensor:
    """Spectral embedding (sparse/linalg/spectral.cuh fit_embedding): the
    smallest nontrivial Laplacian eigenvectors, (n, n_components)."""
    adj = _as_csr(adj)
    mv = laplacian_matvec(adj, normalized=normalized)
    # k + 1 pairs, the trivial constant eigenvector dropped
    _, vecs = lanczos(mv, adj.shape[0], n_components + 1, "smallest", seed=seed,
                      device=adj.device)
    return vecs[:, 1:]


def partition(adj, n_clusters: int, n_eigenvecs: Optional[int] = None, seed: int = 0,
              tol: Optional[float] = None) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Spectral graph partition (spectral/partition.cuh:49): (int32
    labels, eigenvalues (k,), row-normalized embedding (n, k)). The first
    k eigenvectors, the smallest included, go to k-means, as partition.cuh
    passes all of them."""
    adj = _as_csr(adj)
    k = n_eigenvecs or n_clusters
    mv = laplacian_matvec(adj, normalized=True)
    vals, vecs = lanczos(mv, adj.shape[0], k, "smallest", seed=seed, device=adj.device, tol=tol)
    emb = _row_normalize(vecs[:, :k])
    labels = KmeansSolver(n_clusters, seed=seed).solve(emb)
    return labels, vals[:k], emb


def modularity_maximization(adj, n_clusters: int, seed: int = 0
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Cluster by the top eigenvectors of the modularity matrix
    B = A - d d^T / (2m) (spectral/modularity_maximization.cuh)."""
    adj = _as_csr(adj)
    n = adj.shape[0]
    deg = spmv(adj, torch.ones((n,), dtype=torch.float32, device=adj.device))
    two_m = torch.clamp(torch.sum(deg), min=1e-12)

    def mv(v):
        return spmv(adj, v) - deg * (torch.dot(deg, v) / two_m)

    vals, vecs = lanczos(mv, n, n_clusters, "largest", seed=seed, device=adj.device)
    emb = _row_normalize(vecs)
    labels = KmeansSolver(n_clusters, seed=seed).solve(emb)
    return labels, vals, emb


def _edges(adj: CsrMatrix, labels):
    """(rows, cols, float64 weights, labels) of a CSR's entries."""
    coo = csr_to_coo(adj)
    lab = torch.as_tensor(labels, device=coo.device).long()
    return coo.rows.long(), coo.cols.long(), coo.vals.double(), lab


def analyze_partition(adj, labels, n_clusters: int) -> Tuple[float, float]:
    """(edge_cut, cost) of a partition (partition.cuh analyzePartition):
    half the weight of the edges across parts, and the sum of squared part
    sizes."""
    r, c, v, lab = _edges(_as_csr(adj), labels)
    cut = float(v[lab[r] != lab[c]].sum()) / 2.0
    sizes = torch.bincount(lab, minlength=n_clusters).double()
    return cut, float((sizes ** 2).sum())


def _sum_by(vals: torch.Tensor, keys: torch.Tensor, n: int) -> torch.Tensor:
    """Per key sum of vals, keys 0..n-1 (sorted, then one reduction a
    segment: no float atomics)."""
    order = torch.sort(keys, stable=True).indices
    return torch.segment_reduce(vals[order], "sum", lengths=torch.bincount(keys, minlength=n))


def modularity(adj, labels) -> float:
    """Modularity Q of a labeling (analyze_modularity), in float64."""
    adj = _as_csr(adj)
    r, c, v, lab = _edges(adj, labels)
    two_m = v.sum()
    intra = v[lab[r] == lab[c]].sum()
    deg = _sum_by(v, r, adj.shape[0])
    k = _sum_by(deg, lab, int(lab.max()) + 1)
    return float(intra / two_m - ((k / two_m) ** 2).sum())
