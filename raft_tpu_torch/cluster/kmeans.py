"""k-means (Lloyd) clustering, pylibraft's public `kmeans` (counterpart
of raft_tpu/cluster/kmeans.py).

Reference parity: `raft::cluster::kmeans` fit/predict/fit_predict/
transform/cluster_cost/find_k (cluster/kmeans.cuh), k-means++ seeding
(detail/kmeans.cuh:88), the Lloyd loop (detail/kmeans.cuh:359-548) and
`KMeansParams` (cluster/kmeans_types.hpp).

Each Lloyd iteration streams the data once through
`kmeans_common.assign_and_reduce` (distance tiles, argmin, one-hot
centroid sums) and stops when sqrt(sum ||delta c||^2) < tol or after
max_iter iterations. The JAX package keeps the stop test on the device
inside one compiled loop; here the host reads the shift once an
iteration.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.cluster.kmeans_common import (
    assign_and_reduce,
    cluster_cost_impl,
    predict_labels,
)
from raft_tpu_torch.core.config import auto_convert_output
from raft_tpu_torch.core.resources import accepts_resources
from raft_tpu_torch.core.validation import as_tensor, check_matrix
from raft_tpu_torch.random.rng import make_generator, sample_without_replacement


@dataclasses.dataclass
class KMeansParams:
    """Mirrors raft::cluster::KMeansParams (cluster/kmeans_types.hpp).

    `precision` is the JAX package's MXU precision of the assignment
    matmul. It is kept so that calls have the same shape and is ignored:
    the port's assignment is a float32 matmul with TF32 off
    (`core.config.strict_f32_matmul`)."""

    n_clusters: int = 8
    max_iter: int = 300
    tol: float = 1e-4
    init: str = "k-means++"  # "k-means++" | "random" | "array"
    n_init: int = 1
    seed: int = 0
    oversampling_factor: float = 2.0
    inertia_check: bool = True
    metric: str = "sqeuclidean"
    precision: object = None


def _kmeans_plusplus(gen: torch.Generator, x: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """k-means++ seeding (detail/kmeans.cuh:88 kmeansPlusPlus): each next
    center is a row drawn with probability proportional to its squared
    distance to the nearest center chosen so far."""
    n, d = x.shape
    xf = x.float()
    centers = torch.empty((n_clusters, d), dtype=torch.float32, device=x.device)
    first = int(torch.randint(0, n, (1,), generator=gen, device=x.device))
    centers[0] = xf[first]
    mind = torch.sum((xf - xf[first]) ** 2, dim=1)
    for i in range(1, n_clusters):
        total = torch.sum(mind)
        probs = mind / torch.clamp(total, min=1e-30)
        if float(total) <= 0.0:  # every row sits on a center: draw uniformly
            probs = torch.ones_like(mind)
        nxt = torch.multinomial(probs, 1, generator=gen)
        c = xf[nxt[0]]
        centers[i] = c
        mind = torch.minimum(mind, torch.sum((xf - c) ** 2, dim=1))
    return centers


def _random_init(gen: torch.Generator, x: torch.Tensor, n_clusters: int) -> torch.Tensor:
    """n_clusters distinct rows drawn uniformly."""
    return x[sample_without_replacement(gen, x.shape[0], n_clusters)].float()


def _update(sums: torch.Tensor, counts: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """The means of the members; a center without members stays."""
    safe = torch.clamp(counts, min=1.0)[:, None]
    return torch.where(counts[:, None] > 0, sums / safe, centers)


def _lloyd(x: torch.Tensor, centers0: torch.Tensor, weights: Optional[torch.Tensor],
           max_iter: int, tol: float):
    """(centers, inertia, n_iter). Stops when sqrt(sum ||delta c||^2) < tol
    (detail/kmeans.cuh:494-505); the inertia is that of the last
    iteration's assignment."""
    centers = centers0.float()
    inertia = torch.tensor(float("inf"), device=x.device)
    n_iter, shift = 0, float("inf")
    tol2 = float(np.float32(tol) * np.float32(tol))  # compared in f32, as the reference
    while n_iter < max_iter and shift >= tol2:
        _, sums, counts, inertia = assign_and_reduce(x, centers, weights)
        new_centers = _update(sums, counts, centers)
        shift = float(torch.sum((new_centers - centers) ** 2))
        centers = new_centers
        n_iter += 1
    return centers, inertia, n_iter


@auto_convert_output
@accepts_resources
def fit(X, params: Optional[KMeansParams] = None, sample_weights=None, centroids=None,
        resources=None, device=None, **kwargs) -> Tuple[torch.Tensor, float, int]:
    """Fit k-means; returns (centroids (k, d) f32, inertia, n_iter)
    (pylibraft cluster/kmeans.pyx:54). Extra keyword arguments build a
    KMeansParams (fit(X, n_clusters=8)). `init`: "k-means++", "random",
    or "array" (or `centroids` given) to start from `centroids`; the best
    of `n_init` trials by inertia is returned."""
    if params is None:
        params = KMeansParams(**kwargs)
    x = check_matrix(X, device=device, name="X").float()
    w = None if sample_weights is None else as_tensor(sample_weights, x.device).float()
    gen = make_generator(params.seed, x.device)
    best = None
    for _ in range(max(1, params.n_init)):
        if centroids is not None or params.init == "array":
            if centroids is None:
                raise ValueError("init='array' requires centroids")
            c0 = as_tensor(centroids, x.device).float()
        elif params.init == "random":
            c0 = _random_init(gen, x, params.n_clusters)
        else:
            c0 = _kmeans_plusplus(gen, x, params.n_clusters)
        trial = _lloyd(x, c0, w, int(params.max_iter), float(params.tol))
        if best is None or float(trial[1]) < float(best[1]):
            best = trial
    centers, inertia, n_iter = best
    return centers, float(inertia), int(n_iter)


@auto_convert_output
@accepts_resources
def predict(X, centroids, resources=None, device=None) -> torch.Tensor:
    """Nearest-centroid labels, int32 (cluster/kmeans.cuh:151)."""
    x = check_matrix(X, device=device, name="X").float()
    return predict_labels(x, as_tensor(centroids, x.device).float()).to(torch.int32)


@auto_convert_output
@accepts_resources
def fit_predict(X, params: Optional[KMeansParams] = None, resources=None, device=None,
                **kwargs):
    """(labels, centroids, inertia, n_iter) of a `fit` and its `predict`."""
    x = check_matrix(X, device=device, name="X").float()
    centers, inertia, n_iter = fit(x, params, device=x.device, **kwargs)
    return predict(x, centers, device=x.device), centers, inertia, n_iter


@auto_convert_output
def transform(X, centroids, device=None) -> torch.Tensor:
    """Squared L2 distances of every row to every centroid
    (cluster/kmeans.cuh:306)."""
    from raft_tpu_torch.distance.pairwise import pairwise_distance

    x = check_matrix(X, device=device, name="X")
    return pairwise_distance(x, as_tensor(centroids, x.device), metric="sqeuclidean",
                             device=x.device)


@accepts_resources
def cluster_cost(X, centroids, resources=None, device=None) -> float:
    """Total inertia against the given centroids (pylibraft cluster_cost,
    kmeans.pyx:289)."""
    x = check_matrix(X, device=device, name="X").float()
    return float(cluster_cost_impl(x, as_tensor(centroids, x.device).float()))


def compute_new_centroids(X, centroids, labels=None, sample_weights=None,
                          device=None) -> torch.Tensor:
    """One centroid update (pylibraft compute_new_centroids, kmeans.pyx:382):
    each centroid moves to the (weighted) mean of the rows nearest to it.
    `labels` is accepted and unused, as in the JAX package: the rows are
    assigned afresh."""
    x = check_matrix(X, device=device, name="X").float()
    c = as_tensor(centroids, x.device).float()
    w = None if sample_weights is None else as_tensor(sample_weights, x.device).float()
    _, sums, counts, _ = assign_and_reduce(x, c, w)
    return _update(sums, counts, c)


def find_k(X, kmax: int = 20, kmin: int = 1, max_iter: int = 100, tol: float = 1e-2,
           seed: int = 0, device=None) -> Tuple[int, float, int]:
    """Pick k by a binary search on the inertia elbow
    (detail/kmeans_auto_find_k.cuh:231); returns (best_k, inertia, n_iter)."""
    x = check_matrix(X, device=device, name="X").float()

    def cost_of(k: int):
        _, inertia, n_iter = fit(x, KMeansParams(n_clusters=k, max_iter=max_iter, seed=seed),
                                 device=x.device)
        return inertia, n_iter

    lo, hi = kmin, max(kmin, kmax)
    costs = {k: cost_of(k) for k in sorted({lo, (lo + hi) // 2, hi})}
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if mid not in costs:
            costs[mid] = cost_of(mid)
        c_lo, c_mid, c_hi = costs[lo][0], costs[mid][0], costs[hi][0]
        denom = max(c_lo - c_hi, 1e-30)
        # most of the drop before mid: the elbow lies left of it
        if (c_lo - c_mid) / denom > 1.0 - tol:
            hi = mid
        else:
            lo = mid
    inertia, n_iter = costs[hi] if hi in costs else cost_of(hi)
    return hi, float(inertia), int(n_iter)
