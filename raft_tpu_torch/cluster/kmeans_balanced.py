"""Balanced k-means, the trainer for the IVF coarse quantizer and the PQ
codebooks (counterpart of raft_tpu/cluster/kmeans_balanced.py).

Each EM iteration streams the data through `assign_and_reduce`, then
re-seeds undersized clusters (count < avg / ratio) toward uniformly drawn
rows with the reference's weighted-average update (adjust_centers,
detail/kmeans_balanced.cuh:522), and ends with two plain Lloyd steps.
`_balanced_em` takes an optional leading batch axis: the PQ trainer fits
all subspaces' codebooks in one call.

`fit_hierarchical` (the two-level trainer used past 1024 clusters) is
still to be ported.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.cluster.kmeans_common import assign_and_reduce, predict_labels
from raft_tpu_torch.core.config import strict_f32_matmul
from raft_tpu_torch.core.validation import check_matrix
from raft_tpu_torch.random.rng import make_generator, sample_without_replacement

# Reference adjust_centers uses kAdjustCentersWeight = 7.0 (detail/kmeans_balanced.cuh)
_ADJUST_WEIGHT = 7.0


def _maybe_normalize(centers: torch.Tensor, metric: str) -> torch.Tensor:
    if metric in ("inner_product", "cosine"):
        n = torch.linalg.norm(centers, dim=-1, keepdim=True)
        return centers / torch.clamp(n, min=1e-12)
    return centers


def _lloyd_update(x, centers):
    _, sums, counts, _ = assign_and_reduce(x, centers)
    safe = torch.clamp(counts, min=1.0)[..., None]
    return torch.where(counts[..., None] > 0, sums / safe, centers), counts


def _balanced_em(gen: torch.Generator, x: torch.Tensor, centers0: torch.Tensor,
                 n_iters: int, metric: str = "sqeuclidean",
                 balancing_ratio: float = 4.0) -> torch.Tensor:
    """Balanced EM over x (n, d) or a batch (B, n, d) with centers0 (k, d)
    or (B, k, d); returns the trained centers, same shape as centers0."""
    x = x.float()
    n, k = x.shape[-2], centers0.shape[-2]
    threshold = n / k / balancing_ratio
    centers = centers0.float()
    for _ in range(int(n_iters)):
        updated, counts = _lloyd_update(x, centers)
        props = torch.randint(0, n, counts.shape, generator=gen, device=x.device)
        if x.ndim == 3:
            proposals = torch.gather(x, 1, props[..., None].expand(-1, -1, x.shape[2]))
        else:
            proposals = x[props]
        wc = torch.clamp(counts, max=_ADJUST_WEIGHT)[..., None]
        adjusted = (wc * updated + proposals) / (wc + 1.0)
        centers = torch.where((counts < threshold)[..., None], adjusted, updated)
        centers = _maybe_normalize(centers, metric)
    # two clean Lloyd steps, so the returned centers are the means of
    # their members (balancing_em_iters' trailing predict + calc_centers)
    for _ in range(2):
        centers, _ = _lloyd_update(x, centers)
        centers = _maybe_normalize(centers, metric)
    return centers


def fit(X, n_clusters: int, n_iters: int = 20, metric: str = "sqeuclidean",
        seed: int = 0, device=None) -> torch.Tensor:
    """Train balanced cluster centers; returns (n_clusters, dim) f32.
    k-means++ seeding up to 512 clusters, a uniform draw of distinct rows
    above (kmeans_balanced.py:fit)."""
    x = check_matrix(X, device, name="X").float()
    n = x.shape[0]
    if n_clusters > n:
        raise ValueError(f"n_clusters={n_clusters} > n_samples={n}")
    gen = make_generator(seed, x.device)
    if n_clusters <= 512:
        from raft_tpu_torch.cluster.kmeans import _kmeans_plusplus

        centers0 = _kmeans_plusplus(gen, x, n_clusters)
    else:
        centers0 = x[sample_without_replacement(gen, n, n_clusters)]
    centers0 = _maybe_normalize(centers0, metric)
    return _balanced_em(gen, x, centers0, int(n_iters), metric)


def predict(X, centers, metric: str = "sqeuclidean", device=None) -> torch.Tensor:
    """Nearest-center labels (int64) under the training metric
    (cluster/kmeans_balanced.cuh:133)."""
    x = check_matrix(X, device, name="X").float()
    c = torch.as_tensor(centers, device=x.device).float()
    if metric in ("inner_product", "cosine"):
        strict_f32_matmul()
        return torch.argmax(x @ _maybe_normalize(c, metric).T, dim=1)
    return predict_labels(x, c)
