"""Balanced k-means, the trainer for the IVF coarse quantizer and the PQ
codebooks (counterpart of raft_tpu/cluster/kmeans_balanced.py).

Each EM iteration streams the data through `assign_and_reduce`, then
re-seeds undersized clusters (count < avg / ratio) toward uniformly drawn
rows with the reference's weighted-average update (adjust_centers,
detail/kmeans_balanced.cuh:522), and ends with two plain Lloyd steps.
`_balanced_em` takes an optional leading batch axis: the PQ trainers fit
all subspaces' (or all lists') codebooks in one call, and
`fit_hierarchical` trains every mesocluster's fine clusters in one call
over padded partitions (weights 0 on the padding, `valid_n` real rows
leading each partition).

`fit_hierarchical` is the two-level trainer the IVF builds use past 1024
lists (detail/kmeans_balanced.cuh:756-790): mesoclusters, then fine
clusters inside each mesocluster's partition.
"""

from __future__ import annotations

import math

import torch

from raft_tpu_torch.cluster.kmeans_common import assign_and_reduce, predict_labels
from raft_tpu_torch.core.config import strict_f32_matmul
from raft_tpu_torch.core.resources import accepts_resources
from raft_tpu_torch.core.validation import check_matrix
from raft_tpu_torch.random.rng import make_generator, sample_without_replacement

# Reference adjust_centers uses kAdjustCentersWeight = 7.0 (detail/kmeans_balanced.cuh)
_ADJUST_WEIGHT = 7.0


def _maybe_normalize(centers: torch.Tensor, metric: str) -> torch.Tensor:
    if metric in ("inner_product", "cosine"):
        n = torch.linalg.norm(centers, dim=-1, keepdim=True)
        return centers / torch.clamp(n, min=1e-12)
    return centers


def _lloyd_update(x, centers, weights=None):
    _, sums, counts, _ = assign_and_reduce(x, centers, weights)
    safe = torch.clamp(counts, min=1.0)[..., None]
    return torch.where(counts[..., None] > 0, sums / safe, centers), counts


def _balanced_em(gen: torch.Generator, x: torch.Tensor, centers0: torch.Tensor,
                 n_iters: int, metric: str = "sqeuclidean",
                 balancing_ratio: float = 4.0, weights=None, valid_n=None) -> torch.Tensor:
    """Balanced EM over x (n, d) or a batch (B, n, d) with centers0 (k, d)
    or (B, k, d); returns the trained centers, same shape as centers0.

    Padded inputs: `weights` (n,) or (B, n) is 0 on padding rows, and
    `valid_n` (an int or a (B,) tensor) counts the real rows, which lead
    each batch entry; the balancing threshold and the re-seeding
    proposals then use the real rows only."""
    x = x.float()
    n, k = x.shape[-2], centers0.shape[-2]
    if valid_n is None:
        threshold, nv_i = n / k / balancing_ratio, None
    else:
        nv = torch.as_tensor(valid_n, device=x.device).float().expand(centers0.shape[:-2])
        threshold = (nv / k / balancing_ratio)[..., None]
        nv_i = torch.clamp(nv.long(), min=1)[..., None]
    centers = centers0.float()
    for _ in range(int(n_iters)):
        updated, counts = _lloyd_update(x, centers, weights)
        if nv_i is None:
            props = torch.randint(0, n, counts.shape, generator=gen, device=x.device)
        else:  # each batch entry's proposals among its own real rows
            props = torch.randint(0, 1 << 30, counts.shape, generator=gen,
                                  device=x.device) % nv_i
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
        centers, _ = _lloyd_update(x, centers, weights)
        centers = _maybe_normalize(centers, metric)
    return centers


@accepts_resources
def fit(X, n_clusters: int, n_iters: int = 20, metric: str = "sqeuclidean",
        seed: int = 0, max_train_points=None, resources=None, train_precision=None,
        device=None) -> torch.Tensor:
    """Train balanced cluster centers; returns (n_clusters, dim) f32.
    k-means++ seeding up to 512 clusters, a uniform draw of distinct rows
    above (kmeans_balanced.py:fit). With `max_train_points`, a larger
    dataset trains on that many rows drawn without replacement.
    `train_precision` (the JAX package's MXU precision of the assignment
    matmul) is accepted and ignored, as `KMeansParams.precision` is: the
    port trains in f32 with TF32 off."""
    x = check_matrix(X, device=device, name="X").float()
    n = x.shape[0]
    if n_clusters > n:
        raise ValueError(f"n_clusters={n_clusters} > n_samples={n}")
    gen = make_generator(seed, x.device)
    if max_train_points is not None and n > max_train_points:
        x = x[sample_without_replacement(gen, n, int(max_train_points))]
        n = int(max_train_points)
    if n_clusters <= 512:
        from raft_tpu_torch.cluster.kmeans import _kmeans_plusplus

        centers0 = _kmeans_plusplus(gen, x, n_clusters)
    else:
        centers0 = x[sample_without_replacement(gen, n, n_clusters)]
    centers0 = _maybe_normalize(centers0, metric)
    return _balanced_em(gen, x, centers0, int(n_iters), metric)


def _predict_long(X, centers, metric: str = "sqeuclidean", device=None) -> torch.Tensor:
    """`predict`'s labels as int64, the index type the builds gather with."""
    x = check_matrix(X, device=device, name="X").float()
    c = torch.as_tensor(centers, device=x.device).float()
    if metric in ("inner_product", "cosine"):
        strict_f32_matmul()
        return torch.argmax(x @ _maybe_normalize(c, metric).T, dim=1)
    return predict_labels(x, c).long()


@accepts_resources
def predict(X, centers, metric: str = "sqeuclidean", resources=None, device=None
            ) -> torch.Tensor:
    """Nearest-center labels (int32, as the JAX package returns them)
    under the training metric (cluster/kmeans_balanced.cuh:133)."""
    return _predict_long(X, centers, metric=metric, device=device).to(torch.int32)


def fit_predict(X, n_clusters: int, n_iters: int = 20, metric: str = "sqeuclidean",
                seed: int = 0, device=None):
    """(centers, labels) of a `fit` on X and its `predict`."""
    x = check_matrix(X, device=device, name="X").float()
    centers = fit(x, n_clusters, n_iters=n_iters, metric=metric, seed=seed, device=x.device)
    return centers, predict(x, centers, metric=metric, device=x.device)


def _fit_partitions(gen: torch.Generator, parts: torch.Tensor, weights: torch.Tensor,
                    valid_ns: torch.Tensor, fine_k: int, n_iters: int,
                    metric: str) -> torch.Tensor:
    """fine_k clusters inside every partition, in one batched EM over
    (B, max_size, d) padded partitions (the JAX package vmaps the EM);
    each partition starts from fine_k rows drawn uniformly from its real
    rows (with replacement)."""
    b = parts.shape[0]
    nv = torch.clamp(valid_ns.long(), min=1)[:, None]
    init_idx = torch.randint(0, 1 << 30, (b, fine_k), generator=gen, device=parts.device) % nv
    inits = torch.gather(parts, 1, init_idx[..., None].expand(-1, -1, parts.shape[2]))
    return _balanced_em(gen, parts, inits, n_iters, metric, weights=weights, valid_n=valid_ns)


#: rows of gathered partitions one batched EM call holds (x 4 bytes)
PARTITION_BATCH_ELEMS = 1 << 27


def fit_hierarchical(X, n_clusters: int, n_iters: int = 20, metric: str = "sqeuclidean",
                     seed: int = 0, max_partition_rows: int = 1 << 17,
                     device=None) -> torch.Tensor:
    """Two-level trainer for large n_clusters
    (detail/kmeans_balanced.cuh:756-790, kmeans_balanced.py:fit_hierarchical).

    Trains k_meso = int(sqrt(k)) mesoclusters, packs the rows of each
    into a padded partition, then trains fine_k = ceil(k / k_meso) fine
    clusters inside every partition with one batched EM per batch of
    partitions (at most PARTITION_BATCH_ELEMS gathered values a batch).
    A partition larger than `max_partition_rows` (or 4 * fine_k) trains
    on a uniform sample of its rows. An empty partition's fine centers
    are its mesocenter. The k_meso * fine_k - k surplus centers with the
    fewest members on the data are dropped, so any n_clusters works.
    Returns (n_clusters, dim) f32."""
    from raft_tpu_torch.neighbors.ivf_flat import _pack_lists

    x = check_matrix(X, device=device, name="X").float()
    dev = x.device
    n, d = x.shape
    if n_clusters <= 64:
        return fit(x, n_clusters, n_iters=n_iters, metric=metric, seed=seed, device=dev)
    k_meso = max(2, int(math.sqrt(n_clusters)))
    fine_k = -(-n_clusters // k_meso)

    meso_centers = fit(x, k_meso, n_iters=n_iters, metric=metric, seed=seed, device=dev)
    meso_labels = _predict_long(x, meso_centers, metric=metric, device=dev)
    slots, sizes = _pack_lists(meso_labels, k_meso, group=8)
    gen = make_generator(seed + 1, dev)
    max_sz = min(slots.shape[1], max(max_partition_rows, 4 * fine_k))
    if max_sz < slots.shape[1]:
        # a uniform sample of each oversized partition: its real slots in
        # random order first, padding last
        keys = torch.rand(slots.shape, generator=gen, device=dev) + (slots < 0) * 2.0
        order = torch.argsort(keys, dim=1, stable=True)[:, :max_sz]
        slots = torch.gather(slots, 1, order)
    valid_ns = torch.clamp(sizes.long(), max=max_sz)

    pb = max(1, min(k_meso, PARTITION_BATCH_ELEMS // max(1, max_sz * d)))
    out = []
    for lo in range(0, k_meso, pb):
        sl = slots[lo:lo + pb]
        parts = x[torch.clamp(sl, min=0).long()]  # (b, max_sz, d)
        out.append(_fit_partitions(gen, parts, (sl >= 0).float(), valid_ns[lo:lo + pb],
                                   fine_k, n_iters, metric))
    centers = torch.cat(out)  # (k_meso, fine_k, d)
    bad = (valid_ns < 1)[:, None, None]
    centers = torch.where(bad, meso_centers[:, None, :], centers).reshape(k_meso * fine_k, d)
    surplus = k_meso * fine_k - n_clusters
    if surplus:
        counts = torch.bincount(_predict_long(x, centers, metric=metric, device=dev),
                                minlength=k_meso * fine_k)
        keep = torch.sort(torch.argsort(counts, stable=True)[surplus:]).values
        centers = centers[keep]
    return centers
