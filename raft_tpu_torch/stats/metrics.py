"""Evaluation metrics (counterpart of raft_tpu/stats/metrics.py;
stats/accuracy.cuh, r2_score.cuh, regression_metrics.cuh,
contingency_matrix.cuh, adjusted_rand_index.cuh, rand_index.cuh,
mutual_info_score.cuh, homogeneity_score.cuh, completeness_score.cuh,
v_measure.cuh, entropy.cuh, kl_divergence.cuh, silhouette_score.cuh,
trustworthiness_score.cuh, information_criterion.cuh).

Scores come back as 0-d float32 tensors, computed as the JAX package
computes them. Two are blocked by rows where the JAX package works on
whole matrices, with the same answer:
  - `silhouette_score` streams (batch, n) distance blocks times the
    one-hot labels (full float32, TF32 off, through
    `distance.pairwise._dot`);
  - `trustworthiness_score` needs, of the JAX (n, n) rank table, only
    the ranks of each row's embedded neighbours: a rank is the count of
    the row's distances before it in `select_k`'s order (the total order
    of the float bits, ties to the smaller id), counted per block of
    rows by `BLOCK_BUDGET_BYTES`. The embedded neighbours are
    `brute_force._bf_knn_impl` (kernel 6 on the card under the tuned
    table) in the UNEXPANDED squared L2 (kernel 8 on the card), where the
    JAX package takes the expanded form: an embedding's coordinates are
    large beside its nearest-neighbour gaps (a 2-D PCA of 96-D blobs:
    |e| ~ 24, gaps ~ 0.03), and the expanded form's f32 cancellation
    error, ~1e-7 |e|^2, is then ~10% of the gap and reorders the
    neighbours (1.7e-4 of the score against float64 at 32,768 rows on an
    H100; unexpanded, the score equals float64's to six digits).
"""

from __future__ import annotations

from typing import Optional

import torch

from raft_tpu_torch.core.validation import as_input, as_tensor
from raft_tpu_torch.stats.descriptive import _f32

#: bytes of the (rows, n) distance block `trustworthiness_score` ranks at once
BLOCK_BUDGET_BYTES = 1 << 30


def _labels(x, device=None) -> torch.Tensor:
    return as_input(x, device).to(torch.int32)


# -- classification / regression -------------------------------------------


def accuracy(predictions, labels, device=None) -> torch.Tensor:
    p = as_input(predictions, device)
    lab = as_tensor(labels, p.device)
    return torch.mean((p == lab).float())


def r2_score(y, y_hat, device=None) -> torch.Tensor:
    yt = _f32(y, device)
    yp = as_tensor(y_hat, yt.device).float()
    ss_res = torch.sum((yt - yp) ** 2)
    ss_tot = torch.sum((yt - torch.mean(yt)) ** 2)
    return 1.0 - ss_res / torch.clamp(ss_tot, min=1e-30)


def _median(x: torch.Tensor) -> torch.Tensor:
    """numpy's median: the mean of the two middle values of an even count."""
    s = torch.sort(x.reshape(-1)).values
    n = s.numel()
    if n % 2:
        return s[n // 2]
    return (s[n // 2 - 1] + s[n // 2]) * 0.5


def regression_metrics(predictions, ref, device=None) -> dict:
    """mean_abs_error, mean_squared_error, median_abs_error
    (regression_metrics.cuh)."""
    p = _f32(predictions, device)
    err = p - as_tensor(ref, p.device).float()
    return {
        "mean_abs_error": torch.mean(torch.abs(err)),
        "mean_squared_error": torch.mean(err ** 2),
        "median_abs_error": _median(torch.abs(err)),
    }


# -- clustering comparison metrics ------------------------------------------


def contingency_matrix(y_true, y_pred, n_classes: Optional[int] = None,
                       device=None) -> torch.Tensor:
    """(n_classes, n_classes) int32 pair counts of two labelings."""
    a = _labels(y_true, device)
    b = _labels(y_pred, a.device)
    if n_classes is None:
        n_classes = int(max(int(torch.max(a)), int(torch.max(b)))) + 1
    idx = (a.long() * n_classes + b.long())
    flat = torch.bincount(idx, minlength=n_classes * n_classes)
    return flat.to(torch.int32).reshape(n_classes, n_classes)


def _comb2(x: torch.Tensor) -> torch.Tensor:
    x = x.float()
    return x * (x - 1.0) / 2.0


def rand_index(y_true, y_pred, device=None) -> torch.Tensor:
    """Unadjusted Rand index (rand_index.cuh)."""
    c = contingency_matrix(y_true, y_pred, device=device).float()
    n = torch.sum(c)
    sum_sq = torch.sum(c ** 2)
    a_sq = torch.sum(torch.sum(c, dim=1) ** 2)
    b_sq = torch.sum(torch.sum(c, dim=0) ** 2)
    tp = (sum_sq - n) / 2.0
    fp = (a_sq - sum_sq) / 2.0
    fn = (b_sq - sum_sq) / 2.0
    tn = _comb2(n) - tp - fp - fn
    return (tp + tn) / _comb2(n)


def adjusted_rand_index(y_true, y_pred, device=None) -> torch.Tensor:
    c = contingency_matrix(y_true, y_pred, device=device)
    n = torch.sum(c).float()
    sum_comb = torch.sum(_comb2(c))
    sum_a = torch.sum(_comb2(torch.sum(c, dim=1)))
    sum_b = torch.sum(_comb2(torch.sum(c, dim=0)))
    expected = sum_a * sum_b / torch.clamp(_comb2(n), min=1e-30)
    max_idx = 0.5 * (sum_a + sum_b)
    return (sum_comb - expected) / torch.clamp(max_idx - expected, min=1e-30)


def entropy(labels, n_classes: Optional[int] = None, device=None) -> torch.Tensor:
    lab = _labels(labels, device)
    if n_classes is None:
        n_classes = int(torch.max(lab)) + 1
    counts = torch.bincount(lab.long(), minlength=n_classes).float()
    p = counts / torch.clamp(torch.sum(counts), min=1.0)
    return -torch.sum(torch.where(p > 0, p * torch.log(torch.clamp(p, min=1e-30)), 0.0))


def mutual_info_score(y_true, y_pred, device=None) -> torch.Tensor:
    c = contingency_matrix(y_true, y_pred, device=device).float()
    pij = c / torch.sum(c)
    pi = torch.sum(pij, dim=1, keepdim=True)
    pj = torch.sum(pij, dim=0, keepdim=True)
    ratio = pij / torch.clamp(pi * pj, min=1e-30)
    return torch.sum(torch.where(pij > 0, pij * torch.log(torch.clamp(ratio, min=1e-30)), 0.0))


def homogeneity_score(y_true, y_pred, device=None) -> torch.Tensor:
    mi = mutual_info_score(y_true, y_pred, device=device)
    h = entropy(y_true, device=mi.device)
    return torch.where(h > 0, mi / torch.clamp(h, min=1e-30), 1.0)


def completeness_score(y_true, y_pred, device=None) -> torch.Tensor:
    return homogeneity_score(y_pred, y_true, device=device)


def v_measure(y_true, y_pred, beta: float = 1.0, device=None) -> torch.Tensor:
    h = homogeneity_score(y_true, y_pred, device=device)
    c = completeness_score(y_true, y_pred, device=h.device)
    denom = beta * h + c
    return torch.where(denom > 0, (1 + beta) * h * c / torch.clamp(denom, min=1e-30), 0.0)


def kl_divergence(p, q, device=None) -> torch.Tensor:
    pp = _f32(p, device)
    qq = as_tensor(q, pp.device).float()
    safe = (pp > 0) & (qq > 0)
    ratio = torch.clamp(pp, min=1e-30) / torch.clamp(qq, min=1e-30)
    return torch.sum(torch.where(safe, pp * torch.log(ratio), 0.0))


# -- geometric metrics ------------------------------------------------------


def silhouette_score(X, labels, n_classes: Optional[int] = None, batch: int = 4096,
                     device=None) -> torch.Tensor:
    """Mean silhouette coefficient (silhouette_score.cuh, incl. the batched
    variant): a(i) = mean intra-cluster distance, b(i) = min mean distance
    to another cluster, from per-cluster distance sums of one streamed
    pairwise pass (no n x n matrix)."""
    from raft_tpu_torch.core.config import strict_f32_matmul
    from raft_tpu_torch.distance.pairwise import _dot

    x = _f32(X, device)
    lab = _labels(labels, x.device).long()
    n = x.shape[0]
    if n_classes is None:
        n_classes = int(torch.max(lab)) + 1
    onehot = torch.nn.functional.one_hot(lab, n_classes).float()  # (n, k)
    counts = onehot.sum(0)
    bm = min(n, max(8, batch))
    xn = torch.sum(x * x, dim=1)
    sums = torch.empty((n, n_classes), dtype=torch.float32, device=x.device)
    for s in range(0, n, bm):
        xb = x[s:s + bm]
        d = torch.sqrt(torch.clamp(xn[s:s + bm, None] + xn[None, :] - 2.0 * _dot(xb, x),
                                   min=0.0))
        strict_f32_matmul()
        sums[s:s + bm] = d @ onehot  # (bm, k) distance sums per cluster
    own = counts[lab]
    a = torch.where(own > 1, torch.gather(sums, 1, lab[:, None])[:, 0]
                    / torch.clamp(own - 1, min=1.0), 0.0)
    mean_other = sums / torch.clamp(counts[None, :], min=1.0)
    mean_other = torch.where(onehot.bool(), float("inf"), mean_other)
    b = torch.amin(mean_other, dim=1)
    s = torch.where(own > 1, (b - a) / torch.clamp(torch.maximum(a, b), min=1e-30), 0.0)
    return torch.mean(s)


def _neighbor_ranks(x: torch.Tensor, nbrs: torch.Tensor) -> torch.Tensor:
    """(n, t) rank of each nbrs[i, j] among row i's L2Expanded distances
    to every row, in select_k's order (the position it takes in
    `_bf_knn_impl(x, x, n)`)."""
    from raft_tpu_torch.distance.distance_types import DistanceType
    from raft_tpu_torch.distance.pairwise import _pairwise_impl
    from raft_tpu_torch.matrix.select_k import _order_key

    n = x.shape[0]
    bm = max(1, min(n, BLOCK_BUDGET_BYTES // max(1, 4 * n)))
    col = torch.arange(n, device=x.device)
    ranks = torch.empty(nbrs.shape, dtype=torch.int64, device=x.device)
    for s in range(0, n, bm):
        key = _order_key(_pairwise_impl(x[s:s + bm], x, DistanceType.L2Expanded))
        for t in range(nbrs.shape[1]):
            j = nbrs[s:s + bm, t:t + 1]
            kj = torch.gather(key, 1, j)
            before = (key < kj) | ((key == kj) & (col[None, :] < j))
            ranks[s:s + bm, t] = torch.sum(before, dim=1)
    return ranks


def trustworthiness_score(X, X_embedded, n_neighbors: int = 5, device=None) -> torch.Tensor:
    """Trustworthiness of an embedding (trustworthiness_score.cuh)."""
    from raft_tpu_torch.distance.distance_types import DistanceType
    from raft_tpu_torch.neighbors.brute_force import _bf_knn_impl

    x = _f32(X, device)
    e = as_tensor(X_embedded, x.device).float()
    n = x.shape[0]
    _, ind_e = _bf_knn_impl(e, e, n_neighbors + 1, DistanceType.L2Unexpanded)
    nbrs = ind_e[:, 1:n_neighbors + 1].long()
    r = _neighbor_ranks(x, nbrs) - n_neighbors
    penalty = torch.sum(torch.clamp(r, min=0).float())
    norm = 2.0 / (n * n_neighbors * (2.0 * n - 3.0 * n_neighbors - 1.0))
    return 1.0 - norm * penalty


def information_criterion_batched(log_likelihood, n_params: int, n_samples: int,
                                  criterion: str = "AIC", device=None) -> torch.Tensor:
    """AIC / AICc / BIC (information_criterion.cuh)."""
    import math

    ll = _f32(log_likelihood, device)
    if criterion == "AIC":
        return -2.0 * ll + 2.0 * n_params
    if criterion == "AICc":
        corr = 2.0 * n_params * (n_params + 1.0) / max(n_samples - n_params - 1.0, 1.0)
        return -2.0 * ll + 2.0 * n_params + corr
    if criterion == "BIC":
        return -2.0 * ll + n_params * math.log(float(n_samples))
    raise ValueError(criterion)
