"""Descriptive statistics (counterpart of raft_tpu/stats/descriptive.py;
stats/mean.cuh, stddev.cuh, meanvar.cuh, cov.cuh, sum.cuh, minmax.cuh,
mean_center.cuh, weighted_mean.cuh, histogram.cuh, dispersion.cuh).

Every function takes array-likes (numpy, tensors) and an explicit
`device` (the card unless told otherwise; a tensor argument keeps its
own device when `device` is None) and returns tensors, float32 as the
JAX package computes them. Products (`cov`) are full float32 (TF32 off).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.validation import as_input, as_tensor


def _f32(x, device=None) -> torch.Tensor:
    return as_input(x, device).float()


def mean(data, axis: int = 0, sample: bool = False, device=None) -> torch.Tensor:
    """Column means (stats/mean.cuh; `sample` divides by N-1)."""
    x = _f32(data, device)
    n = x.shape[axis]
    return torch.sum(x, dim=axis) / (n - 1 if sample else n)


def sum_stat(data, axis: int = 0, device=None) -> torch.Tensor:
    return torch.sum(_f32(data, device), dim=axis)


def vars_stat(data, mu=None, axis: int = 0, sample: bool = True, device=None) -> torch.Tensor:
    x = _f32(data, device)
    m = mean(x, axis=axis) if mu is None else as_tensor(mu, x.device)
    n = x.shape[axis]
    return torch.sum((x - m.unsqueeze(axis)) ** 2, dim=axis) / (n - 1 if sample else n)


def stddev(data, mu=None, axis: int = 0, sample: bool = True, device=None) -> torch.Tensor:
    return torch.sqrt(vars_stat(data, mu, axis=axis, sample=sample, device=device))


def meanvar(data, axis: int = 0, sample: bool = True, device=None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean and variance (stats/meanvar.cuh)."""
    x = _f32(data, device)
    m = mean(x, axis=axis)
    return m, vars_stat(x, mu=m, axis=axis, sample=sample)


def mean_center(data, mu=None, axis: int = 0, device=None) -> torch.Tensor:
    x = _f32(data, device)
    m = mean(x, axis=axis) if mu is None else as_tensor(mu, x.device)
    return x - m.unsqueeze(axis)


def mean_add(data, mu, axis: int = 0, device=None) -> torch.Tensor:
    x = as_input(data, device)
    return x + as_tensor(mu, x.device).unsqueeze(axis)


def cov(data, mu=None, sample: bool = True, stable: bool = True, device=None) -> torch.Tensor:
    """Covariance matrix of rows-as-samples (stats/cov.cuh), full f32."""
    from raft_tpu_torch.core.config import strict_f32_matmul

    x = mean_center(data, mu, device=device)
    n = x.shape[0]
    strict_f32_matmul()
    return (x.T @ x) / (n - 1 if sample else n)


def minmax(data, axis: int = 0, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    x = as_input(data, device)
    return torch.amin(x, dim=axis), torch.amax(x, dim=axis)


def weighted_mean(data, weights, axis: int = 0, device=None) -> torch.Tensor:
    x = _f32(data, device)
    w = as_tensor(weights, x.device).float()
    return torch.tensordot(w, x, dims=([0], [axis])) / torch.clamp(torch.sum(w), min=1e-30)


def row_weighted_mean(data, weights, device=None) -> torch.Tensor:
    """Per-row weighted mean over columns (stats/weighted_mean.cuh)."""
    x = _f32(data, device)
    w = as_tensor(weights, x.device).float()
    return (x * w[None, :]).sum(dim=1) / torch.clamp(torch.sum(w), min=1e-30)


def histogram(data, n_bins: int, lower: float, upper: float, device=None) -> torch.Tensor:
    """Fixed-range histogram (stats/histogram.cuh): int32 counts of the
    values in [lower, upper), a segment sum (no float atomics)."""
    x = _f32(data, device).reshape(-1)
    scaled = (x - lower) / (upper - lower) * n_bins
    idx = torch.clamp(scaled.to(torch.int32), 0, n_bins - 1).long()
    valid = ((x >= lower) & (x < upper)).to(torch.int32)
    return torch.zeros((n_bins,), dtype=torch.int32, device=x.device).index_add_(0, idx, valid)


def dispersion(centroids, cluster_sizes, global_centroid=None, n_points: Optional[int] = None,
               device=None) -> torch.Tensor:
    """Between-cluster dispersion (stats/dispersion.cuh): sqrt of the
    size-weighted squared distances of the centroids to the global one."""
    c = _f32(centroids, device)
    sz = as_tensor(cluster_sizes, c.device).float()
    n = torch.sum(sz) if n_points is None else torch.tensor(float(n_points), device=c.device)
    g = (as_tensor(global_centroid, c.device).float() if global_centroid is not None
         else (sz[:, None] * c).sum(0) / torch.clamp(n, min=1.0))
    d = torch.sum((c - g[None, :]) ** 2, dim=1)
    return torch.sqrt(torch.sum(sz * d))
