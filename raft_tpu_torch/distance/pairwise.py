"""Expanded pairwise distances (counterpart of raft_tpu/distance/pairwise.py).

This slice carries only what the fused scans are held against: the
expanded L2 / sqeuclidean / inner-product family as one float32 matmul
plus row-norm epilogues. The other metrics are still to be ported
(ROADMAP Queue A item 3).
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.config import strict_f32_matmul
from raft_tpu_torch.distance.distance_types import DistanceType


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (m, k) @ y.T (k, n) in full float32 (no TF32: the reference runs
    these dots at Precision.HIGHEST)."""
    strict_f32_matmul()
    return x.float() @ y.float().T


def _row_norms_sq(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return torch.sum(xf * xf, dim=1)


def _pairwise_impl(x: torch.Tensor, y: torch.Tensor, metric: DistanceType) -> torch.Tensor:
    if metric == DistanceType.InnerProduct:
        return _dot(x, y)
    if metric in (DistanceType.L2Expanded, DistanceType.L2SqrtExpanded):
        d = _dot(x, y)
        out = torch.clamp(
            _row_norms_sq(x)[:, None] + _row_norms_sq(y)[None, :] - 2.0 * d, min=0.0
        )
        return torch.sqrt(out) if metric == DistanceType.L2SqrtExpanded else out
    raise NotImplementedError(
        f"metric {metric!r} is not ported yet (ROADMAP Queue A item 3)"
    )
