"""Epsilon neighborhood: all pairs within a radius (counterpart of
raft_tpu/neighbors/epsilon_neighborhood.py; epsilon_neighborhood.cuh
`epsUnexpL2SqNeighborhood`).

The (m, n) distances are computed in row blocks sized by
`BLOCK_BUDGET_BYTES` (the JAX function takes them at once); each row's
answer does not depend on its block.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.validation import check_matrix, check_same_cols
from raft_tpu_torch.distance.distance_types import resolve_metric
from raft_tpu_torch.distance.pairwise import _pairwise_impl

#: bytes of the (bm, n) f32 distance block one step computes
BLOCK_BUDGET_BYTES = 1 << 30


def _eps_impl(x: torch.Tensor, y: torch.Tensor, eps: float, metric) -> torch.Tensor:
    m, n = x.shape[0], y.shape[0]
    bm = max(1, min(m, BLOCK_BUDGET_BYTES // max(1, 4 * n)))
    adj = torch.empty((m, n), dtype=torch.bool, device=x.device)
    for s in range(0, m, bm):
        adj[s:s + bm] = _pairwise_impl(x[s:s + bm], y, metric) <= eps
    return adj


def eps_neighbors(X, Y, eps: float, metric="sqeuclidean", device=None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (adj (m, n) bool, vertex_degrees (m,) int32): adj[i, j] iff
    dist(x_i, y_j) <= eps. eps is in the metric's units (squared L2 for
    the default, matching epsUnexpL2SqNeighborhood)."""
    x = check_matrix(X, device=device, dtype=torch.float32, name="X")
    y = check_matrix(Y, device=x.device, dtype=torch.float32, name="Y")
    check_same_cols(x, y, "X", "Y")
    adj = _eps_impl(x, y, float(eps), resolve_metric(metric))
    return adj, torch.sum(adj, dim=1, dtype=torch.int32)
