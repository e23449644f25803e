"""Masked L2 nearest neighbours (counterpart of
raft_tpu/distance/masked_nn.py; distance/masked_nn.cuh): a fused L2
argmin where each x row only considers the y rows of the groups its
adjacency row allows (adj (m, n_groups), group of each y row (n,)), the
HDBSCAN workload.

x streams in row blocks sized by a memory budget (the JAX package takes
2^21 / n rows): each block's (bm, n) distance tile is one full-float32
matmul and the row norms, the disallowed columns masked to +inf, and a
min / argmin (ties to the lower index, so the block does not change the
answer). `fused_l2_argmin` (kernel 5) has no mask operand, so this stays
PyTorch, as the JAX function is jnp.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.validation import as_tensor, check_matrix, check_same_cols
from raft_tpu_torch.distance.pairwise import _dot

#: bytes of the (bm, n) distance tile a block computes
BLOCK_BUDGET_BYTES = 1 << 30


def _masked_l2_nn(x: torch.Tensor, y: torch.Tensor, adj: torch.Tensor, group_of_y: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    m = x.shape[0]
    n = y.shape[0]
    bm = max(1, min(m, BLOCK_BUDGET_BYTES // max(1, 4 * n)))
    yn = torch.sum(y * y, dim=1)
    gy = group_of_y.long()
    dmin = torch.empty((m,), dtype=torch.float32, device=x.device)
    idx = torch.empty((m,), dtype=torch.int32, device=x.device)
    for s in range(0, m, bm):
        xb = x[s:s + bm]
        xn = torch.sum(xb * xb, dim=1)[:, None]
        dist = torch.clamp(xn + yn[None, :] - 2.0 * _dot(xb, y), min=0.0)
        dist = torch.where(adj[s:s + bm][:, gy], dist, torch.inf)
        dmin[s:s + bm], am = torch.min(dist, dim=1)
        idx[s:s + bm] = am.to(torch.int32)
    return dmin, idx


def masked_l2_nn(X, Y, adj, group_ids, sqrt: bool = False,
                 device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """For each row of X, the nearest row of Y whose group `adj[i]` allows:
    (f32 squared distances, or distances with `sqrt`; int32 indices); a
    row with no allowed group gets (inf, -1)."""
    x = check_matrix(X, device=device, name="X").float()
    y = check_matrix(Y, device=x.device, name="Y").float()
    check_same_cols(x, y, "X", "Y")
    a = as_tensor(adj, x.device).bool()
    g = as_tensor(group_ids, x.device).to(torch.int32)
    if a.shape[0] != x.shape[0]:
        raise ValueError("adj must have one row per X row")
    if g.shape[0] != y.shape[0]:
        raise ValueError("group_ids must have one entry per Y row")
    d, i = _masked_l2_nn(x, y, a, g)
    i = torch.where(torch.isfinite(d), i, -1)
    if sqrt:
        d = torch.sqrt(d)
    return d, i
