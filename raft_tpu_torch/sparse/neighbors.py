"""Sparse neighbors: the k-NN graph and the cross-component connection
(counterpart of raft_tpu/sparse/neighbors.py;
sparse/neighbors/{knn_graph,connect_components}.cuh).

`knn_graph` runs the tiled brute-force k-NN (`brute_force._bf_knn_impl`,
the JAX default engine, f32 distances) over query batches sized by a
memory budget: the JAX package scores every row at once against each
32,768-row tile, which at 262,144 rows is a 34 GB tile. Each query's
answer is independent of its batch. `cross_component_nn` (the masked
1-NN over components) blocks its rows by the same kind of budget where
the JAX package takes 2^21 / n rows; argmin ties go to the lower index
on both, so the answer does not depend on the block.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.validation import as_tensor, check_matrix
from raft_tpu_torch.sparse.formats import CooMatrix

#: bytes of the per-batch distance block of `knn_graph` and sparse `knn`,
#: and of the per-block distance tile of `cross_component_nn`
BLOCK_BUDGET_BYTES = 1 << 30


def _rows_per_block(width: int, total: int) -> int:
    return max(1, min(total, BLOCK_BUDGET_BYTES // max(1, 4 * width)))


def batched_knn(dataset: torch.Tensor, queries: torch.Tensor, k: int, metric
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """`brute_force._bf_knn_impl` over query batches whose distance block
    (batch x the dataset rows one step scores) stays within the budget."""
    from raft_tpu_torch.neighbors.brute_force import _TILE, _bf_knn_impl

    n = dataset.shape[0]
    width = n if n <= max(2 * _TILE, 4 * k) else _TILE
    bq = _rows_per_block(width, queries.shape[0])
    if bq >= queries.shape[0]:
        return _bf_knn_impl(dataset, queries, k, metric)
    parts = [_bf_knn_impl(dataset, queries[s:s + bq], k, metric)
             for s in range(0, queries.shape[0], bq)]
    return torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts])


def _directed_knn_coo(x: torch.Tensor, k: int, metric) -> CooMatrix:
    """Each row's k + 1 nearest rows with the first column dropped, as a
    COO in row order (before the symmetrization)."""
    from raft_tpu_torch.distance.distance_types import resolve_metric

    n = x.shape[0]
    d, i = batched_knn(x, x, min(k + 1, n), resolve_metric(metric))
    d, i = d[:, 1:], i[:, 1:]
    rows = torch.arange(n, dtype=torch.int32, device=x.device).repeat_interleave(d.shape[1])
    return CooMatrix(rows, i.reshape(-1).to(torch.int32), d.reshape(-1).float(), (n, n))


def knn_graph(X, k: int, metric="sqeuclidean", device=None) -> CooMatrix:
    """Symmetrized k-NN graph as COO (sparse/neighbors/knn_graph.cuh):
    each row's k + 1 nearest rows with the first column dropped, merged
    with the transpose by max."""
    from raft_tpu_torch.sparse.linalg import symmetrize

    x = check_matrix(X, device=device, name="X").float()
    return symmetrize(_directed_knn_coo(x, k, metric), op="max")


def cross_component_nn(X, labels, metric="sqeuclidean", device=None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """For every row, its nearest row in a DIFFERENT component (squared
    L2 whatever `metric` says, as in the JAX package): (dists (n,) f32,
    idx (n,) int32); a row alone in the data gets (inf, 0)."""
    from raft_tpu_torch.distance.pairwise import _dot

    x = check_matrix(X, device=device, name="X").float()
    lab = as_tensor(labels, x.device).to(torch.int32)
    n = x.shape[0]
    bm = _rows_per_block(n, n)
    yn = torch.sum(x * x, dim=1)
    dmin = torch.empty((n,), dtype=torch.float32, device=x.device)
    idx = torch.empty((n,), dtype=torch.int32, device=x.device)
    for s in range(0, n, bm):
        xb, lb = x[s:s + bm], lab[s:s + bm]
        d = torch.clamp(torch.sum(xb * xb, 1)[:, None] + yn[None, :] - 2.0 * _dot(xb, x),
                        min=0.0)
        d = torch.where(lb[:, None] == lab[None, :], torch.inf, d)
        dmin[s:s + bm], am = torch.min(d, dim=1)
        idx[s:s + bm] = am.to(torch.int32)
    return dmin, idx


def _first_min_per_group(vals: torch.Tensor, group: torch.Tensor, n_groups: int):
    """Per group: the lowest index whose value is the group's minimum
    (`members[np.argmin(vals[members])]`), n where the group is empty."""
    n = vals.shape[0]
    gmin = torch.full((n_groups,), torch.inf, dtype=vals.dtype, device=vals.device)
    gmin.scatter_reduce_(0, group, vals, "amin", include_self=True)
    pos = torch.arange(n, device=vals.device)
    cand = torch.where(vals == gmin[group], pos, n)
    best = torch.full((n_groups,), n, dtype=torch.int64, device=vals.device)
    return best.scatter_reduce_(0, group, cand, "amin", include_self=True)


def connect_components(X, labels, metric="sqeuclidean", device=None) -> CooMatrix:
    """Edges connecting graph components (sparse/neighbors/
    connect_components.cuh): for each component in label order, the
    shortest cross-component edge from any of its rows (the lowest row on
    a tie), both directions. Labels are 0..C-1."""
    x = check_matrix(X, device=device, name="X").float()
    lab = as_tensor(labels, x.device).long()
    n = lab.shape[0]
    n_comp = int(lab.max()) + 1 if n else 0
    if n_comp <= 1:
        z = torch.zeros((0,), dtype=torch.int32, device=x.device)
        return CooMatrix(z, z.clone(), torch.zeros((0,), dtype=torch.float32,
                                                   device=x.device), (n, n))
    dmin, idx = cross_component_nn(x, lab, metric, device=x.device)
    best = _first_min_per_group(dmin, lab, n_comp)
    best = best[best < n]
    r, c, v = best.to(torch.int32), idx[best], dmin[best]
    return CooMatrix(torch.cat([r, c]), torch.cat([c, r]), torch.cat([v, v]), (n, n))
