"""Sparse pairwise distances and sparse k-NN (counterpart of
raft_tpu/sparse/distance.py; sparse/distance/distance.cuh:36-54, 19
metrics over CSR x CSR).

Block densification, as the JAX package does it: y is densified once
(the reused operand) and x streams through in `row_block`-row dense
tiles into the dense engine (`distance.pairwise._pairwise_impl`: the
expanded metrics one f32 matmul, the unexpanded ones through the
`pairwise_tiled` kernel on the card). When dense y would pass
`densify_budget_bytes`, y streams in row blocks too; when even one block
pair would, the column space compacts to the union of the active
columns (exact: an inactive column adds (0, 0) to every term; Hamming,
RusselRao and Correlation, which read the full column count, are
corrected in closed form) and the row blocks shrink. Sparse `knn`
streams the dataset x in dense row blocks and merges their top-k; its
queries go in batches sized by `neighbors.BLOCK_BUDGET_BYTES`.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.distance.distance_types import DistanceType, resolve_metric
from raft_tpu_torch.distance.pairwise import _pairwise_impl
from raft_tpu_torch.sparse.formats import CsrMatrix, csr_to_dense

SUPPORTED_DISTANCES = [
    DistanceType.L2Expanded,
    DistanceType.L2SqrtExpanded,
    DistanceType.InnerProduct,
    DistanceType.L2Unexpanded,
    DistanceType.L2SqrtUnexpanded,
    DistanceType.L1,
    DistanceType.Canberra,
    DistanceType.Linf,
    DistanceType.LpUnexpanded,
    DistanceType.JaccardExpanded,
    DistanceType.CosineExpanded,
    DistanceType.HellingerExpanded,
    DistanceType.DiceExpanded,
    DistanceType.CorrelationExpanded,
    DistanceType.RusselRaoExpanded,
    DistanceType.HammingUnexpanded,
    DistanceType.JensenShannon,
    DistanceType.KLDivergence,
    DistanceType.BrayCurtis,
]

# dense row block of the streamed operand
_ROW_BLOCK = 4096

# densified-operand budget: past it the reused y streams in row blocks too
_DENSIFY_BUDGET_BYTES = 2 << 30


def pairwise_distance(x: CsrMatrix, y: CsrMatrix, metric="euclidean", p: float = 2.0,
                      densify_budget_bytes: int = None, row_block: int = None):
    """The (m_x, m_y) f32 distance matrix of two CSRs on their device."""
    m = resolve_metric(metric)
    if m not in SUPPORTED_DISTANCES:
        raise ValueError(f"metric {m} not supported for sparse inputs")
    if x.shape[1] != y.shape[1]:
        raise ValueError("column mismatch")
    budget = _DENSIFY_BUDGET_BYTES if densify_budget_bytes is None else int(densify_budget_bytes)
    rb = int(row_block) if row_block else _ROW_BLOCK
    k = x.shape[1]
    if 4 * k * (min(rb, x.shape[0]) + min(rb, y.shape[0])) > budget:
        return _pairwise_compact_columns(x, y, m, float(p), budget, rb)
    if 4 * y.shape[0] * k > budget:
        if 4 * x.shape[0] * k <= budget:
            # dense x fits: hold its blocks once and stream y (operand
            # order kept: KL divergence is asymmetric)
            xblocks = list(_iter_dense_blocks(x, row_block=rb))
            cols = [torch.cat([_pairwise_impl(xb, yb, m, metric_arg=float(p)) for xb in xblocks])
                    for yb in _iter_dense_blocks(y, row_block=rb)]
            return torch.cat(cols, dim=1)
        # both over budget: x re-streams for each y block
        cols = [_pairwise_dense_y(x, yb, m, float(p), row_block=rb)
                for yb in _iter_dense_blocks(y, row_block=rb)]
        return torch.cat(cols, dim=1)
    return _pairwise_dense_y(x, csr_to_dense(y).float(), m, float(p), row_block=rb)


def _compact_column_space(x: CsrMatrix, y: CsrMatrix):
    """Both CSRs on the sorted union of their active columns: (x', y', u),
    u >= 1 (a dummy column keeps shapes valid when both are empty)."""
    xi, yi = x.indices.long(), y.indices.long()
    cols = torch.unique(torch.cat([xi, yi]), sorted=True)
    if cols.numel() == 0:
        cols = torch.zeros((1,), dtype=torch.int64, device=x.device)
    u = int(cols.numel())
    x2 = CsrMatrix(x.indptr, torch.searchsorted(cols, xi).to(torch.int32), x.data,
                   (x.shape[0], u))
    y2 = CsrMatrix(y.indptr, torch.searchsorted(cols, yi).to(torch.int32), y.data,
                   (y.shape[0], u))
    return x2, y2, u


def _pairwise_compact_columns(x: CsrMatrix, y: CsrMatrix, m: DistanceType, p: float,
                              budget: int, row_block: int = None):
    """The distance matrix in the compacted column space, exact over the
    full k = x.shape[1] columns (see the module docstring)."""
    from raft_tpu_torch.sparse.linalg import row_norm_csr, spmv

    D = DistanceType
    k = x.shape[1]
    x2, y2, u = _compact_column_space(x, y)
    rb = row_block or _ROW_BLOCK
    while 4 * u * (min(rb, x.shape[0]) + min(rb, y.shape[0])) > budget and rb > 32:
        rb //= 2
    if 4 * u * (min(rb, x.shape[0]) + min(rb, y.shape[0])) > budget:
        raise ValueError(
            f"sparse inputs stay over densify_budget_bytes={budget} even "
            f"in the compacted column space ({u} active of {k} columns) "
            f"at the minimum {rb}-row block; raise the budget")

    def again(metric):
        return pairwise_distance(x2, y2, metric, p, densify_budget_bytes=budget, row_block=rb)

    if m == D.HammingUnexpanded:
        return again(m) * (u / k)
    if m == D.RusselRaoExpanded:
        # the compact value is (u - dot) / u; the full-k metric (k - dot) / k
        return 1.0 - (u / k) * (1.0 - again(m))
    if m == D.CorrelationExpanded:
        dot = again(D.InnerProduct)

        def sums(c):
            c = CsrMatrix(c.indptr, c.indices, c.data.float(), c.shape)
            ones = torch.ones((c.shape[1],), dtype=torch.float32, device=c.device)
            return spmv(c, ones), row_norm_csr(c, "l2")

        sx, qx = sums(x2)
        sy, qy = sums(y2)
        cov = dot - sx[:, None] * sy[None, :] / k
        vx = torch.clamp(qx - sx ** 2 / k, min=0.0)
        vy = torch.clamp(qy - sy ** 2 / k, min=0.0)
        return 1.0 - cov / torch.clamp(torch.sqrt(vx[:, None] * vy[None, :]), min=1e-30)
    return again(m)


def _pairwise_dense_y(x: CsrMatrix, yd: torch.Tensor, m: DistanceType, p: float,
                      row_block: int = None):
    """x streamed in dense row blocks against an already-dense y."""
    rb = row_block or _ROW_BLOCK
    if x.shape[0] <= rb:
        return _pairwise_impl(csr_to_dense(x).float(), yd, m, metric_arg=p)
    return torch.cat([_pairwise_impl(xb, yd, m, metric_arg=p)
                      for xb in _iter_dense_blocks(x, row_block=rb)])


def _iter_dense_blocks(x: CsrMatrix, row_block: int = None):
    """Dense f32 row blocks of a CSR; the row pointers are read to the host
    once for the block bounds."""
    rb = row_block or _ROW_BLOCK
    indptr = x.indptr.cpu()
    n_rows, n_cols = x.shape
    for lo in range(0, n_rows, rb):
        hi = min(lo + rb, n_rows)
        plo, phi = int(indptr[lo]), int(indptr[hi])
        block = CsrMatrix(x.indptr[lo:hi + 1] - plo, x.indices[plo:phi], x.data[plo:phi],
                          (hi - lo, n_cols))
        yield csr_to_dense(block).float()


def knn(x: CsrMatrix, y: CsrMatrix, k: int, metric="euclidean"):
    """Sparse brute-force k-NN (sparse/neighbors/brute_force.cuh): dataset
    x, queries y; (dists, int32 idx into x rows). The dataset streams in
    dense row blocks whose partial top-k merge (knn_merge_parts)."""
    from raft_tpu_torch.distance.distance_types import SIMILARITY_METRICS
    from raft_tpu_torch.matrix.select_k import _select_k_impl
    from raft_tpu_torch.sparse.neighbors import batched_knn

    m = resolve_metric(metric)
    k = int(k)
    yd = csr_to_dense(y).float()
    if x.shape[0] <= _ROW_BLOCK:
        return batched_knn(csr_to_dense(x).float(), yd, k, m)
    select_min = m not in SIMILARITY_METRICS
    parts_v, parts_i = [], []
    lo = 0
    for xb in _iter_dense_blocks(x):
        hi = lo + xb.shape[0]
        dv, di = batched_knn(xb, yd, min(k, hi - lo), m)
        parts_v.append(dv)
        parts_i.append(di + lo)
        lo = hi
    cat_v, cat_i = torch.cat(parts_v, dim=1), torch.cat(parts_i, dim=1)
    v, pos = _select_k_impl(cat_v, k, select_min)
    return v, torch.gather(cat_i, 1, pos.long())
