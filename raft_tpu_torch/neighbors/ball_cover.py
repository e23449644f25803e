"""Random ball cover: metric-pruned exact k-NN for low-dim / haversine data
(counterpart of raft_tpu/neighbors/ball_cover.py; ball_cover.cuh
`build_index`, `knn_query`, `all_knn_query`; cuML's
`NearestNeighbors(algorithm="rbc")`).

sqrt(n) landmarks drawn with numpy's `default_rng(seed).choice` (the JAX
package's draw, so landmarks, labels, `row_ids` and radii equal its
index); every row joins its nearest landmark's ball (argmin, the first
landmark on ties), kept as the IVF slot table (`ivf_flat._pack_lists`);
a ball's radius is its members' largest distance to it, one
`scatter_reduce(amax)`. The build's (n, L) distances are blocked by rows.

The exact query is the JAX package's two passes, per block of queries:

  pass 1  the `p1 = min(L, max(32, k))` balls with the smallest lower
          bound lb(q, l) = d(q, landmark_l) - radius_l, scored exactly;
          the k-th best is the bound B;
  prune   a ball can hold a true top-k member only if lb <= B (1 + 4e-3)
          + 1e-6 (root domain for the squared metrics, where the triangle
          inequality holds);
  pass 2  each query with more surviving balls than p1, again with p2 =
          p1 doubled up to its count (at most L); the queries of one p2
          are scored together.

The JAX package takes the surviving count over the whole call and
re-scores every query at the one p2 it gives. A query with at most p1
survivors has probed all of them (they are the smallest lower bounds),
so its pass-1 answer is already exact, and a larger p2 only adds balls
that cannot hold a neighbour: both answers are exact and differ at most
in the order within groups of equal distance. A block of queries is
scored against its gathered candidate rows in one batched pass, with
`_pairwise_impl`'s formula for the metric (the expanded form for
L2Expanded with its dot as an elementwise sum, the haversine of
`distance.pairwise._haversine`, sums over the depth for L1 and the
unexpanded L2, the max for Linf); other metrics score query by query
through `_pairwise_impl` itself. The candidate table holds each query's
probed members without the slot table's -1 padding (in the same order),
so its width is the block's largest member count rather than p times
the widest ball; blocks are sized by `BLOCK_BUDGET_BYTES` over that
table, which the JAX package builds for every query at once.

On the card, the ball select (lb's p smallest) and the candidate select
go through `matrix.select_k._select_k_impl`, which the committed tuned
table sends to kernel 6 (`counting_select_min`) for k <= 128; the squared
metrics' landmark bounds are `L2Unexpanded`, kernel 8 (`pairwise_tiled`).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.core.validation import as_tensor, check_matrix
from raft_tpu_torch.distance.distance_types import DistanceType, resolve_metric
from raft_tpu_torch.distance.pairwise import _TINY, _pairwise_impl, _sin_half_dlon
from raft_tpu_torch.matrix.select_k import _select_k_impl

#: bytes of one query block's candidate table and its scores (and of the
#: build's (rows, L) distance block)
BLOCK_BUDGET_BYTES = 1 << 30


@dataclasses.dataclass
class BallCoverIndex:
    """ball_cover_types.hpp BallCoverIndex parity."""

    dataset: torch.Tensor     # (n, dim) f32
    landmarks: torch.Tensor   # (n_landmarks, dim)
    row_ids: torch.Tensor     # (n_landmarks, max_ball) int32, -1 pad
    radii: torch.Tensor       # (n_landmarks,) ball radius (metric units)
    metric: DistanceType

    @property
    def n(self) -> int:
        return int(self.dataset.shape[0])

    @property
    def n_landmarks(self) -> int:
        return int(self.landmarks.shape[0])


def build_index(dataset, metric="haversine", n_landmarks: int = 0, seed: int = 0,
                device=None) -> BallCoverIndex:
    """Sample sqrt(n) landmarks, group points by nearest landmark
    (ball_cover.cuh build_index)."""
    from raft_tpu_torch.neighbors.ivf_flat import _pack_lists

    x = check_matrix(dataset, device=device, dtype=torch.float32, name="dataset").contiguous()
    n = x.shape[0]
    m = resolve_metric(metric)
    k = n_landmarks or max(1, int(np.sqrt(n)))
    sel = np.random.default_rng(seed).choice(n, k, replace=False)
    landmarks = x[torch.as_tensor(sel, device=x.device)]
    labels = torch.empty((n,), dtype=torch.int64, device=x.device)
    dmin = torch.empty((n,), dtype=torch.float32, device=x.device)
    bm = max(1, min(n, BLOCK_BUDGET_BYTES // (4 * k)))
    for s in range(0, n, bm):
        d = _pairwise_impl(x[s:s + bm], landmarks, m)
        dmin[s:s + bm], labels[s:s + bm] = torch.min(d, dim=1)
    radii = torch.zeros((k,), dtype=torch.float32, device=x.device)
    radii.scatter_reduce_(0, labels, dmin, "amax", include_self=False)
    row_ids, _ = _pack_lists(labels, k)
    return BallCoverIndex(x, landmarks, row_ids, radii, m)


# metrics whose (root-domain) values satisfy the triangle inequality, the
# precondition of ball pruning; the others probe every ball (exact,
# unpruned)
_TRIANGLE_METRICS = frozenset({
    DistanceType.Haversine,
    DistanceType.L2Expanded,
    DistanceType.L2SqrtExpanded,
    DistanceType.L2Unexpanded,
    DistanceType.L2SqrtUnexpanded,
    DistanceType.L1,
    DistanceType.Linf,
})

_SQUARED_METRICS = (DistanceType.L2Expanded, DistanceType.L2Unexpanded)


def _root_domain(index: BallCoverIndex, d: torch.Tensor) -> torch.Tensor:
    """Squared-euclidean values compare as their square roots; true
    metrics pass through."""
    if index.metric in _SQUARED_METRICS:
        return torch.sqrt(torch.clamp(d, min=0.0))
    return d


def _landmark_lower_bounds(index: BallCoverIndex, q: torch.Tensor) -> torch.Tensor:
    """Root-domain lb(q, l) = d(q, landmark_l) - radius_l. The squared
    metrics take the landmark distances in the UNEXPANDED form (no norm
    cancellation; L rows only), as the JAX package does."""
    m = index.metric
    if m in _SQUARED_METRICS:
        ld = _pairwise_impl(q, index.landmarks, DistanceType.L2Unexpanded)
    else:
        ld = _pairwise_impl(q, index.landmarks, m)
    return _root_domain(index, ld) - _root_domain(index, index.radii)[None, :]


class _Rows:
    """Per-row terms of the dataset that the candidate formulas gather
    instead of recomputing (the same values either way), and each ball's
    member count."""

    def __init__(self, index: BallCoverIndex):
        self.data = index.dataset
        m = index.metric
        D = DistanceType
        self.norm_sq = None
        self.cos_lat = None
        if m in (D.L2Expanded, D.L2SqrtExpanded, D.CosineExpanded):
            self.norm_sq = torch.sum(self.data * self.data, dim=1)
        if m == D.Haversine:
            self.cos_lat = torch.cos(self.data[:, 0])
        self.ball_sizes = torch.sum(index.row_ids >= 0, dim=1)
        self.sorted_sizes = torch.sort(self.ball_sizes, descending=True).values.cpu()

    def widest(self, p: int) -> int:
        """The most candidates p balls can hold (an upper bound on any
        query's candidate row count)."""
        return max(1, int(self.sorted_sizes[:p].sum()))


def _batched_scores(metric: DistanceType, q: torch.Tensor, rows: _Rows,
                    c: torch.Tensor):
    """(nq, C) distances of each query to its own candidate rows `c` (valid
    ids, (nq, C) int64) with `_pairwise_impl`'s formula, or None for a
    metric without a batched form."""
    D = DistanceType
    cd = rows.data[c]  # (nq, C, dim)
    if metric in (D.L2Expanded, D.L2SqrtExpanded, D.CosineExpanded):
        dot = torch.sum(cd * q[:, None, :], dim=-1)
        qn = torch.sum(q * q, dim=1)[:, None]
        cn = rows.norm_sq[c]
        if metric == D.CosineExpanded:
            return 1.0 - dot / torch.clamp(torch.sqrt(qn) * torch.sqrt(cn), min=_TINY)
        out = torch.clamp(qn + cn - 2.0 * dot, min=0.0)
        return torch.sqrt(out) if metric == D.L2SqrtExpanded else out
    if metric == D.Haversine:
        lat1, lon1 = q[:, 0:1], q[:, 1:2]
        sdlat = torch.sin(0.5 * (cd[:, :, 0] - lat1))
        sdlon = _sin_half_dlon(lon1, cd[:, :, 1])
        h = sdlat ** 2 + torch.cos(lat1) * rows.cos_lat[c] * sdlon ** 2
        return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(h, 0.0, 1.0)))
    diff = cd - q[:, None, :]
    if metric == D.L1:
        return torch.sum(torch.abs(diff), dim=-1)
    if metric == D.Linf:
        return torch.amax(torch.abs(diff), dim=-1)
    if metric in (D.L2Unexpanded, D.L2SqrtUnexpanded):
        s = torch.sum(diff * diff, dim=-1)
        return torch.sqrt(s) if metric == D.L2SqrtUnexpanded else s
    return None


def _candidates(index: BallCoverIndex, rows: _Rows, probes: torch.Tensor) -> torch.Tensor:
    """(nq, W) int32 candidate ids: the members of each query's probed
    balls, ball after ball in probe order (the order of the JAX package's
    `row_ids[probes]`, its -1 slots dropped), padded with -1 to the
    block's widest query."""
    nq, p = probes.shape
    sz = rows.ball_sizes[probes]  # (nq, p)
    end = torch.cumsum(sz, dim=1)
    total = end[:, -1:]
    W = max(1, int(torch.max(total)))  # host sync (1 scalar)
    j = torch.arange(W, device=probes.device).expand(nq, W).contiguous()
    slot = torch.clamp(torch.searchsorted(end, j, right=True), max=p - 1)
    member = j - torch.gather(end - sz, 1, slot)
    ball = torch.gather(probes, 1, slot)
    cand = index.row_ids[ball, torch.clamp(member, max=index.row_ids.shape[1] - 1)]
    return torch.where(j < total, cand, -1)


def _probe_exact(index: BallCoverIndex, rows: _Rows, q: torch.Tensor, lb: torch.Tensor,
                 p: int, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Score the p balls with the smallest lower bound per query, exactly.
    Returns (vals, int32 ids) of the per-query top-k over those
    candidates: -1 / +inf past a query's candidates."""
    _, probes = _select_k_impl(lb, p, True)  # (nq, p)
    cand = _candidates(index, rows, probes)
    valid = cand >= 0
    c = torch.clamp(cand, min=0).long()
    d = _batched_scores(index.metric, q, rows, c)
    if d is None:
        d = torch.stack([_pairwise_impl(q[i:i + 1], rows.data[c[i]], index.metric)[0]
                         for i in range(q.shape[0])])
    d = torch.where(valid, d, float("inf"))
    kk = min(k, cand.shape[1])
    v, pos = _select_k_impl(d, kk, True)
    ids = torch.gather(cand, 1, pos)
    if kk < k:  # fewer candidates than k: pad the tail (callers mask -1)
        v = torch.nn.functional.pad(v, (0, k - kk), value=float("inf"))
        ids = torch.nn.functional.pad(ids, (0, k - kk), value=-1)
    return v, ids


def _query_rows(index: BallCoverIndex, rows: _Rows, p: int) -> int:
    """Queries per block: the block's candidate rows, their ids and
    scores within the budget."""
    width = rows.widest(p) * (index.dataset.shape[1] + 4) * 4
    return max(1, BLOCK_BUDGET_BYTES // width)


def _first_probes(index: BallCoverIndex, k: int, n_probes: int) -> int:
    """The balls a query probes first: `n_probes` when given, every ball
    for a metric without the triangle inequality, else p1."""
    L = index.n_landmarks
    if n_probes > 0:
        return min(n_probes, L)
    if index.metric not in _TRIANGLE_METRICS:
        return L
    return min(L, max(32, k))


def _query_block(index: BallCoverIndex, rows: _Rows, q: torch.Tensor, k: int,
                 n_probes: int) -> Tuple[torch.Tensor, torch.Tensor]:
    L = index.n_landmarks
    lb = _landmark_lower_bounds(index, q)
    p1 = _first_probes(index, k, n_probes)
    v1, ids1 = _probe_exact(index, rows, q, lb, p1, k)
    if n_probes > 0 or index.metric not in _TRIANGLE_METRICS:
        return v1, ids1
    # slack sized to the expanded engine's f32 error class (the bound and
    # the build's radii both come from it), the JAX package's
    bound = _root_domain(index, v1[:, k - 1])
    survives = lb <= (bound * (1.0 + 4e-3) + 1e-6)[:, None]
    counts = torch.sum(survives, dim=1)
    needed = int(torch.max(counts))  # host sync (1 scalar)
    if needed <= p1:
        return v1, ids1
    # pass 2, for the queries whose surviving balls outnumber p1 (a
    # query with at most p1 survivors probed all of them: they are the
    # smallest lower bounds), each at its own power of two p2 <= L
    p2_of = torch.clamp(torch.exp2(torch.ceil(torch.log2(counts.double() / p1))) * p1, max=L)
    p2_of = torch.where(counts > p1, p2_of.long(), 0)
    for p2 in torch.unique(p2_of[p2_of > 0]).tolist():
        rows_p2 = torch.nonzero(p2_of == p2)[:, 0]
        qs, lbs = q[rows_p2], lb[rows_p2]
        v, i = _blocked(lambda s, e: _probe_exact(index, rows, qs[s:e], lbs[s:e], int(p2), k),
                        rows_p2.numel(), _query_rows(index, rows, int(p2)), k, q.device)
        v1[rows_p2], ids1[rows_p2] = v, i
    return v1, ids1


def _blocked(fn, nq: int, step: int, k: int, dev):
    """fn(start, end) -> (vals, ids) over blocks of `step` queries."""
    if step >= nq:
        return fn(0, nq)
    vals = torch.empty((nq, k), dtype=torch.float32, device=dev)
    ids = torch.empty((nq, k), dtype=torch.int32, device=dev)
    for s in range(0, nq, step):
        vals[s:s + step], ids[s:s + step] = fn(s, s + step)
    return vals, ids


def knn_query(index: BallCoverIndex, queries, k: int, n_probes: int = 0
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN via two-pass triangle-inequality ball pruning
    (ball_cover.cuh knn_query): ((nq, k) f32 distances, (nq, k) int32
    ids), best-first. n_probes=0 (default): exact. n_probes>0: the
    fixed-probe approximate mode (that many closest-by-lower-bound balls,
    no second pass). Queries go to the index's device."""
    q = as_tensor(queries, index.dataset.device, torch.float32)
    dev = q.device
    if q.shape[0] == 0:
        return (torch.zeros((0, k), dtype=torch.float32, device=dev),
                torch.full((0, k), -1, dtype=torch.int32, device=dev))
    q = q.reshape(q.shape[0], -1).contiguous()
    rows = _Rows(index)
    return _blocked(lambda s, e: _query_block(index, rows, q[s:e], k, n_probes),
                    q.shape[0], _query_rows(index, rows, _first_probes(index, k, n_probes)),
                    k, dev)


def all_knn_query(index: BallCoverIndex, k: int, n_probes: int = 0):
    """k-NN of every indexed point (ball_cover.cuh all_knn_query)."""
    return knn_query(index, index.dataset, k, n_probes)


def eps_nn_query(index: BallCoverIndex, queries, eps: float):
    """Range query via the same ball structure: (boolean adjacency (m, n),
    int32 degrees)."""
    from raft_tpu_torch.neighbors.epsilon_neighborhood import eps_neighbors

    return eps_neighbors(queries, index.dataset, eps, metric=index.metric,
                         device=index.dataset.device)
