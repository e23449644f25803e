"""Brute-force (exact) k-nearest neighbors (counterpart of
raft_tpu/neighbors/brute_force.py).

  "tiled"  stream the dataset in row tiles; each tile's (q, tile)
           distance block (`distance.pairwise._pairwise_impl`: every
           metric, the unexpanded ones through the `pairwise_tiled`
           kernel on the card) reduces to its top-k, merged into the
           running top-k of the earlier tiles (knn_merge_parts). Within a
           tile equal values keep the smaller id; in the merge the running
           queue comes first, so a tie across tiles keeps the earlier row;
  "fused"  the `fused_topk` kernel (ops/fused_scan.py, CUDA on the card)
           through `matrix.scan_select_k(strategy="fused")`: the (nq, n)
           score matrix never reaches device memory; exact over the
           bf16-rounded operands, ties to the smaller row id;
  "auto"   resolved through `matrix.select_k.resolve_scan_strategy`, as
           the JAX package does: "fused" where a tuned
           `select_k_strategy` = "fused" governs the queries' device
           (CUDA) and the kernel covers the metric and k, else "tiled".
           The tiled engine's per-tile selects follow select_k's tuned
           readers too (`_select_k_impl`).

`prefilter` (a `core.bitset.Bitset` or a boolean mask over the dataset
rows) excludes rows before selection on both engines: the tiled engine
masks their distances to the worst value, the fused one folds the mask
into the kernel's base row as +inf. The returned ids are tested against
the bitset afterwards, -1 where the bit is clear (fewer than k rows
pass); a row that passes keeps its id even where its distance is +inf.

`knn_merge_parts` merges per-part top-k results into a global top-k.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core.config import auto_convert_output
from raft_tpu_torch.core.resources import accepts_resources
from raft_tpu_torch.core.validation import as_tensor, check_matrix, check_same_cols
from raft_tpu_torch.distance.distance_types import (
    DistanceType,
    SIMILARITY_METRICS,
    resolve_metric,
)
from raft_tpu_torch.distance.pairwise import _pairwise_impl
from raft_tpu_torch.matrix.select_k import _select_k_impl

# database rows per tile in the tiled path
_TILE = 1 << 15


def _bf_knn_impl(dataset: torch.Tensor, queries: torch.Tensor, k: int,
                 metric: DistanceType, *, metric_arg: float = 2.0, tile: int = _TILE,
                 n_valid=None, prefilter=None):
    """`n_valid` (an int): rows at or past it are masked to the worst
    value before selection (a shard's pad rows must not displace true
    neighbors). `prefilter` (a Bitset over the dataset row ids) masks the
    rows whose bit is clear the same way."""
    n = dataset.shape[0]
    select_min = metric not in SIMILARITY_METRICS
    worst = float("inf") if select_min else float("-inf")
    if n <= max(2 * tile, 4 * k):
        d = _pairwise_impl(queries, dataset, metric, metric_arg=metric_arg)
        if n_valid is not None and n_valid < n:
            d = torch.where(torch.arange(n, device=d.device)[None, :] < n_valid, d, worst)
        if prefilter is not None:
            d = torch.where(prefilter.test(torch.arange(n, device=d.device))[None, :], d, worst)
        vals, idx = _select_k_impl(d, k, select_min)
        return vals, idx.to(torch.int32)
    q = queries.shape[0]
    best_v = torch.full((q, k), worst, dtype=torch.float32, device=queries.device)
    best_i = torch.full((q, k), -1, dtype=torch.int64, device=queries.device)
    for base in range(0, n, tile):
        d = _pairwise_impl(queries, dataset[base:base + tile], metric, metric_arg=metric_arg)
        if n_valid is not None and base + d.shape[1] > n_valid:
            col = torch.arange(base, base + d.shape[1], device=d.device)
            d = torch.where((col < n_valid)[None, :], d, worst)
        if prefilter is not None:
            col = torch.arange(base, base + d.shape[1], device=d.device)
            d = torch.where(prefilter.test(col)[None, :], d, worst)
        if d.shape[1] < tile:
            # the JAX scan pads the last tile with rows it masks to the
            # worst value before selection; so do its columns here
            d = torch.nn.functional.pad(d, (0, tile - d.shape[1]), value=worst)
        v, i = _select_k_impl(d, min(k, tile), select_min)
        mv, mi = _select_k_impl(torch.cat([best_v, v], 1), k, select_min)
        best_i = torch.gather(torch.cat([best_i, i + base], 1), 1, mi)
        best_v = mv
    return best_v, best_i.to(torch.int32)


@obs.spanned("neighbors.brute_force.knn")
@auto_convert_output
@accepts_resources
def knn(dataset, queries, k: int, metric="sqeuclidean", metric_arg: float = 2.0,
        resources=None, engine: str = "tiled", prefilter=None, compute_dtype=None,
        device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact k-NN: (distances, int32 indices), each (n_queries, k),
    best-first. `metric` is any pylibraft metric; `metric_arg` is the Lp
    exponent. `engine`: "tiled" (f32, every metric), "fused" (the fused
    kernel; L2/sqeuclidean/inner_product, k <= 256) or "auto".
    `compute_dtype` (tiled only): the operands are rounded to it before
    the distances, which stay f32 sums (torch.bfloat16 ranks the
    bf16-rounded points, as the JAX package's bf16 operands do).
    `prefilter`: a `core.bitset.Bitset` or 1-d boolean mask over the
    dataset rows; rows whose bit is clear are excluded before selection,
    and where fewer than k pass, the tail holds the worst distance with
    id -1."""
    q = check_matrix(queries, device=device, name="queries")
    ds = check_matrix(dataset, device=q.device, name="dataset")
    check_same_cols(ds, q, "dataset", "queries")
    if engine == "pallas":
        engine = "fused"  # one fused engine, two spellings
    if compute_dtype is not None:
        if engine == "fused":
            raise ValueError(
                "compute_dtype applies to engine='tiled' only "
                "(engine='pallas' already computes in bf16)"
            )
        ds, q = ds.to(compute_dtype), q.to(compute_dtype)
    if not (0 < k <= ds.shape[0]):
        raise ValueError(f"k={k} out of range for dataset with {ds.shape[0]} rows")
    m = resolve_metric(metric)
    if engine == "auto":
        from raft_tpu_torch.matrix.select_k import _fused_metric_kind, resolve_scan_strategy

        strat = resolve_scan_strategy(
            int(ds.shape[0]), int(ds.shape[1]), int(k), None,
            fused_ok=_fused_metric_kind(m) is not None and compute_dtype is None,
            device=q.device)
        engine = "fused" if strat == "fused" else "tiled"
    if engine not in ("tiled", "fused"):
        raise ValueError(f"unknown engine {engine!r}")
    if obs.enabled():
        # the fused engine never materializes the score matrix: charge
        # the fused geometry
        obs.span_cost(**obs.perf.cost_for(
            "neighbors.brute_force.knn", n=int(ds.shape[0]), nq=int(q.shape[0]),
            d=int(ds.shape[1]), k=int(k),
            dtype=torch.bfloat16 if engine == "fused" else ds.dtype,
            fused=engine == "fused"))
    pf = None
    if prefilter is not None:
        from raft_tpu_torch.core.bitset import as_bitset

        pf = as_bitset(prefilter, ds.shape[0], q.device)
    if engine == "fused":
        from raft_tpu_torch.matrix.select_k import scan_select_k

        valid = None if pf is None else pf.test(torch.arange(ds.shape[0], device=q.device))
        vals, idx = scan_select_k(q, ds, int(k), metric=m, strategy="fused", valid=valid,
                                  device=q.device)
    else:
        vals, idx = _bf_knn_impl(ds.float(), q.float(), int(k), m,
                                 metric_arg=float(metric_arg), prefilter=pf)
    if pf is not None:
        # the worst-scored tail of a row with fewer than k survivors can
        # carry a masked row's id: test the ids themselves (a test of the
        # score would also drop a survivor whose distance is +inf)
        idx = torch.where(pf.test(idx), idx, -1)
    return vals, idx


@obs.spanned("neighbors.brute_force.knn_merge_parts")
def knn_merge_parts(distances, indices, k=None, select_min: bool = True,
                    device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Merge per-part top-k results into a global top-k (the JAX
    package's `knn_merge_parts`): (n_parts, n_queries, k_part) stacks or
    (n_queries, n_parts * k_part) concatenations whose indices are
    already global. Equal values go to the earlier position (the earlier
    part); the ids keep the dtype of `indices`."""
    d = as_tensor(distances, device)
    i = as_tensor(indices, d.device)
    if d.ndim == 3:
        n_parts, n_q, kp = d.shape
        d = d.transpose(0, 1).reshape(n_q, n_parts * kp)
        i = i.transpose(0, 1).reshape(n_q, n_parts * kp)
    k = d.shape[1] if k is None else int(k)
    v, sel = _select_k_impl(d, k, bool(select_min))
    return v, torch.gather(i, 1, sel)
