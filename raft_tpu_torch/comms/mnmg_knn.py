"""Distributed brute-force k-NN (counterpart of
raft_tpu/comms/mnmg_knn.py): a shard-local exact scan on every rank, then
the top-k merge (knn_merge_parts semantics), with prefilter, query-mode,
degraded-mode, replication and quantized-merge support.

Each rank's local scan is `neighbors.brute_force._bf_knn_impl` over its
rows, in 32,768-row tiles whose selects (and the merge's) go through
`matrix.select_k._select_k_impl`, so on the card they reach the counting
select kernel where the tuned table promotes it."""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import faults
from raft_tpu_torch.comms.comms import Comms, P
from raft_tpu_torch.distance.distance_types import DistanceType, resolve_metric
from raft_tpu_torch.comms.mnmg_common import (
    _cached_wrapper, _knn_prefilter_words, _local_layout, _mask_dead_rank,
    _pack_local, _pack_result, _pad_queries, _rank_layout, _ranks_by_proc,
    _resolve_health, _rows, _shard_rows, rank_captured, wrapper_key,
)
from raft_tpu_torch.comms.mnmg_merge import (
    _merge_local_topk, _merge_local_topk_scatter, _resolve_query_mode,
)


def _knn_sharded(comms: Comms, xs, queries, k: int, n_total: int, per: int,
                 rank_base: np.ndarray, valid_counts: np.ndarray, m,
                 pf_words=None, query_mode: str = "auto",
                 compute_dtype=None, health=None, replication: int = 1,
                 quantization: str = "auto"):
    """Shard-local exact k-NN + merge over an already-sharded dataset.
    `rank_base[j]` maps rank j's shard-local row i to caller id base + i;
    `valid_counts[j]` rows of rank j's shard are real (a prefix: pads are
    masked before selection). The one implementation behind knn() and
    knn_local(). With `replication` > 1, dead ranks' row blocks fail over
    losslessly from their ring holders before the degraded mask applies."""
    from raft_tpu_torch.neighbors.brute_force import _bf_knn_impl
    from raft_tpu_torch.core.bitset import Bitset
    from raft_tpu_torch.comms.replication import failover_sharded_rows
    from raft_tpu_torch.comms import quantized

    # resolved before the body cache: the hashable config is in its key
    qcfg = quantized.resolve(quantization, comms.device)

    xs, health, repaired = failover_sharded_rows(comms, xs, replication, health)
    select_min = m != DistanceType.InnerProduct
    worst = float("inf") if select_min else float("-inf")
    kk = int(min(k, per))
    qh = _rows(queries)
    mode = _resolve_query_mode(query_mode, comms, qh.shape[0], kk)
    live_rep, mode, coverage = _resolve_health(comms, health, query_mode, mode)
    nq = qh.shape[0]
    if mode == "sharded":
        qh, nq = _pad_queries(qh, comms.get_size())
    qr = comms.replicate(qh)
    filtered = pf_words is not None
    if not filtered:  # a 1-word placeholder keeps one body signature
        pf_words = np.zeros((comms.get_size(), 1), np.int32)
    if comms.spans_processes():
        lr = _ranks_by_proc(comms).get(comms.rank, [])
        bits_sh = comms.shard_from_local(np.asarray(pf_words)[lr], axis=0)
    else:
        bits_sh = comms.shard(np.asarray(pf_words), axis=0)
    out_k = min(k, n_total)

    def build():
        merge = _merge_local_topk if mode == "replicated" else _merge_local_topk_scatter
        out_spec = P(None, None) if mode == "replicated" else P(comms.axis, None)

        def body(ac, xs, qr, bits, live, base, valid, use_pf):
            rank = ac.get_rank()
            nv = int(valid[rank])
            pf = Bitset(bits[0], per) if use_pf else None
            if compute_dtype is not None:
                # the scan's operand dtype; distances stay f32 sums, so the
                # masking and the merge below are unchanged
                xs = xs.to(compute_dtype)
                qr = qr.to(compute_dtype)
            v, i = _bf_knn_impl(xs, qr, kk, m, n_valid=nv, prefilter=pf)
            v = faults.corrupt_in_trace("mnmg.knn.scores", v, rank)
            i = i.to(torch.int32)
            # i >= 0 drops the tiled path's init slots (-1), which would
            # otherwise map to base[rank] - 1, the previous shard's row
            keep = (i >= 0) & (i < nv)
            if use_pf:
                # with fewer than kk survivors, worst-scored slots may carry
                # a filtered row's index: re-test the ids against the bitset
                keep = keep & pf.test(i)
            gid = torch.where(keep, i + int(base[rank]), torch.full_like(i, -1))
            v = torch.where(keep, v, torch.full_like(v, worst))
            v, gid = _mask_dead_rank(v, gid, live, rank, worst)
            return merge(ac, v, gid, out_k, select_min, quant=qcfg)

        def run(xs, qr, bits, live, base, valid, use_pf):
            return comms.run(body, xs, qr, bits, live, base, valid, use_pf,
                             in_specs=(P(comms.axis, None), P(None, None),
                                       P(comms.axis, None), P(None), P(), P(), P()),
                             out_specs=(out_spec, out_spec))

        return run

    # every non-array closure input of the body, or the cache would
    # reuse a wrong body
    run = _cached_wrapper(
        wrapper_key(
            "knn_sharded", comms, mode, m, int(kk), int(out_k), int(per),
            None if compute_dtype is None else str(compute_dtype), qcfg),
        build,
    )
    v, gid = run(xs, qr, bits_sh, live_rep,
                 tuple(int(b) for b in rank_base), tuple(int(c) for c in valid_counts),
                 filtered)
    return _pack_result(v, gid, nq, coverage, repaired)


@rank_captured("mnmg.knn")
@obs.spanned("mnmg.knn")
def knn(
    comms: Comms,
    dataset,
    queries,
    k: int,
    metric="sqeuclidean",
    prefilter=None,
    query_mode: str = "auto",
    compute_dtype=None,
    health=None,
    replication: int = 1,
    quantization: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Shard-local exact k-NN + merge (the knn_merge_parts pattern, SURVEY
    §5.7): queries replicated, the dataset (host array or tensor) sharded
    by rows. `prefilter` (a core.Bitset or boolean mask over the dataset
    row ids) excludes rows before selection on every rank. `query_mode`
    picks the merge topology (`_resolve_query_mode`). `compute_dtype` is
    the per-shard scan's operand dtype (as `brute_force.knn`'s). `health`
    (resilience.RankHealth) enables degraded mode: unhealthy ranks' shards
    leave the merge and the return becomes a `DegradedSearchResult(values,
    ids, coverage)`. `replication` > 1 declares the r-way ring placement
    over the row blocks: up to r-1 dead ranks fail over losslessly (bit
    for bit, coverage 1.0, listed in `repaired_ranks`). `quantization`
    selects the merge's wire transport (comms/quantized): "off" is the
    exact merge, "int8" / "bf16" ship block-quantized candidate scores and
    re-rank survivors on exact values; "auto" is exact until a tuned
    `comms_quant_mode` governs the ranks' device. Returns (distances f32,
    int32 ids), each (nq, k), on rank 0's device."""
    m = resolve_metric(metric)
    x = _rows(dataset)
    xs, n, per = _shard_rows(comms, x)
    r = comms.get_size()
    rank_base = per * np.arange(r, dtype=np.int64)
    valid_counts = np.clip(n - rank_base, 0, per)
    pf_words = _knn_prefilter_words(prefilter, n, rank_base, valid_counts, per)
    if obs.enabled():
        obs.span_cost(**obs.perf.cost_for(
            "mnmg.knn", n=n, nq=int(queries.shape[0]), d=int(x.shape[1]),
            k=int(k), dtype=compute_dtype if compute_dtype is not None else "f32"))
    return _knn_sharded(comms, xs, queries, k, n, per, rank_base, valid_counts,
                        m, pf_words=pf_words, query_mode=query_mode,
                        compute_dtype=compute_dtype, health=health,
                        replication=replication, quantization=quantization)


def knn_local(
    comms: Comms,
    local_dataset,
    queries,
    k: int,
    metric="sqeuclidean",
    prefilter=None,
    query_mode: str = "auto",
    compute_dtype=None,
    health=None,
    replication: int = 1,
    quantization: str = "auto",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Distributed exact k-NN where each process contributes its own rows
    (collective). Queries are the same on every process; returned ids are
    caller row ids, positions in the process-order concatenation of the
    partitions. `prefilter`, `health` and `replication` cover that id
    space and are the same everywhere (see `knn`)."""
    m = resolve_metric(metric)
    local = _rows(local_dataset)
    counts, per, lranks = _local_layout(comms, local.shape[0])
    n = int(counts.sum())
    xp, _ = _pack_local(local, per, lranks)
    xs = comms.shard_from_local(xp, axis=0)
    rank_base, valid_counts = _rank_layout(comms, counts, per)
    pf_words = _knn_prefilter_words(prefilter, n, rank_base, valid_counts, per)
    return _knn_sharded(comms, xs, queries, k, n, per, rank_base, valid_counts,
                        m, pf_words=pf_words, query_mode=query_mode,
                        compute_dtype=compute_dtype, health=health,
                        replication=replication, quantization=quantization)
