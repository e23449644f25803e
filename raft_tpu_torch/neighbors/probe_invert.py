"""Probe-pair inversion for the list-major IVF search (counterpart of
raft_tpu/neighbors/probe_invert.py).

The list-major engine inverts the (query, list) probe pairs into per-list
buckets, so each probed list is streamed once per batch rather than once
per probing query. Each bucket splits into chunks of `chunk` pairs; the
chunk tables say which list each chunk scores and which queries it holds,
and every original pair keeps its (chunk, slot) address, so candidates
regroup to query-major order with a gather.

The chunk count is the same static bound the JAX package uses
(sum(ceil(c_i / chunk)) <= P // chunk + n_lists). A chunk's live pairs
are its leading slots; `chunk_live_rows` counts them, so the fused kernel
skips pad rows and the empty chunks past the populated ones
(`chunk_validity` is the JAX package's per-chunk flag). The sort-based
construction is ported; the counting one and the one-hot query-row impls
are still to be ported. `score_and_select` is the back half of the
engines that materialize their scores (IVF-Flat's "list" engine).

Adaptive probing (neighbors/probe_budget) hands the inversion a
(nq, n_probes) keep mask, `pvalid`: masked pairs move to the sentinel
list `n_lists`, so they fill no chunk (fewer live rows, and chunks that
empty out skip in-kernel), and `regroup_merge` reads their candidates as
the worst value with row -1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class ChunkTables(NamedTuple):
    """Chunk tables for one query batch.

    lof      (ncb,)         list id scored by each chunk (int32)
    qid_tbl  (ncb, chunk)   query ids in each chunk; `nq` marks padding
                            (callers append a zero sentinel query row)
    g0       (nq*n_probes,) chunk holding each original probe pair
    s0       (nq*n_probes,) slot of that pair within its chunk
    pair_valid (nq*n_probes,) bool, or None when every pair is live:
             False pairs were dropped before the inversion (their g0 and
             s0 read 0, and `regroup_merge` masks what they address)
    """

    lof: torch.Tensor
    qid_tbl: torch.Tensor
    g0: torch.Tensor
    s0: torch.Tensor
    pair_valid: Optional[torch.Tensor] = None


def chunk_count(nq: int, n_probes: int, n_lists: int, chunk: int) -> int:
    """Upper bound on the number of chunks for a batch."""
    return (nq * n_probes) // chunk + n_lists


def _chunk_geometry(counts: torch.Tensor, nq: int, n_probes: int, n_lists: int,
                    chunk: int):
    """Per-list chunk spans and per-chunk (list, in-list position,
    validity) tables from per-list pair counts: (base, lof, cl, pos,
    valid)."""
    dev = counts.device
    cpl = (counts + chunk - 1) // chunk  # chunks per list
    cb = torch.cumsum(cpl, 0)  # inclusive
    base = cb - cpl  # first chunk id of each list
    ncb = chunk_count(nq, n_probes, n_lists, chunk)
    g = torch.arange(ncb, device=dev, dtype=cb.dtype)
    lof = torch.clamp(torch.searchsorted(cb, g, right=True), max=n_lists - 1)
    cl = g - base[lof]
    pos = cl[:, None] * chunk + torch.arange(chunk, device=dev)[None, :]
    valid = pos < counts[lof][:, None]
    return base, lof, cl, pos, valid


def invert_probes_sort(probes: torch.Tensor, n_lists: int, chunk: int,
                       pvalid: Optional[torch.Tensor] = None) -> ChunkTables:
    """Sort-based construction: a stable sort of the P = nq*n_probes pairs
    by list (pairs of one list keep query order), and its inverse
    permutation for the regroup addresses. Pairs masked out by `pvalid`
    ((nq, n_probes) bool) sort into the sentinel list `n_lists`, past
    every real list, and count toward no chunk."""
    nq, n_probes = probes.shape
    p_total = nq * n_probes
    dev = probes.device
    flat = probes.reshape(-1).long()
    pv = None
    if pvalid is not None:
        pv = pvalid.reshape(-1).to(device=dev, dtype=torch.bool)
        flat = torch.where(pv, flat, n_lists)
    sorted_lists, order = torch.sort(flat, stable=True)
    sorted_q = order // n_probes
    lids = torch.arange(n_lists, device=dev)
    starts = torch.searchsorted(sorted_lists, lids)
    ends = torch.searchsorted(sorted_lists, lids, right=True)
    counts = ends - starts
    base, lof, _, pos, valid = _chunk_geometry(counts, nq, n_probes, n_lists, chunk)
    pair = torch.clamp(starts[lof][:, None] + pos, 0, p_total - 1)
    qid_tbl = torch.where(valid, sorted_q[pair], nq)

    inv = torch.empty_like(order)
    inv[order] = torch.arange(p_total, device=dev)  # original pair -> sorted position
    lst = torch.clamp(flat, max=n_lists - 1)
    pos0 = inv - starts[lst]
    g0 = base[lst] + pos0 // chunk
    s0 = pos0 % chunk
    if pv is not None:
        g0 = torch.where(pv, g0, 0)
        s0 = torch.where(pv, s0, 0)
    return ChunkTables(lof.to(torch.int32), qid_tbl, g0, s0, pv)


def gather_query_rows(q_pad: torch.Tensor, qids: torch.Tensor) -> torch.Tensor:
    """(..., chunk, dim) query rows from a (..., chunk) id table over the
    sentinel-padded (nq+1, dim) query matrix (the JAX package's "gather"
    impl; its one-hot impls are still to be ported)."""
    return q_pad[qids]


def chunk_validity(qid_tbl: torch.Tensor, nq: int) -> torch.Tensor:
    """(ncb,) int32 flag per chunk: 1 when the chunk holds at least one
    live pair, 0 when every slot is padding (`nq`)."""
    return torch.any(qid_tbl != nq, dim=1).to(torch.int32)


def chunk_live_rows(qid_tbl: torch.Tensor, nq: int) -> torch.Tensor:
    """(ncb,) int32 count of each chunk's live pairs. They are the chunk's
    leading slots (a list's pairs fill its chunks from the front), so the
    fused kernel skips the rows past the count; 0 marks an empty chunk."""
    return torch.sum(qid_tbl != nq, dim=1, dtype=torch.int32)


def regroup_merge(tables: ChunkTables, vals: torch.Tensor, rows: torch.Tensor,
                  select_k_fn, nq: int, n_probes: int, k: int, select_min: bool):
    """Regroup per-chunk candidates (ncb, chunk, kk) to query-major order
    through the (g0, s0) pair addresses and merge exactly: each query's
    n_probes*kk candidates, in probe order, go through `select_k_fn`.
    Pairs the keep mask dropped (`tables.pair_valid` False) give the
    worst value and row -1, like a prefilter's short tail."""
    kk = vals.shape[-1]
    cand_v = vals[tables.g0, tables.s0]
    cand_r = rows[tables.g0, tables.s0]
    if tables.pair_valid is not None:
        m = tables.pair_valid[:, None]
        cand_v = torch.where(m, cand_v, float("inf") if select_min else float("-inf"))
        cand_r = torch.where(m, cand_r, -1)
    cand_v = cand_v.reshape(nq, n_probes * kk)
    cand_r = cand_r.reshape(nq, n_probes * kk)
    v, pos2 = select_k_fn(cand_v, k, select_min)
    return v, torch.gather(cand_r, 1, pos2)


#: materialized scores a superblock of `score_and_select` may hold
SCORE_BUDGET = 1 << 27


def score_and_select(tables: ChunkTables, block_fn, slot_rows: torch.Tensor, select_k_fn,
                     nq: int, n_probes: int, k: int, select_min: bool, chunk: int,
                     max_list: int):
    """The back half of a list-major search: score superblocks of chunks
    (at most SCORE_BUDGET scores each, whatever the list length), trim each
    chunk row to its best min(k, max_list) with `select_k_fn`, gather
    their slot rows, then `regroup_merge`.

    `block_fn(lof_block, qid_block) -> (b, chunk, max_list)` scores a
    block of chunks with invalid slots already at the worst value. The
    trim is exact: the JAX package trims with `lax.approx_min_k` at
    recall_target 0.99, which its CPU backend computes exactly. The JAX
    package's `chunk_block` knob (a tuned key) is left out: one batched
    call scores a whole superblock, its untuned default."""
    lof, qid_tbl = tables.lof, tables.qid_tbl
    ncb = lof.shape[0]
    kk = min(int(k), int(max_list))
    sb = max(1, min(ncb, SCORE_BUDGET // max(1, chunk * max_list)))
    vals, rows = [], []
    for s in range(0, ncb, sb):
        lofs = lof[s:s + sb]
        scores = block_fn(lofs, qid_tbl[s:s + sb])
        v, si = select_k_fn(scores, kk, select_min)
        srows = slot_rows[lofs.long()][:, None, :].expand(-1, scores.shape[1], -1)
        vals.append(v)
        rows.append(torch.gather(srows, 2, si))
    return regroup_merge(tables, torch.cat(vals), torch.cat(rows), select_k_fn, nq, n_probes,
                         k, select_min)


def macro_batched(search_slice_fn, queries: torch.Tensor, k: int, mb: int = 4096,
                  extra=None):
    """Run a list-major search over macro-batches of at most `mb` queries,
    bounding the chunk tables and score buffers per call.

    PyTorch does not recompile per shape, so slices run at their own size
    (the JAX package pads them up a power-of-two ladder to bound its
    compiled shapes). `extra`: an optional (nq, ...) per-query tensor, or
    a tuple of them (an adaptive plan: keep mask and probes), sliced with
    the queries and passed as the slice function's second argument."""
    nq_total = queries.shape[0]
    if nq_total == 0:
        return (torch.zeros((0, k), dtype=torch.float32, device=queries.device),
                torch.full((0, k), -1, dtype=torch.int32, device=queries.device))

    def rows(s):
        if isinstance(extra, tuple):
            return tuple(e[s:s + mb] for e in extra)
        return extra[s:s + mb]

    outs = [search_slice_fn(queries[s:s + mb]) if extra is None
            else search_slice_fn(queries[s:s + mb], rows(s))
            for s in range(0, nq_total, mb)]
    if len(outs) == 1:
        return outs[0]
    return torch.cat([v for v, _ in outs]), torch.cat([r for _, r in outs])
