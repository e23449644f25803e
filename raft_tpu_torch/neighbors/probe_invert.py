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
(`chunk_validity` is the JAX package's per-chunk flag). Two
constructions give the same tables bit for bit: "sort" (a stable sort and
its inverse permutation) and "count" (one stable sort for the query ids,
in-bucket ranks from blocked one-hot cumsums). Query rows come from a
gather or from one-hot matmuls ("onehot_bf16", "onehot_f32h"). The
`invert_impl`, `listmajor_qs_impl` and `listmajor_qs_impl_flat` tuned keys
choose among them (`resolve_setup_impls`; the table governs CUDA tensors
only), and a default call runs ("sort", "gather"). `score_and_select` is
the back half of the engines that materialize their scores (IVF-Flat's
"list" engine).

Adaptive probing (neighbors/probe_budget) hands the inversion a
(nq, n_probes) keep mask, `pvalid`: masked pairs move to the sentinel
list `n_lists`, so they fill no chunk (fewer live rows, and chunks that
empty out skip in-kernel), and `regroup_merge` reads their candidates as
the worst value with row -1.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from raft_tpu_torch.core import tuned


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


def invert_probes(probes: torch.Tensor, n_lists: int, chunk: int,
                  pvalid: Optional[torch.Tensor] = None) -> ChunkTables:
    """Chunk tables from a (nq, n_probes) probe matrix by the tuned
    construction (`resolve_invert_impl`); both give the same tables bit
    for bit. Engines resolve the impl once per search
    (`resolve_setup_impls`) and call the construction directly."""
    return invert_probes_with(resolve_invert_impl(n_lists, probes.device), probes, n_lists,
                              chunk, pvalid)


def invert_probes_with(impl: str, probes: torch.Tensor, n_lists: int, chunk: int,
                       pvalid: Optional[torch.Tensor] = None) -> ChunkTables:
    """Chunk tables by the named construction ("count", else "sort"): the
    engines call it with the `invert_impl` their search resolved."""
    if impl == "count":
        return invert_probes_count(probes, n_lists, chunk, pvalid)
    return invert_probes_sort(probes, n_lists, chunk, pvalid)


INVERT_IMPLS = ("sort", "count")

#: past this many lists the counting construction's (block, n_lists + 1)
#: planes stop being bounded by its block floor: "count" falls back to
#: "sort" whatever the table says
_COUNT_MAX_LISTS = 8192


def resolve_invert_impl(n_lists: int = 0, device=None) -> str:
    """The tuned chunk-table construction ("sort" unless the table, which
    governs CUDA tensors only, says "count" and n_lists <= 8192)."""
    impl = "sort"
    if tuned.applies(device):
        impl = tuned.get_choice("invert_impl", INVERT_IMPLS, "sort")
    if impl == "count" and n_lists > _COUNT_MAX_LISTS:
        return "sort"
    return impl


def resolve_setup_impls(n_lists: int, engine: str = "pq", device=None) -> tuple:
    """(invert_impl, qs_impl) of a list-major search, resolved once at the
    call site and passed down. `engine` ("pq" | "flat") keys the query-row
    impl: see `resolve_qs_impl` for the flat engines' bf16 gate."""
    return resolve_invert_impl(n_lists, device), resolve_qs_impl(engine, device)


def _blocked_bucket_ranks(flat: torch.Tensor, n_lists: int):
    """(stable rank of each pair within its list bucket, per-list counts)
    without a sort: blocks of pairs build their one-hot list membership,
    a cumsum down the block gives in-block ranks, and per-list totals
    carry across blocks. The block is the JAX package's,
    min(8192, max(256, 2^24 // (n_lists + 1))) pairs; the sentinel list
    `n_lists` (masked pairs and the pad) is the planes' last column."""
    p_total = flat.shape[0]
    dev = flat.device
    block = min(8192, max(256, (1 << 24) // (n_lists + 1)))
    cols = torch.arange(n_lists + 1, device=dev)
    carry = torch.zeros(n_lists + 1, dtype=torch.int64, device=dev)
    ranks = []
    for s in range(0, p_total, block):
        lb = flat[s:s + block]
        cs = torch.cumsum((lb[:, None] == cols[None, :]).to(torch.int32), dim=0)
        ranks.append(cs.gather(1, lb[:, None])[:, 0].long() - 1 + carry[lb])
        carry = carry + cs[-1]
    rank = torch.cat(ranks) if ranks else flat.new_zeros(0)
    return rank, carry[:n_lists]


def invert_probes_count(probes: torch.Tensor, n_lists: int, chunk: int,
                        pvalid: Optional[torch.Tensor] = None) -> ChunkTables:
    """Counting construction: the in-bucket ranks and per-list counts from
    `_blocked_bucket_ranks` replace the inverse permutation and the two
    searchsorted passes of `invert_probes_sort`; one stable sort of the
    pair lists carries the query ids, and each chunk reads its contiguous
    window of them. Stability makes each rank equal the sort's
    inv - starts[list], so the tables equal the sort's bit for bit,
    masked pairs (`pvalid` False, the sentinel list) included."""
    nq, n_probes = probes.shape
    p_total = nq * n_probes
    dev = probes.device
    flat = probes.reshape(-1).long()
    pv = None
    if pvalid is not None:
        pv = pvalid.reshape(-1).to(device=dev, dtype=torch.bool)
        flat = torch.where(pv, flat, n_lists)
    rank, counts = _blocked_bucket_ranks(flat, n_lists)
    starts = torch.cumsum(counts, 0) - counts
    base, lof, cl, _, valid = _chunk_geometry(counts, nq, n_probes, n_lists, chunk)

    _, order = torch.sort(flat, stable=True)
    sq_pad = torch.cat([order // n_probes, torch.full((chunk,), nq, device=dev,
                                                      dtype=order.dtype)])
    off = torch.clamp(starts[lof] + cl * chunk, 0, p_total)
    rows = sq_pad[off[:, None] + torch.arange(chunk, device=dev)[None, :]]
    qid_tbl = torch.where(valid, rows, nq)

    lst = torch.clamp(flat, max=n_lists - 1)
    g0 = base[lst] + rank // chunk
    s0 = rank % chunk
    if pv is not None:
        g0 = torch.where(pv, g0, 0)
        s0 = torch.where(pv, s0, 0)
    return ChunkTables(lof.to(torch.int32), qid_tbl, g0, s0, pv)


#: query-row materializations: "gather" (an index), "onehot_bf16" (a
#: one-hot matmul over bf16-rounded rows, f32 accumulation) and
#: "onehot_f32h" (the same in full f32, TF32 off: equal to the gather but
#: for -0.0, which reads +0.0, and rows holding a non-finite value, which
#: read NaN where 0 x inf enters the sum)
QS_IMPLS = ("gather", "onehot_bf16", "onehot_f32h")

#: bytes of the (rows, chunk, nq + 1) one-hot plane a sub-block may hold
_ONEHOT_PLANE_BYTES = 1 << 25


def gather_query_rows(q_pad: torch.Tensor, qids: torch.Tensor,
                      impl: str = "gather") -> torch.Tensor:
    """(..., chunk, dim) query rows from a (..., chunk) id table over the
    sentinel-padded (nq+1, dim) query matrix, by `impl` (`QS_IMPLS`).

    The one-hot impls bound the materialized one-hot plane to about 32 MB
    by taking sub-blocks of the leading rows, the JAX package's sub-block
    size; the rows come back in `q_pad`'s dtype."""
    if impl == "gather":
        return q_pad[qids]
    if impl == "onehot_bf16":
        dt = torch.bfloat16
    elif impl == "onehot_f32h":
        dt = torch.float32
    else:
        raise ValueError(f"unknown query-row impl {impl!r}")
    nq1, dim = q_pad.shape
    qp = q_pad.to(dt)
    cols = torch.arange(nq1, device=q_pad.device)
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        def onehot_rows(ids):
            oh = (ids[..., None] == cols).to(dt)
            # + 0.0: the sum starts from +0.0, as the JAX dot's does
            return torch.matmul(oh, qp).float() + 0.0

        lead = qids.shape[:-1]
        chunk = qids.shape[-1]
        rows_total = 1
        for s in lead:
            rows_total *= int(s)
        qb = max(1, _ONEHOT_PLANE_BYTES // max(1, chunk * nq1 * qp.element_size()))
        if not lead or rows_total <= qb:
            return onehot_rows(qids).to(q_pad.dtype)
        flat_ids = qids.reshape(rows_total, chunk)
        out = torch.cat([onehot_rows(flat_ids[s:s + qb]) for s in range(0, rows_total, qb)])
        return out.reshape(*lead, chunk, dim).to(q_pad.dtype)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def resolve_qs_impl(engine: str = "pq", device=None) -> str:
    """The tuned query-row impl of a list-major engine ("gather" where the
    table, which governs CUDA tensors only, has no value).

    `listmajor_qs_impl` is the PQ engines' key: bf16-rounded rows cost
    those nothing beside their int8 or bf16 scoring. The IVF-Flat and
    RaBitQ list-major engines take exact f32 rows, so for engine="flat" a
    shared "onehot_bf16" is gated back to "gather" unless the flat key
    `listmajor_qs_impl_flat` names an impl itself."""
    if not tuned.applies(device):
        return "gather"
    if engine == "flat":
        own = tuned.get_choice("listmajor_qs_impl_flat", QS_IMPLS, None)
        if own is not None:
            return own
        shared = tuned.get_choice("listmajor_qs_impl", QS_IMPLS, "gather")
        return "gather" if shared == "onehot_bf16" else shared
    return tuned.get_choice("listmajor_qs_impl", QS_IMPLS, "gather")


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
                     max_list: int, exact_trim: bool = False):
    """The back half of a list-major search: score superblocks of chunks
    (at most SCORE_BUDGET scores each, whatever the list length), trim each
    chunk row to its best min(k, max_list) with `select_k_fn`, gather
    their slot rows, then `regroup_merge`.

    `block_fn(lof_block, qid_block) -> (b, chunk, max_list)` scores a
    block of chunks with invalid slots already at the worst value. The
    trim is exact whatever `exact_trim` says: the JAX package trims with
    `lax.approx_min_k` at recall_target 0.99 unless `exact_trim`, and its
    CPU backend computes that exactly. The JAX
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
