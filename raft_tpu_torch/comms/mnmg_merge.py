"""Top-k merge schedules and query-mode (merge-topology) resolution for
the distributed searches (counterpart of raft_tpu/comms/mnmg_merge.py):
one packed plane a collective, allgather against the log-depth butterfly
tournament, and the query-sharded all_to_all merge."""

from __future__ import annotations

import torch

from raft_tpu_torch.comms.comms import AxisComms, Comms
from raft_tpu_torch.matrix.select_k import _select_k_impl


def _pack_vi(v, ids):
    """One (nq, 2*kk) f32 plane carrying scores and the bits of the int32
    ids (`.view`), so a merge moves both in a single collective. No
    arithmetic ever touches the id lanes: they are only viewed back."""
    return torch.cat([v.float(), ids.to(torch.int32).contiguous().view(torch.float32)], -1)


def _unpack_ids(plane):
    return plane.contiguous().view(torch.int32)


def _merge_local_topk(ac: AxisComms, v, ids, k: int, select_min: bool, quant=None):
    """Merge the ranks' local top-k candidates into the global top-k on
    every rank (the knn_merge_parts pattern). `ids` are global, invalid
    entries at the worst value. Inside a run body.

    Power-of-two full-axis comms may take the log-depth butterfly
    tournament (`_replicated_merge_schedule`); the rest take the
    allgather merge. `quant` (a resolved `quantized.QuantConfig`) routes
    full-axis merges through the quantized candidate exchange; split comms
    stay exact."""
    if quant is not None and ac.groups is None and ac.size > 1:
        from raft_tpu_torch.comms import quantized

        return quantized.exchange_candidates(ac, v, ids, k, select_min, quant)
    if (ac.groups is None and ac.size > 1
            and (ac.size & (ac.size - 1)) == 0
            and _replicated_merge_schedule(ac._c().device) == "tournament"):
        return _merge_local_topk_tournament(ac, v, ids, k, select_min)
    return _merge_local_topk_allgather(ac, v, ids, k, select_min)


def _replicated_merge_schedule(device=None) -> str:
    """Which replicated merge to run (both are bit-exact; an engine
    choice). The JAX package runs the tournament on a TPU and the
    allgather elsewhere; the port keeps the allgather unless the tuned
    `mnmg_replicated_merge_schedule` governs the ranks' device
    (`tuned.applies`). The port commits no value: an in-process world on
    one card moves no bytes over a wire, so no A/B there decides it."""
    from raft_tpu_torch.core import tuned

    if tuned.applies(device):
        t = tuned.get("mnmg_replicated_merge_schedule")
        if t in ("tournament", "allgather"):
            return t
    return "allgather"


def _merge_local_topk_allgather(ac: AxisComms, v, ids, k: int, select_min: bool):
    """Flat merge: one packed allgather, rank-major interleave, one wide
    select (the tournament's bit-exactness oracle)."""
    kk = v.shape[-1]
    g = ac.allgather(_pack_vi(v, ids)[None], axis=0)  # (R, 1, nq, 2*kk)
    r_ = g.shape[0]
    cat = torch.movedim(g.reshape(r_, -1, 2 * kk), 0, 1)  # (nq, R, 2*kk)
    cat_v = cat[..., :kk].reshape(-1, r_ * kk)
    cat_i = _unpack_ids(cat[..., kk:]).reshape(-1, r_ * kk)
    mv, mp = _select_k_impl(cat_v, min(k, r_ * kk), select_min)
    return mv, torch.gather(cat_i, 1, mp)


def _merge_local_topk_tournament(ac: AxisComms, v, ids, k: int, select_min: bool):
    """Butterfly (recursive-halving) merge: log2(R) permutation rounds,
    each exchanging this rank's candidates with its XOR partner and
    re-selecting top-min(k, 2w); every rank converges to the same global
    top-k. Candidates carry their rank-major global position, interior
    rounds restore position order after each select, and the stable
    select breaks value ties by position as one flat rank-major select
    would: bit-compatible with the allgather merge."""
    r_ = ac.size
    kk = v.shape[-1]
    me = ac._axis_index()
    pos0 = me * kk + torch.arange(kk, dtype=torch.int32, device=v.device)
    cur_v = v.float()
    cur_i = ids.to(torch.int32)
    cur_p = pos0.expand(v.shape).contiguous()
    d = 1
    while d < r_:
        w = cur_v.shape[-1]
        packed = torch.cat([cur_v, cur_i.view(torch.float32), cur_p.view(torch.float32)], -1)
        other = ac._ppermute(packed, [(i, i ^ d) for i in range(r_)])
        ov = other[..., :w]
        oi = _unpack_ids(other[..., w:2 * w])
        op = _unpack_ids(other[..., 2 * w:])
        if (me & d) == 0:  # keep global position order in the cat
            cat_v, cat_i, cat_p = (torch.cat([cur_v, ov], -1), torch.cat([cur_i, oi], -1),
                                   torch.cat([cur_p, op], -1))
        else:
            cat_v, cat_i, cat_p = (torch.cat([ov, cur_v], -1), torch.cat([oi, cur_i], -1),
                                   torch.cat([op, cur_p], -1))
        w2 = min(k, 2 * w)
        mv, mp = _select_k_impl(cat_v, w2, select_min)
        mi = torch.gather(cat_i, -1, mp)
        mpos = torch.gather(cat_p, -1, mp)
        d *= 2
        if d < r_:
            # interior round: back to position order so the next round's
            # stable select tie-breaks like the flat merge
            order = torch.argsort(mpos, dim=-1)
            mv = torch.gather(mv, -1, order)
            mi = torch.gather(mi, -1, order)
            mpos = torch.gather(mpos, -1, order)
        cur_v, cur_i, cur_p = mv, mi, mpos
    return cur_v, cur_i


def _merge_local_topk_scatter(ac: AxisComms, v, ids, k: int, select_min: bool, quant=None):
    """Query-sharded merge (the high-QPS serving topology): one all_to_all
    of the packed plane routes each query block's candidates to its
    owning rank, which re-selects locally. Returns this rank's (nq/R, k')
    block (out spec P(axis)). nq divides by the comm size (callers pad).
    `quant` is accepted for signature parity and ignored, as in the JAX
    package."""
    kk = v.shape[-1]
    r_ = ac.get_size()
    t = ac._all_to_all(_pack_vi(v, ids), 0)
    nq_blk = v.shape[0] // r_
    cat = torch.movedim(t.reshape(r_, nq_blk, 2 * kk), 0, 1)  # (nq_blk, R, 2*kk)
    cat_v = cat[..., :kk].reshape(nq_blk, r_ * kk)
    cat_i = _unpack_ids(cat[..., kk:]).reshape(nq_blk, r_ * kk)
    mv, mp = _select_k_impl(cat_v, min(k, r_ * kk), select_min)
    return mv, torch.gather(cat_i, 1, mp)


def _resolve_query_mode(query_mode: str, comms: Comms, nq: int, k: int) -> str:
    """Pick the merge topology: "replicated" merges on every rank (full
    results everywhere), "sharded" routes each query block to one rank
    (R x less merge traffic). "auto" flips to sharded only at nq >=
    `mnmg_query_sharded_min_nq` (4096) and nq >= k x
    `mnmg_query_sharded_min_nq_per_k` (64), the JAX defaults; tuned values
    govern CUDA worlds only (`tuned.applies`). Stays replicated on a
    world that spans processes, where every process reads the full
    result."""
    if query_mode in ("replicated", "sharded"):
        return query_mode
    if query_mode != "auto":
        raise ValueError(f"unknown query_mode {query_mode!r}")
    if comms.spans_processes():
        return "replicated"
    from raft_tpu_torch.core import tuned

    min_nq, per_k = 4096, 64.0
    if tuned.applies(comms.device):
        min_nq = int(tuned.get("mnmg_query_sharded_min_nq", 4096))
        per_k = float(tuned.get("mnmg_query_sharded_min_nq_per_k", 64))
    return "sharded" if (nq >= min_nq and nq >= k * per_k) else "replicated"
