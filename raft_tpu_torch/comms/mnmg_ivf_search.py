"""Distributed IVF-Flat / IVF-PQ searches (counterpart of
raft_tpu/comms/mnmg_ivf_search.py): per-rank engines run by `Comms.run`,
the exact refine, prefilters, degraded mode with replica failover, and
the replicated / query-sharded merges.

Every rank runs the port's single-device engine on its own blocks
(`ivf_pq._search_impl*`, `ivf_flat._search_impl*`) with the slot table
holding global ids, so the engines' ids are global; then the local top-k
merge. On the card the engines reach the list kernels (`fused_list_topk`,
`fused_list_topk_int8`, `pq_list_scan`) and the counting select where the
tuned table promotes it. The derived stores (the int8 reconstruction,
the bf16 residuals, the padded gid views, the refine layout) are built in
the calling thread before the ranks run, never inside a rank's body."""

from __future__ import annotations

import warnings

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import faults
from raft_tpu_torch.core.config import strict_f32_matmul
from raft_tpu_torch.comms.comms import P, op_t
from raft_tpu_torch.comms.mnmg_common import (
    _local_layout, _map_blocks, _mask_dead_rank, _pack_local, _pack_result, _pad_queries,
    _rank_layout, _replicated_filter_bits, _resolve_health, _rows, _shard_filtered,
    _shard_rows, rank_captured,
)
from raft_tpu_torch.comms.mnmg_merge import (
    _merge_local_topk, _merge_local_topk_scatter, _resolve_query_mode,
)
from raft_tpu_torch.comms.mnmg_ivf_build import DistributedIvfFlat, DistributedIvfPq
from raft_tpu_torch.distance.distance_types import DistanceType
from raft_tpu_torch.matrix.select_k import _select_k_impl


def _gid_view(index, width: int):
    """The index's slot gids padded with -1 to `width` slots, kept as
    `index.slot_gids_pad` (the gid view of a padded derived store; a gid
    transform drops it, and it rebuilds here from the current gids)."""
    g = index.slot_gids_pad
    if g is None or int(g.shape[2]) != width:
        extra = width - int(index.slot_gids.shape[2])
        g = index.slot_gids if extra == 0 else _map_blocks(
            lambda b: torch.nn.functional.pad(b, (0, extra), value=-1), index.slot_gids)
        index.slot_gids_pad = g
    return g


def _build_distributed_recon(index: DistributedIvfPq, pad_to_lanes: bool = False) -> None:
    """Per-rank int8 reconstruction stores of the list-major engine,
    decoded from each rank's codes (once; the distributed
    build_reconstruction). With `pad_to_lanes` the slot axis pads to the
    list kernels' 128-slot contract (recon_norm +inf, slot gids -1 on the
    pad slots, masked like in-list padding); once padded, the store stays
    padded. `index.slot_gids_pad` is kept width-matched to the store."""
    base = int(index.codes.shape[2])
    if index.recon8 is None or int(index.recon8.shape[2]) < base:
        from raft_tpu_torch.neighbors.ivf_pq import PER_CLUSTER, _decode_quantize

        per_cluster = index.params.codebook_kind == PER_CLUSTER
        pqc = index.pq_centers

        def decode(codes):
            r8, scale, rnorm = _decode_quantize(codes[0], pqc.on(codes.device), per_cluster)
            return r8[None], scale, rnorm[None]

        recon8, scales, recon_norm = _map_blocks(decode, index.codes)
        index.recon8, index.recon_norm = recon8, recon_norm
        # the scale is a function of the replicated codebooks: one per
        # rank, all equal
        index.recon_scale = index.comms.replicate(scales.blocks[0])
    if pad_to_lanes:
        _pad_distributed_recon(index, base)
    _gid_view(index, int(index.recon8.shape[2]))


def _pad_distributed_recon(index: DistributedIvfPq, base: int) -> None:
    """Pad the sharded reconstruction store's slot axis to the list
    kernels' contract (and the gid view with it); a no-op when already
    wide enough."""
    from raft_tpu_torch.ops.pq_list_scan import lane_padded

    extra = lane_padded(base) - int(index.recon8.shape[2])
    if extra <= 0:
        return
    pad = torch.nn.functional.pad
    index.recon8 = _map_blocks(lambda b: pad(b, (0, 0, 0, extra)), index.recon8)
    index.recon_norm = _map_blocks(lambda b: pad(b, (0, extra), value=float("inf")),
                                   index.recon_norm)
    _gid_view(index, int(index.recon8.shape[2]))


def _refine_layout(index, refine_dataset, allow_extended: bool = False):
    """Sharded original rows and per-rank (base, valid) of the distributed
    refine: rank j owns caller ids [base_j, base_j + valid_j), and row l of
    its dataset shard holds caller id base_j + l, in the driver layout
    (contiguous global rows) and the *_local layout alike.

    The layout (with the sharded copy of the dataset) is cached on the
    index by the dataset object's identity, so a serving loop that passes
    the same array ships nothing again. Single-controller only: in a
    process world one process's identity hit would let it skip the layout
    collectives another still enters, so those calls always recompute.
    `index.clear_refine_cache()` releases the pinned copy."""
    comms = index.comms
    cacheable = not comms.spans_processes()
    cache = getattr(index, "_refine_cache", None)
    if cacheable and cache is not None and cache[0] is refine_dataset:
        return cache[1], cache[2], cache[3]
    if getattr(index, "bridged", False):
        raise ValueError(
            "refine_dataset needs gids that index the dataset rows: "
            "bridged (distribute_index) layouts may carry arbitrary "
            "caller ids — refine on the single-chip index instead")
    if getattr(index, "extended", False):
        # the post-merge refine: ownership follows this layout's
        # contiguous sharding, which needs the full-dataset layout
        if not allow_extended or index.host_gids is None:
            raise ValueError(
                "refine on an extended index runs post-merge over the "
                "FULL dataset layout (driver-built indexes do this "
                "automatically); *_local-extended layouts are "
                "unsupported — rebuild to refine")
    if index.host_gids is not None:  # driver build: the full dataset
        x = _rows(refine_dataset)
        if x.shape[0] != index.n:
            raise ValueError(f"refine_dataset has {x.shape[0]} rows, index holds {index.n}")
        xs, n, per = _shard_rows(comms, x)
        base = per * np.arange(comms.get_size(), dtype=np.int64)
        valid = np.clip(n - base, 0, per)
    else:  # *_local build: this process's partition (collective)
        local = _rows(refine_dataset)
        counts, per, lranks = _local_layout(comms, local.shape[0])
        if int(counts.sum()) != index.n:
            raise ValueError(f"refine_dataset partitions sum to {int(counts.sum())} rows, "
                             f"index holds {index.n}")
        xp, _ = _pack_local(local, per, lranks)
        xs = comms.shard_from_local(xp, axis=0)
        base, valid = _rank_layout(comms, counts, per)
    if cacheable:
        index._refine_cache = (refine_dataset, xs, base, valid)
    return xs, base, valid


def _exact_scores(q, rows, metric):
    """Exact (nq, kk) scores of gathered candidate rows (nq, kk, d)."""
    strict_f32_matmul()
    if metric == DistanceType.InnerProduct:
        return torch.einsum("qd,qkd->qk", q, rows)
    diff = q[:, None, :] - rows
    exact = torch.sum(diff * diff, dim=2)
    if metric == DistanceType.L2SqrtExpanded:
        exact = torch.sqrt(torch.clamp(exact, min=0.0))
    return exact


def _owned_rows(gid, xs, base, valid, rank):
    """(own mask, gathered rows) of the candidates this rank's dataset
    shard holds."""
    local = gid.long() - int(base[rank])
    own = (gid >= 0) & (local >= 0) & (local < int(valid[rank]))
    return own, xs[local.clamp(0, xs.shape[0] - 1)]


def _refine_local(q, gid, xs, base, valid, rank, metric, worst):
    """Exact per-rank re-rank: every candidate a rank reports came from
    its own lists, so its original row is in the rank's dataset shard (the
    distributed neighbors/refine.cuh, with no gathers across ranks). The
    PQ scores are dropped; the gids alone drive the gather."""
    own, rows = _owned_rows(gid, xs, base, valid, rank)
    exact = _exact_scores(q, rows, metric)
    return (torch.where(own, exact, torch.full_like(exact, worst)),
            torch.where(own, gid, torch.full_like(gid, -1)))


def _refine_merged(ac, q, mgid, xs, base, valid, rank, metric, worst, k, select_min):
    """Exact re-rank after the merge (inside a rank's body): ownership
    follows the refine dataset's contiguous sharding, not the index's list
    placement, so it refines layouts whose per-rank gids are not one
    contiguous range (extended indexes). Owners contribute exact scores,
    the others the worst value, and one MIN / MAX allreduce of the (nq,
    kk) shortlist assembles the exact scores on every rank; -1 merge pads
    have no owner and sort last."""
    own, rows = _owned_rows(mgid, xs, base, valid, rank)
    exact = _exact_scores(q, rows, metric)
    contrib = torch.where(own, exact, torch.full_like(exact, worst))
    combined = ac.allreduce(contrib, op_t.MIN if select_min else op_t.MAX)
    fv, fp = _select_k_impl(combined, min(k, combined.shape[1]), select_min)
    return fv, torch.gather(mgid, 1, fp)


def _plan_args(ap, q, centers, n_probes: int, k: int, metric, label: str,
               rotation=None):
    """The adaptive plan of a distributed search: the centers (and the
    rotation) are replicated, so one host-side plan is every rank's
    (bounds stay off: the radii are per-rank state). Returns (keep,
    probes) or (None, None) and the scanned-list mean the cost charges."""
    from raft_tpu_torch.neighbors import probe_budget

    if ap is None:
        return (None, None), None
    plan = probe_budget.search_plan(ap, q, centers, n_probes=n_probes, k=int(k), metric=metric,
                                    rotation=rotation)
    scanned_mean = probe_budget.account_plan(label, plan, int(q.shape[0]), n_probes)
    return (plan if plan is not None else (None, None)), scanned_mean


def _pad_plan(plan, nq_pad: int):
    """Pad an adaptive plan to the sharded mode's padded queries: pad rows
    scan nothing."""
    keep, probes = plan
    if keep is None or keep.shape[0] == nq_pad:
        return plan
    extra = nq_pad - keep.shape[0]
    return (torch.cat([keep, keep.new_zeros((extra, keep.shape[1]))]),
            torch.cat([probes, probes.new_zeros((extra, probes.shape[1]))]))


def _plan_of(keep, probes):
    return None if keep is None else (keep, probes)


@rank_captured("mnmg.ivf_pq_search")
@obs.spanned("mnmg.ivf_pq_search")
def ivf_pq_search(index: DistributedIvfPq, queries, k: int, n_probes: int = 20,
                  engine: str = "auto", refine_dataset=None,
                  refine_mult: int = 4, prefilter=None,
                  query_mode: str = "auto", trim_engine: str = "approx",
                  score_dtype: str = "bf16", health=None,
                  adaptive: bool = False, recall_target=None,
                  budget_tau=None, min_probes: int = 1,
                  quantization: str = "auto"):
    """SPMD search: every rank scores its local lists for the same global
    probes; the local top-k merge on every rank ("replicated") or go to
    per-rank query blocks ("sharded", R x less merge traffic; "auto":
    `_resolve_query_mode`). Both return the full (nq, k) result (values
    f32, ids int32) on rank 0's device.

    `engine`: "recon8_list" (the list-major int8-reconstruction engine:
    each rank streams each probed list once), "lut" (query-major, for
    small batches), or "auto" (the single-device duplication rule; the
    tuned `pq_auto_engine` where the table governs the ranks' device).
    With "recon8_list", `trim_engine="pallas"` runs the bin-fold list
    kernel per rank, `trim_engine="fused"` the exact fused scan+select
    (with score_dtype="int8" the int8 kernel), and `score_dtype="int8"`
    scores with symmetric int8 queries, as the single-device SearchParams.

    `refine_dataset` enables the high-recall pipeline: each rank keeps a
    `refine_mult * k` shortlist (at most 256) of its PQ scores, re-ranks
    its own candidates exactly against the original rows (no gathers
    across ranks) and the exact scores merge. Pass the full dataset for
    driver-built indexes, or this process's partition for *_local-built
    ones. Extended driver-built indexes refine after the merge instead
    (`_refine_merged`: one MIN / MAX allreduce of the exact scores) and
    return the replicated layout (an explicit "sharded" warns);
    *_local-extended layouts cannot refine.

    `prefilter` (a core.Bitset or boolean mask over the global id space,
    `index.id_bound` ids; the same on every process) excludes samples
    before the trim on every rank.

    `health` (resilience.RankHealth) enables degraded mode: unhealthy
    ranks' candidates leave the merge and the return becomes a
    `DegradedSearchResult(values, ids, coverage)`. On an index with r-way
    replicas, unhealthy ranks with a surviving holder fail over instead:
    the answer stays the all-healthy one bit for bit at coverage 1.0 and
    the ranks appear in `repaired_ranks`. Degraded masks are refused with
    the post-merge refine of extended indexes.

    `quantization` selects the replicated merge's wire transport
    (comms/quantized): "off" is the exact merge, "int8" / "bf16" ship
    block-quantized candidate scores and re-rank the survivors on exact
    values; "auto" is exact until a tuned `comms_quant_mode` governs the
    ranks' device."""
    from raft_tpu_torch.comms import quantized
    from raft_tpu_torch.comms.replication import failover_view
    from raft_tpu_torch.core import tuned
    from raft_tpu_torch.neighbors import ivf_pq as pq
    from raft_tpu_torch.neighbors import probe_budget
    from raft_tpu_torch.neighbors.probe_invert import macro_batched, resolve_setup_impls

    index, health, repaired = failover_view(index, health)
    comms = index.comms
    dev = comms.device
    qcfg = quantized.resolve(quantization, dev)
    q = _rows(queries).to(dev)
    metric = index.params.metric
    select_min = metric != DistanceType.InnerProduct
    worst = float("inf") if select_min else float("-inf")
    n_lists = int(index.params.n_lists)
    n_probes = int(min(n_probes, n_lists))
    per_cluster = index.params.codebook_kind == pq.PER_CLUSTER
    ap = probe_budget.resolve(n_probes, adaptive=adaptive, recall_target=recall_target,
                              budget_tau=budget_tau, min_probes=min_probes, early_term=False,
                              device=dev)
    plan, scanned_mean = _plan_args(ap, q, index.centers.on(dev), n_probes, k,
                                    metric, "mnmg.ivf_pq", rotation=index.rotation.on(dev))
    refine_merged = refine_dataset is not None and bool(getattr(index, "extended", False))
    mode = _resolve_query_mode(query_mode, comms, q.shape[0], k)
    if refine_merged:
        if query_mode == "sharded":
            warnings.warn(
                "query_mode='sharded' is incompatible with refined search "
                "on an extended index (post-merge refine reduces across "
                "ranks per query); returning the REPLICATED layout",
                stacklevel=2)
        mode = "replicated"
    if refine_merged and health is not None and health.degraded:
        raise ValueError(
            "degraded-mode refine on an extended index is unsupported: "
            "post-merge exact scores come from the refine dataset's "
            "contiguous owners, and a dead owner cannot score its rows — "
            "search without refine_dataset, or rehydrate first")
    live_rep, mode, coverage = _resolve_health(comms, health, query_mode, mode)
    nq = q.shape[0]
    if mode == "sharded":
        q, nq = _pad_queries(q, comms.get_size())
        plan = _pad_plan(plan, q.shape[0])
    merge = _merge_local_topk if mode == "replicated" else _merge_local_topk_scatter
    out_spec = P(None, None) if mode == "replicated" else P(comms.axis, None)

    if engine == "auto":
        if score_dtype == "int8" or trim_engine in ("pallas", "fused"):
            # an explicit int8, bin-trim or fused-trim request pins the
            # engine that honors it
            engine = "recon8_list"
        else:
            t = tuned.get("pq_auto_engine") if tuned.applies(dev) else None
            if t in ("recon8_list", "lut"):
                engine = t
            else:
                dup = q.shape[0] * n_probes / max(1, n_lists)
                engine = "recon8_list" if dup >= 4.0 else "lut"
    if engine not in ("recon8_list", "lut"):
        raise ValueError(f"unknown engine {engine!r}")
    if obs.enabled():
        # charged after the engine resolves: the list-major engine streams
        # every padded slot on every rank, lut the probed lists
        obs.span_cost(**obs.perf.cost_for(
            "mnmg.ivf_pq_search", nq=int(q.shape[0]), n_probes=n_probes, n_lists=n_lists,
            n_rows=int(index.codes.shape[0] * index.codes.shape[1] * index.codes.shape[2]),
            dim=int(index.centers.shape[-1]), pq_dim=int(index.codes.shape[-1]), k=int(k),
            dtype=score_dtype,
            scanned_lists=(n_lists if engine == "recon8_list" and trim_engine != "fused"
                           else (scanned_mean if scanned_mean is not None else n_probes))))
    pf_bits, pf_n = _replicated_filter_bits(comms, prefilter, index.id_bound)
    use_pf = prefilter is not None
    refine = refine_dataset is not None
    if refine:
        xs_r, base_r, valid_r = _refine_layout(index, refine_dataset,
                                               allow_extended=refine_merged)
        # a shortlist never narrower than k, at most 256 gathered rows
        kk = int(max(k, min(max(refine_mult, 1) * k, 256)))
    else:
        xs_r, base_r, valid_r = None, None, None
        kk = int(k)
    base_t = None if base_r is None else tuple(int(b) for b in base_r)
    valid_t = None if valid_r is None else tuple(int(v) for v in valid_r)

    def finish(ac, v, gid, q, xs, live):
        rank = ac.get_rank()
        if refine_merged:
            v = faults.corrupt_in_trace("mnmg.ivf_pq.scores", v, rank)
            v = torch.where(gid >= 0, v, torch.full_like(v, worst))
            # the merged shortlist as wide as the pre-merge refine's total
            # exact depth (r ranks x kk each, the same 256 cap), never
            # narrower than kk
            kk_merged = min(comms.get_size() * kk, max(256, kk))
            _, mgid = merge(ac, v, gid, kk_merged, select_min, quant=qcfg)
            return _refine_merged(ac, q, mgid, xs, base_t, valid_t, rank, metric, worst, k,
                                  select_min)
        if refine:
            v, gid = _refine_local(q, gid, xs, base_t, valid_t, rank, metric, worst)
        else:
            v = torch.where(gid >= 0, v, torch.full_like(v, worst))
        # after the local refine: the site models the shard's reported
        # scores (the refine discards the PQ scores)
        v = faults.corrupt_in_trace("mnmg.ivf_pq.scores", v, rank)
        v, gid = _mask_dead_rank(v, gid, live, rank, worst)
        return merge(ac, v, gid, k, select_min, quant=qcfg)

    if trim_engine not in ("approx", "pallas", "fused"):
        raise ValueError(f"unknown trim_engine {trim_engine!r}")
    for eng_req in ("pallas", "fused"):
        if trim_engine == eng_req and engine != "recon8_list":
            raise ValueError(f"trim_engine='{eng_req}' requires engine='recon8_list'")
    if score_dtype not in ("bf16", "int8"):
        raise ValueError(f"unknown score_dtype {score_dtype!r}")
    if score_dtype == "int8" and engine != "recon8_list":
        raise ValueError("score_dtype='int8' requires engine='recon8_list'")
    int8_q = score_dtype == "int8"
    keep, probes = plan
    common = (q, xs_r, pf_bits, live_rep, keep, probes)
    common_specs = (P(), P(comms.axis), P(), P(), P(), P())

    def run(body, args, specs):
        v, gid = comms.run(body, *args, *common, in_specs=tuple(specs) + common_specs,
                           out_specs=(out_spec, out_spec))
        return _pack_result(v, gid, nq, coverage, repaired)

    if engine == "recon8_list":
        from raft_tpu_torch.ops.pq_list_scan import _BINS, fits_pq_list_scan, lane_padded

        use_pallas = trim_engine == "pallas"
        use_fused = trim_engine == "fused"
        lpad = lane_padded(int(index.codes.shape[2]))
        rot_dim = int(index.rotation.shape[0])
        fused_kb = None
        if use_pallas:
            if kk > _BINS:
                raise ValueError(f"trim_engine='pallas' caps per-list candidates at {_BINS}; "
                                 f"k={kk}")
            if not fits_pq_list_scan(lpad, rot_dim, int8_q):
                raise ValueError(
                    f"trim_engine='pallas': list length {lpad} exceeds the kernel's "
                    "shared-memory budget; use trim_engine='approx'")
        if use_fused:
            from raft_tpu_torch.matrix.select_k import check_fused_list_request

            fused_kb = check_fused_list_request(
                "trim_engine='fused'", lpad, rot_dim, int(kk), index.fused_kb,
                "trim_engine='approx'", q_int8=int8_q)
            index.fused_kb = fused_kb  # monotone candidate-buffer bookkeeping
        _build_distributed_recon(index, pad_to_lanes=use_pallas or use_fused)
        setup = resolve_setup_impls(n_lists, device=dev)
        fold = chunk = None
        if use_pallas:
            from raft_tpu_torch.ops.pq_list_scan import fold_variant

            fold = fold_variant(dev)
        elif not use_fused:
            chunk = pq.resolve_listmajor_chunk(q.shape[0], n_probes, n_lists, dev)

        def body(ac, rotation, centers, recon8, scale, rnorm, gid_tbl, q, xs, bits, live,
                 keep, probes):
            srows = _shard_filtered(gid_tbl[0], bits, pf_n, use_pf)
            args = (rotation, centers, recon8[0], scale, rnorm[0], srows, kk, n_probes,
                    metric)
            if use_fused:
                def search(sl, pl=None):
                    return pq._search_impl_recon8_listmajor_fused(
                        sl, *args, kb=fused_kb, int8_queries=int8_q, plan=pl,
                        setup_impls=setup)
            elif use_pallas:
                def search(sl, pl=None):
                    return pq._search_impl_recon8_listmajor_pallas(
                        sl, *args, int8_queries=int8_q, fold=fold, plan=pl, setup_impls=setup)
            else:
                def search(sl, pl=None):
                    return pq._search_impl_recon8_listmajor(
                        sl, *args, chunk=chunk, int8_queries=int8_q, plan=pl,
                        setup_impls=setup)
            v, gid = macro_batched(search, q, kk, extra=_plan_of(keep, probes))
            return finish(ac, v, gid, q, xs, live)

        return run(body, (index.rotation, index.centers, index.recon8, index.recon_scale,
                          index.recon_norm, index.slot_gids_pad),
                   (P(), P(), P(comms.axis), P(), P(comms.axis), P(comms.axis)))

    def body_lut(ac, rotation, centers, pq_centers, codes, gid_tbl, q, xs, bits, live, keep,
                 probes):
        srows = _shard_filtered(gid_tbl[0], bits, pf_n, use_pf)
        v, gid = pq._search_impl(q, rotation, centers, pq_centers, codes[0], srows, kk,
                                 n_probes, metric, per_cluster, plan=_plan_of(keep, probes))
        return finish(ac, v, gid, q, xs, live)

    return run(body_lut, (index.rotation, index.centers, index.pq_centers, index.codes,
                          index.slot_gids),
               (P(), P(), P(), P(comms.axis), P(comms.axis)))


def _build_distributed_resid(index: DistributedIvfFlat, k: int) -> None:
    """The per-rank derived store of the distributed fused engine (the
    IVF-Flat analogue of `_build_distributed_recon`): lane-padded bf16
    per-slot residuals v - center and their f32 squared norms, exact zero
    with gid -1 on the pad slots (the single-device `_pad_store_to_lanes`
    derivation). `index.fused_kb` records the candidate-buffer width and
    grows when `k` outruns it (never a silent per-list truncation)."""
    from raft_tpu_torch.ops.fused_scan import fused_kbuf
    from raft_tpu_torch.ops.pq_list_scan import lane_padded

    base = int(index.list_data.shape[2])
    lpad = lane_padded(base)
    if index.resid_bf16 is None or int(index.resid_bf16.shape[2]) != lpad:
        pad = torch.nn.functional.pad
        cen = index.centers

        def derive(ld, sg):
            ld = pad(ld, (0, 0, 0, lpad - base))
            sg = pad(sg, (0, lpad - base), value=-1)
            resid = ld.float() - cen.on(ld.device)[None, :, None, :]
            resid = torch.where((sg >= 0)[..., None], resid, 0.0)
            return resid.to(torch.bfloat16), torch.sum(resid * resid, dim=3)

        index.resid_bf16, index.resid_norm = _map_blocks(derive, index.list_data,
                                                         index.slot_gids)
    _gid_view(index, lpad)
    kb = fused_kbuf(int(k))
    if getattr(index, "fused_kb", None) is None or kb > index.fused_kb:
        index.fused_kb = kb


@rank_captured("mnmg.ivf_flat_search")
@obs.spanned("mnmg.ivf_flat_search")
def ivf_flat_search(index: DistributedIvfFlat, queries, k: int, n_probes: int = 20,
                    prefilter=None, query_mode: str = "auto",
                    engine: str = "auto", health=None,
                    adaptive: bool = False, recall_target=None,
                    budget_tau=None, min_probes: int = 1,
                    quantization: str = "auto"):
    """SPMD search: every rank scans its local lists for the same global
    probes; the local top-k merge on every rank ("replicated") or go to
    per-rank query blocks ("sharded"; `_resolve_query_mode`). `engine`:
    "query" (query-major, small batches), "list" (list-major: each rank
    streams each probed list once; the serving engine), or "pallas" (the
    fused distance + select-k kernel per rank over lane-padded bf16
    residual stores: exact within the probed lists up to bf16 rounding);
    "auto" is the single-device policy, where a tuned fused winner maps to
    "list" (the distributed fused engine is an explicit opt-in). The
    list-major engines run the default ("sort", "gather") setup: the tuned
    `invert_impl` / `listmajor_qs_impl` do not reach the distributed flat
    search, as in the JAX package. `prefilter`, `health` (with replica
    failover) and `quantization` as in `ivf_pq_search`."""
    from raft_tpu_torch.comms import quantized
    from raft_tpu_torch.comms.replication import failover_view
    from raft_tpu_torch.neighbors import ivf_flat as flat
    from raft_tpu_torch.neighbors import probe_budget
    from raft_tpu_torch.neighbors.probe_invert import macro_batched

    index, health, repaired = failover_view(index, health)
    comms = index.comms
    dev = comms.device
    qcfg = quantized.resolve(quantization, dev)
    qh = _rows(queries).to(dev)
    metric = index.params.metric
    select_min = metric != DistanceType.InnerProduct
    worst = float("inf") if select_min else float("-inf")
    n_lists = int(index.params.n_lists)
    n_probes = int(min(n_probes, n_lists))
    pf_bits, pf_n = _replicated_filter_bits(comms, prefilter, index.id_bound)
    use_pf = prefilter is not None
    if engine == "auto":
        engine = flat.resolve_auto_engine(qh.shape[0], n_probes, n_lists, pallas_ok=None,
                                          device=dev)
    if engine not in ("query", "list", "pallas"):
        raise ValueError(f"unknown engine {engine!r} (distributed ivf_flat "
                         "supports 'query', 'list', 'pallas', 'auto')")
    ap = probe_budget.resolve(n_probes, adaptive=adaptive, recall_target=recall_target,
                              budget_tau=budget_tau, min_probes=min_probes, early_term=False,
                              device=dev)
    plan, scanned_mean = _plan_args(ap, qh, index.centers.on(dev), n_probes, k, metric,
                                    "mnmg.ivf_flat")
    if obs.enabled():
        obs.span_cost(**obs.perf.cost_for(
            "mnmg.ivf_flat_search", nq=int(qh.shape[0]), n_probes=n_probes, n_lists=n_lists,
            n_rows=int(index.list_data.shape[0] * index.list_data.shape[1]
                       * index.list_data.shape[2]),
            dim=int(index.list_data.shape[-1]), k=int(k),
            scanned_lists=(n_lists if engine == "list"
                           else (scanned_mean if scanned_mean is not None else n_probes))))
    mode = _resolve_query_mode(query_mode, comms, qh.shape[0], int(k))
    live_rep, mode, coverage = _resolve_health(comms, health, query_mode, mode)
    nq = qh.shape[0]
    if mode == "sharded":
        qh, nq = _pad_queries(qh, comms.get_size())
        plan = _pad_plan(plan, qh.shape[0])
    merge = _merge_local_topk if mode == "replicated" else _merge_local_topk_scatter
    out_spec = P(None, None) if mode == "replicated" else P(comms.axis, None)
    keep, probes = plan
    setup = ("sort", "gather")

    def finish(ac, v, gid, live):
        rank = ac.get_rank()
        v = faults.corrupt_in_trace("mnmg.ivf_flat.scores", v, rank)
        v = torch.where(gid >= 0, v, torch.full_like(v, worst))
        v, gid = _mask_dead_rank(v, gid, live, rank, worst)
        return merge(ac, v, gid, k, select_min, quant=qcfg)

    if engine == "pallas":
        from raft_tpu_torch.ops.fused_scan import FUSED_MAX_K, fits_fused_list, fused_kbuf
        from raft_tpu_torch.ops.pq_list_scan import lane_padded

        if int(k) > FUSED_MAX_K:
            raise ValueError(f"engine='pallas' caps per-list candidates at {FUSED_MAX_K}; "
                             f"k={k}")
        d = int(index.list_data.shape[-1])
        lpad = lane_padded(int(index.list_data.shape[2]))
        # at the width the kernel will run with (a larger earlier k grew it)
        kb_run = max(fused_kbuf(int(k)), getattr(index, "fused_kb", None) or 0)
        if not fits_fused_list(lpad, d, int(k), kbuf=kb_run):
            raise ValueError(
                f"engine='pallas': padded list length {lpad} x dim {d} "
                "exceeds the kernel's shared-memory budget; use engine='list'")
        _build_distributed_resid(index, int(k))
        kb = int(index.fused_kb)

        def body(ac, resid, rnorm, gid_tbl, centers, q, bits, live, keep, probes):
            srows = _shard_filtered(gid_tbl[0], bits, pf_n, use_pf)
            v, gid = macro_batched(
                lambda sl, pl=None: flat._search_impl_listmajor_pallas(
                    sl, centers, resid[0], rnorm[0], srows, k, n_probes, metric, kb=kb,
                    plan=pl, setup_impls=setup),
                q, k, flat.MACRO_BATCH, extra=_plan_of(keep, probes))
            return finish(ac, v, gid, live)

        args = (index.resid_bf16, index.resid_norm, index.slot_gids_pad)
    else:
        def body(ac, ld, gid_tbl, centers, q, bits, live, keep, probes):
            srows = _shard_filtered(gid_tbl[0], bits, pf_n, use_pf)
            if engine == "query":
                v, gid = flat._search_impl(q, centers, ld[0], srows, k, n_probes, metric,
                                           plan=_plan_of(keep, probes))
            else:
                v, gid = macro_batched(
                    lambda sl, pl=None: flat._search_impl_listmajor(
                        sl, centers, ld[0], srows, k, n_probes, metric, plan=pl,
                        setup_impls=setup),
                    q, k, flat.MACRO_BATCH, extra=_plan_of(keep, probes))
            return finish(ac, v, gid, live)

        args = (index.list_data, index.slot_gids)
    specs = (P(comms.axis),) * len(args) + (P(),) * 6
    v, gid = comms.run(body, *args, index.centers, qh, pf_bits, live_rep, keep, probes,
                       in_specs=specs, out_specs=(out_spec, out_spec))
    return _pack_result(v, gid, nq, coverage, repaired)
