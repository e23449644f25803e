"""Distributed IVF-RaBitQ (counterpart of raft_tpu/comms/mnmg_rabitq.py):
the driver build, the SPMD binary-code search with degraded mode and
lossless replica failover, and the exact refine.

The index shards like DistributedIvfPq (rank-major per-list tables over
the row shards), but the payload is the RaBitQ pair, packed sign codes
(int32 words, the JAX package's uint32 bits) and the two-scalar
correction table, and there is no codebook stage: the build is the
distributed coarse k-means and one SPMD encode pass.

- `health=` masks dead ranks before the merge and returns
  `DegradedSearchResult(coverage)`; on a `replication=` build surviving
  ring holders fail over bit for bit (codes, aux and slot tables are all
  mirrored).
- `refine_dataset` runs the exact per-rank re-rank
  (mnmg_ivf_search._refine_local).
- fault site "mnmg.ivf_rabitq.scores" poisons a shard's reported scores
  before the merge.
- `scan_engine` "fused" runs the bit-plane kernel (`fused_bitplane_topk`)
  per rank over the lane-padded, word-transposed store, derived once in
  the calling thread (`_build_distributed_bitplane`).
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import faults
from raft_tpu_torch.core.config import strict_f32_matmul
from raft_tpu_torch.comms.comms import Comms, P
from raft_tpu_torch.comms.mnmg_common import (
    _distributed_id_bound, _host_np, _map_blocks, _mask_dead_rank, _pack_result, _pad_queries,
    _replicated_filter_bits, _resolve_health, _rows, _shard_filtered, _shard_rows,
    rank_captured,
)
from raft_tpu_torch.comms.mnmg_merge import (
    _merge_local_topk, _merge_local_topk_scatter, _resolve_query_mode,
)
from raft_tpu_torch.comms.mnmg_ivf_build import (
    _maybe_replicate, _pack_rank_tables, _place_rank_major, _spmd_pack_rows,
)

SCORES_SITE = "mnmg.ivf_rabitq.scores"


class DistributedIvfRabitq:
    """Data-parallel IVF-RaBitQ: replicated rotation and centers, per-rank
    packed-code and correction tables over the local shard.

    codes (R, n_lists, max_list, W) int32 and aux (R, n_lists, max_list,
    2) f32 are sharded on axis 0; slot_gids holds global row ids (-1 pad).
    Host mirrors (`host_gids`, `list_sizes`) serve the checkpoint writer."""

    def __init__(self, comms, params, rotation, centers, codes, aux,
                 slot_gids, n, host_gids=None, list_sizes=None,
                 bridged: bool = False):
        self.comms = comms
        self.params = params
        self.rotation = rotation
        self.centers = centers
        self.codes = codes
        self.aux = aux
        self.slot_gids = slot_gids
        self.n = n
        self.host_gids = host_gids
        self.list_sizes = list_sizes
        self.bridged = bridged
        self.extended = False  # no distributed extend
        self.replicas = None  # see DistributedIvfFlat.replicas
        # the fused scan's derived store (_build_distributed_bitplane):
        # word-transposed lane-padded codes, per-slot estimator rows, the
        # padded gid table and the grown candidate-buffer width
        self.codes_t = None
        self.bp_meta = None
        self.slot_gids_pad = None
        self.fused_kb = None
        self._refine_cache = None
        self._id_bound = None

    @property
    def id_bound(self) -> int:
        """One past the largest global id a search can return: the id
        space a `prefilter` covers."""
        if self._id_bound is None:
            self._id_bound = _distributed_id_bound(self)
        return self._id_bound

    def clear_refine_cache(self) -> None:
        """Release the sharded dataset copy a refined search pinned."""
        self._refine_cache = None


def _spmd_label_encode_rabitq(comms: Comms, xs, rotation, centers, metric):
    """Label and RaBitQ-encode the sharded rows, each rank its own block.
    Returns sharded (labels (n,) int32, codes (n, W) int32, aux (n, 2))."""
    from raft_tpu_torch.neighbors.ivf_rabitq import label_and_encode

    def body(ac, xs, rotation, centers):
        labels, codes, aux = label_and_encode(xs, rotation, centers, metric)
        return labels.to(torch.int32), codes, aux

    return comms.run(body, xs, rotation, centers, in_specs=(P(comms.axis, None), P(), P()),
                     out_specs=(P(comms.axis), P(comms.axis, None), P(comms.axis, None)),
                     keep_blocks=True)


@obs.spanned("mnmg.ivf_rabitq_build")
def ivf_rabitq_build(comms: Comms, params, dataset, seed: int = 0,
                     replication: int = 1) -> DistributedIvfRabitq:
    """Distributed IVF-RaBitQ build: coarse centers by the distributed EM
    over the rotated trainset fraction, then one SPMD label + encode pass
    (no codebook stage). `replication` > 1 mirrors each rank's code,
    correction and slot tables onto its ring holders, so searches fail
    over losslessly through r-1 failures."""
    from raft_tpu_torch.comms.mnmg_ivf_build import _coarse_fit_rotated
    from raft_tpu_torch.neighbors import ivf_pq as ivf_pq_mod
    from raft_tpu_torch.neighbors.ivf_rabitq import ENCODE_SITE, rabitq_rot_dim
    from raft_tpu_torch.random.rng import make_generator

    strict_f32_matmul()
    x = _rows(dataset)
    n, d = x.shape
    if params.n_lists > n:
        raise ValueError(f"n_lists={params.n_lists} > dataset rows {n}")
    r = comms.get_size()
    per = -(-n // r)
    rotation = ivf_pq_mod._make_rotation(make_generator(seed, comms.device), rabitq_rot_dim(d),
                                         d, True)
    rot_rep = comms.replicate(rotation)
    rng = np.random.default_rng(seed)
    centers, _, _ = _coarse_fit_rotated(comms, params, x, rotation, rot_rep, rng, seed)
    # the encode site fires on the host, every build
    faults.fault_point(ENCODE_SITE, rank=comms.rank if comms.process_world else 0)
    xs, _, _ = _shard_rows(comms, x)
    cen_rep = comms.replicate(centers)
    labels_sh, codes_sh, aux_sh = _spmd_label_encode_rabitq(comms, xs, rot_rep, cen_rep,
                                                            params.metric)
    local_tbl, gids, sizes, _ = _pack_rank_tables(_host_np(labels_sh), n, per, r,
                                                  params.n_lists)
    tbl_sh = comms.shard(local_tbl, axis=0)
    codes = _spmd_pack_rows(comms, codes_sh, tbl_sh, per, torch.int32)
    aux = _spmd_pack_rows(comms, aux_sh, tbl_sh, per, torch.float32)
    return _maybe_replicate(DistributedIvfRabitq(
        comms, params, rot_rep, cen_rep, codes, aux, _place_rank_major(comms, gids), n,
        host_gids=gids, list_sizes=sizes), replication)


def _build_distributed_bitplane(index: DistributedIvfRabitq, k: int) -> None:
    """The per-rank derived store of the distributed fused bit-plane scan
    (the RaBitQ analogue of `_build_distributed_recon`): each rank's codes
    word-transposed to (1, n_lists, W, L) with the slot axis lane-padded,
    the (1, n_lists, 3, L) per-slot estimator rows and a width-matched
    padded gid table, through the single-device derivation
    (`ivf_rabitq.derive_bitplane_tables`). `index.fused_kb` grows
    monotonically."""
    from raft_tpu_torch.comms.mnmg_ivf_search import _gid_view
    from raft_tpu_torch.neighbors.ivf_rabitq import derive_bitplane_tables
    from raft_tpu_torch.ops.fused_scan import fused_kbuf
    from raft_tpu_torch.ops.pq_list_scan import lane_padded

    lpad = lane_padded(int(index.codes.shape[2]))
    if index.codes_t is None or int(index.codes_t.shape[3]) != lpad:
        index.codes_t, index.bp_meta, _ = _map_blocks(
            lambda c, a, g: derive_bitplane_tables(c, a, g, lpad),
            index.codes, index.aux, index.slot_gids)
    _gid_view(index, lpad)
    kb = fused_kbuf(int(k))
    if index.fused_kb is None or kb > index.fused_kb:
        index.fused_kb = kb


@rank_captured("mnmg.ivf_rabitq_search")
@obs.spanned("mnmg.ivf_rabitq_search")
def ivf_rabitq_search(index: DistributedIvfRabitq, queries, k: int,
                      n_probes: int = 20, refine_dataset=None,
                      refine_mult: int = 4, prefilter=None,
                      query_mode: str = "auto", query_bits: int = 0,
                      scan_engine: str = "auto", health=None,
                      adaptive: bool = False, recall_target=None,
                      budget_tau=None, min_probes: int = 1,
                      quantization: str = "auto"):
    """SPMD binary-code search: every rank scans its local codes for the
    same global probes and the estimator-ranked local top-k merge on every
    rank ("replicated") or go to per-rank query blocks ("sharded").
    `refine_dataset` (the full dataset, insertion order) enables the exact
    per-rank re-rank of a `refine_mult * k` shortlist, so the merged
    distances are exact. `prefilter`, `health`, replica failover and
    `DegradedSearchResult` as in `ivf_pq_search`.

    `scan_engine` as the single-device SearchParams.scan_engine: "xla"
    (the materializing bit-plane scan), "fused" (the fused AND + popcount
    kernel per rank through matrix/select_k; explicit requests past its
    caps raise) or "auto" (`select_k.resolve_bitplane_strategy`: fused on
    the tuned winner, `select_k.BITPLANE_SCAN_KEY`)."""
    from raft_tpu_torch.comms import quantized
    from raft_tpu_torch.comms.mnmg_ivf_search import (
        _pad_plan, _plan_args, _plan_of, _refine_layout, _refine_local,
    )
    from raft_tpu_torch.comms.replication import failover_view
    from raft_tpu_torch.distance.distance_types import DistanceType
    from raft_tpu_torch.matrix.select_k import check_bitplane_request, resolve_bitplane_strategy
    from raft_tpu_torch.neighbors import probe_budget
    from raft_tpu_torch.neighbors.ivf_rabitq import (
        _search_impl_rabitq, _search_impl_rabitq_fused, rerank_depth, resolve_query_bits,
    )
    from raft_tpu_torch.neighbors.probe_invert import macro_batched, resolve_setup_impls
    from raft_tpu_torch.ops.fused_scan import FUSED_MAX_K, fused_kbuf
    from raft_tpu_torch.ops.pq_list_scan import lane_padded

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
    qbits = resolve_query_bits(query_bits, dev)

    # the scan engine, resolved as the single-device search resolves it;
    # the geometry is global across ranks, so every process resolves the
    # same engine
    if scan_engine not in ("auto", "xla", "fused"):
        raise ValueError(f"unknown scan_engine {scan_engine!r}")
    kk_depth = (rerank_depth(int(k), max(refine_mult, 1)) if refine_dataset is not None
                else int(k))
    lpad = lane_padded(int(index.codes.shape[2]))
    words = int(index.codes.shape[3])
    if scan_engine == "fused":
        check_bitplane_request("scan_engine='fused'", lpad, words, int(qbits), kk_depth,
                               index.fused_kb, "scan_engine='xla'")
        strat = "fused_bitplane"
    elif scan_engine == "auto" and 0 < kk_depth <= FUSED_MAX_K:
        strat = resolve_bitplane_strategy(lpad, words, int(qbits), kk_depth,
                                          kbuf=max(fused_kbuf(kk_depth), index.fused_kb or 0),
                                          device=dev)
    else:
        strat = "xla"
    use_fused = strat == "fused_bitplane"

    ap = probe_budget.resolve(n_probes, adaptive=adaptive, recall_target=recall_target,
                              budget_tau=budget_tau, min_probes=min_probes, early_term=False,
                              device=dev)
    plan, scanned_mean = _plan_args(ap, q, index.centers.on(dev), n_probes, kk_depth,
                                    metric, "mnmg.ivf_rabitq", rotation=index.rotation.on(dev))
    if obs.enabled():
        obs.span_cost(**obs.perf.cost_for(
            "mnmg.ivf_rabitq_search", nq=int(q.shape[0]),
            n_probes=scanned_mean if scanned_mean is not None else n_probes, n_lists=n_lists,
            n_rows=int(index.codes.shape[0] * index.codes.shape[1] * index.codes.shape[2]),
            dim=int(index.centers.shape[-1]), k=int(k), query_bits=int(qbits),
            rerank_mult=int(refine_mult) if refine_dataset is not None else 0,
            fused=use_fused))
    mode = _resolve_query_mode(query_mode, comms, q.shape[0], k)
    live_rep, mode, coverage = _resolve_health(comms, health, query_mode, mode)
    nq = q.shape[0]
    if mode == "sharded":
        q, nq = _pad_queries(q, comms.get_size())
        plan = _pad_plan(plan, q.shape[0])
    merge = _merge_local_topk if mode == "replicated" else _merge_local_topk_scatter
    out_spec = P(None, None) if mode == "replicated" else P(comms.axis, None)
    keep, probes = plan
    pf_bits, pf_n = _replicated_filter_bits(comms, prefilter, index.id_bound)
    use_pf = prefilter is not None
    refine = refine_dataset is not None
    if refine:
        xs_r, base_r, valid_r = _refine_layout(index, refine_dataset)
        base_t = tuple(int(b) for b in base_r)
        valid_t = tuple(int(v) for v in valid_r)
        kk = rerank_depth(int(k), max(refine_mult, 1))
    else:
        xs_r = base_t = valid_t = None
        kk = int(k)

    def finish(ac, v, gid, q, xs, live):
        rank = ac.get_rank()
        if refine:
            v, gid = _refine_local(q, gid, xs, base_t, valid_t, rank, metric, worst)
        else:
            v = torch.where(gid >= 0, v, torch.full_like(v, worst))
        # after the local refine: the site models the shard's reported
        # scores
        v = faults.corrupt_in_trace(SCORES_SITE, v, rank)
        v, gid = _mask_dead_rank(v, gid, live, rank, worst)
        return merge(ac, v, gid, k, select_min, quant=qcfg)

    if use_fused:
        _build_distributed_bitplane(index, kk_depth)
        fused_kb = index.fused_kb  # monotone: may exceed this call's kk
        setup = resolve_setup_impls(n_lists, engine="flat", device=dev)

        def body(ac, rotation, centers, codes_t, bp_meta, gid_tbl, q, xs, bits, live, keep,
                 probes):
            srows = _shard_filtered(gid_tbl[0], bits, pf_n, use_pf)
            v, gid = macro_batched(
                lambda sl, pl=None: _search_impl_rabitq_fused(
                    sl, rotation, centers, codes_t[0], bp_meta[0], srows, kk, n_probes, metric,
                    query_bits=qbits, kb=fused_kb, plan=pl, setup_impls=setup),
                q, kk, extra=_plan_of(keep, probes))
            return finish(ac, v, gid, q, xs, live)

        args = (index.codes_t, index.bp_meta, index.slot_gids_pad)
    else:
        def body(ac, rotation, centers, codes, aux, gid_tbl, q, xs, bits, live, keep, probes):
            srows = _shard_filtered(gid_tbl[0], bits, pf_n, use_pf)
            v, gid = _search_impl_rabitq(q, rotation, centers, codes[0], aux[0], srows, kk,
                                         n_probes, metric, query_bits=qbits,
                                         plan=_plan_of(keep, probes))
            return finish(ac, v, gid, q, xs, live)

        args = (index.codes, index.aux, index.slot_gids)
    specs = (P(), P()) + (P(comms.axis),) * 3 + (P(), P(comms.axis)) + (P(),) * 4
    v, gid = comms.run(body, index.rotation, index.centers, *args, q, xs_r, pf_bits, live_rep,
                       keep, probes, in_specs=specs, out_specs=(out_spec, out_spec))
    return _pack_result(v, gid, nq, coverage, repaired)
