"""Distributed IVF-Flat / IVF-PQ index types, builds, extends and the
single-device bridge `distribute_index` (counterpart of
raft_tpu/comms/mnmg_ivf_build.py).

The stores are `ShardedArray`s of rank-major `(R, n_lists, max_list, ...)`
tables, one `(1, n_lists, max_list, ...)` block on each rank's device,
padded to the largest list of any rank; `slot_gids` holds global row ids
(-1 pad), so shard-local results merge without translation. The
quantizers (rotation, coarse centers, codebooks) are `ReplicatedArray`s.
Every per-rank step (label, encode, pack, grow) is a body `Comms.run`
runs once per rank; the host handles labels and slot tables only.

Coarse centers train with the distributed balanced EM
(`mnmg_kmeans._kmeans_fit_sharded`) from a k-means++ seed drawn on a
torch generator; the JAX package seeds it, the rotation and the codebook
EM with `jax.random`, so from one seed the two packages build different
(equally good) indexes. The numpy draws (trainset, seed rows, codebook
sample) are the JAX package's, draw for draw.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.comms.comms import Comms, P, ShardedArray
from raft_tpu_torch.comms.mnmg_common import (
    _codebook_cap,
    _distributed_id_bound,
    _gather_replicated,
    _host_np,
    _local_layout,
    _local_shard_rows_host,
    _metric_name,
    _pack_local,
    _pq_geometry,
    _rank_valid_counts,
    _ranks_by_proc,
    _rotate_fn,
    _rows,
    _shard_rows,
    _train_codebooks,
    _valid_global_positions,
    _valid_weights,
)
from raft_tpu_torch.comms.mnmg_kmeans import _kmeans_fit_sharded, _plusplus_init, _spmd_predict
from raft_tpu_torch.core.config import strict_f32_matmul


def _process_index(comms: Comms) -> int:
    """This process's index in the world's `_ranks_by_proc` layout."""
    return comms.rank if comms.process_world else 0


def _process_max(comms: Comms, value: int) -> int:
    """The largest `value` over the processes (one host allreduce in a
    process world of more than one)."""
    if not comms.spans_processes():
        return int(value)
    import torch.distributed as dist

    t = torch.tensor([int(value)], dtype=torch.int64, device=comms.device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def _take_rows(x: torch.Tensor, idx) -> torch.Tensor:
    """Rows `idx` (a numpy index array) of `x`, on `x`'s device."""
    return x[torch.as_tensor(np.asarray(idx, np.int64), device=x.device)]


def distribute_index(comms: Comms, index):
    """Bridge a single-device index onto the world for distributed
    serving: each list's slots are block-split across the ranks, so every
    rank scans its share of every probed list and the usual top-k merge
    applies. Accepts `ivf_flat.Index` and `ivf_pq.Index`; returns the
    matching Distributed* index, whose searches return the single-device
    index's ids. The slot-block layout is no contiguous per-rank row range
    and the gids are the caller's ids, so `refine_dataset` and extend are
    refused on the result (extend the single-device index and
    re-distribute)."""
    R = comms.get_size()
    slots = _host_np(index.slot_rows)
    n_lists, max_list = slots.shape
    mlr = max(1, -(-max_list // R))
    pad = R * mlr - max_list
    slots_p = np.pad(slots, ((0, 0), (0, pad)), constant_values=-1)
    gids_r = np.ascontiguousarray(slots_p.reshape(n_lists, R, mlr).transpose(1, 0, 2))
    if getattr(index, "source_ids", None) is not None:
        src = _host_np(index.source_ids)
        gids_r = np.where(gids_r >= 0, src[np.clip(gids_r, 0, max(len(src) - 1, 0))],
                          -1).astype(np.int32)
    sizes = (gids_r >= 0).sum(axis=2).astype(np.int32)  # (R, n_lists)

    def split_payload(tbl):
        t = _host_np(tbl)
        tp = np.pad(t, ((0, 0), (0, pad)) + ((0, 0),) * (t.ndim - 2))
        perm = (1, 0, 2) + (() if t.ndim == 2 else (3,))
        return np.ascontiguousarray(tp.reshape((n_lists, R, mlr) + t.shape[2:]).transpose(perm))

    spans = comms.spans_processes()
    if hasattr(index, "codes"):  # ivf_pq.Index
        return DistributedIvfPq(
            comms, index.params,
            comms.replicate(_host_np(index.rotation)),
            comms.replicate(_host_np(index.centers)),
            comms.replicate(_host_np(index.pq_centers)),
            _place_rank_major(comms, split_payload(index.codes)),
            _place_rank_major(comms, gids_r), int(index.size),
            host_gids=None if spans else gids_r, list_sizes=None if spans else sizes,
            bridged=True)
    return DistributedIvfFlat(
        comms, index.params, comms.replicate(_host_np(index.centers)),
        _place_rank_major(comms, split_payload(index.list_data)),
        _place_rank_major(comms, gids_r), int(index.size),
        host_gids=None if spans else gids_r, list_sizes=None if spans else sizes,
        bridged=True)


def _place_rank_major(comms: Comms, table) -> ShardedArray:
    """Shard a (R, ...) rank-major table (host numpy, or a tensor) onto the
    ranks, one block each (never a whole host table onto one device
    first); in a process world each process places the blocks of its own
    ranks (checkpoint loads assume a shared filesystem). The blocks never
    alias a host array, which the index may keep as its host mirror: a
    rank on the CPU gets a copy."""
    if not isinstance(table, torch.Tensor) and any(
            comms.rank_device(r).type == "cpu" for r in comms.local_ranks()):
        table = np.array(table, copy=True)
    if not comms.spans_processes():
        return comms.shard(table, axis=0)
    my = _ranks_by_proc(comms).get(_process_index(comms), [])
    return comms.shard_from_local(table[my], axis=0)


#: the arrays `index_from_arrays` takes for each distributed index kind:
#: the JAX Distributed* attributes as numpy (R, ...) rank-major stacks
#: (the quantizers whole), beside `host_gids` / `list_sizes`
DISTRIBUTED_FIELDS = {
    "ivf_flat": ("centers", "list_data", "slot_gids"),
    "ivf_pq": ("rotation", "centers", "pq_centers", "codes", "slot_gids"),
    "ivf_rabitq": ("rotation", "centers", "codes", "aux", "slot_gids"),
}


def index_from_arrays(comms: Comms, kind: str, arrays, params, n: int,
                      extended: bool = False, bridged: bool = False):
    """The port's Distributed* index of `kind` ("ivf_flat", "ivf_pq",
    "ivf_rabitq") on `comms` from a JAX distributed index's arrays as
    numpy (`DISTRIBUTED_FIELDS`, the per-rank tables as (R, ...) stacks
    whose R is the world size), its host mirrors (`host_gids`,
    `list_sizes`, or `local_gids` / `local_sizes`), its row count `n` and
    flags, so both packages can search one identical index. uint32
    RaBitQ codes keep their bits as int32."""
    missing = [f for f in DISTRIBUTED_FIELDS[kind] if f not in arrays]
    if missing:
        raise ValueError(f"index_from_arrays: missing fields {missing}")
    a = {f: np.asarray(arrays[f]) for f in DISTRIBUTED_FIELDS[kind]}
    if a["slot_gids"].shape[0] != comms.get_size():
        raise ValueError(f"the tables hold {a['slot_gids'].shape[0]} ranks, the world "
                         f"{comms.get_size()}")
    if kind == "ivf_rabitq" and a["codes"].dtype == np.uint32:
        a["codes"] = a["codes"].view(np.int32)
    mirrors = {f: (None if arrays.get(f) is None else np.array(arrays[f], np.int32))
               for f in ("host_gids", "list_sizes", "local_gids", "local_sizes")}
    tables = {f: _place_rank_major(comms, a[f]) for f in a
              if f not in ("rotation", "centers", "pq_centers")}
    quant = {f: comms.replicate(np.array(a[f], np.float32)) for f in a
             if f in ("rotation", "centers", "pq_centers")}
    if kind == "ivf_flat":
        return DistributedIvfFlat(comms, params, quant["centers"], tables["list_data"],
                                  tables["slot_gids"], int(n), bridged=bridged, **mirrors)
    if kind == "ivf_pq":
        return DistributedIvfPq(comms, params, quant["rotation"], quant["centers"],
                                quant["pq_centers"], tables["codes"], tables["slot_gids"],
                                int(n), extended=extended, bridged=bridged, **mirrors)
    from raft_tpu_torch.comms.mnmg_rabitq import DistributedIvfRabitq

    return DistributedIvfRabitq(comms, params, quant["rotation"], quant["centers"],
                                tables["codes"], tables["aux"], tables["slot_gids"], int(n),
                                host_gids=mirrors["host_gids"],
                                list_sizes=mirrors["list_sizes"], bridged=bridged)


class DistributedIvfFlat:
    """Data-parallel IVF-Flat: global coarse centers (distributed
    k-means), per-rank list-major stores over the local shard, searched
    SPMD and merged.

    list_data (R, n_lists, max_list, d) and slot_gids (R, n_lists,
    max_list) are sharded on axis 0; slot_gids holds global row ids (-1
    pad). The host mirrors (`host_gids`, `list_sizes`) make
    `ivf_flat_extend` O(n_new); `local_gids` / `local_sizes` are the
    per-process mirrors of a *_build_local index (`ivf_flat_extend_local`)."""

    def __init__(self, comms, params, centers, list_data, slot_gids, n,
                 host_gids=None, list_sizes=None, bridged: bool = False,
                 local_gids=None, local_sizes=None):
        self.comms = comms
        self.params = params
        self.centers = centers
        self.list_data = list_data
        self.slot_gids = slot_gids
        self.n = n
        self.host_gids = host_gids
        self.list_sizes = list_sizes
        self.local_gids = local_gids
        self.local_sizes = local_sizes
        # the fused engine's derived store, built at its first search
        # (mnmg_ivf_search._build_distributed_resid): lane-padded bf16
        # residuals, their norms, the padded gid view and the grown
        # candidate-buffer width
        self.resid_bf16 = None
        self.resid_norm = None
        self.slot_gids_pad = None
        self.fused_kb = None
        # bridged = made by distribute_index: the gids are caller ids, so
        # extend's id assignment could collide
        self.bridged = bridged
        # r-way ring mirrors (comms/replication.py), attached by
        # replicate_index or build(replication=)
        self.replicas = None
        self._id_bound = None

    @property
    def id_bound(self) -> int:
        """One past the largest global id a search can return: the id
        space a `prefilter` covers (n but for bridged indexes). Cached per
        instance (extends return new indexes)."""
        if self._id_bound is None:
            self._id_bound = _distributed_id_bound(self)
        return self._id_bound


def _maybe_replicate(index, replication: int):
    """Attach build-time ring mirrors when `replication` > 1."""
    if int(replication) > 1:
        from raft_tpu_torch.comms.replication import replicate_index

        replicate_index(index, int(replication))
    return index


def _carry_replication(old_index, new_index):
    """Extends return fresh index objects: mirror them again at the source
    index's factor, so a replicated index never serves stale copies."""
    rep = getattr(old_index, "replicas", None)
    if rep is not None:
        from raft_tpu_torch.comms.replication import replicate_index

        replicate_index(new_index, rep.r)
    return new_index


@obs.spanned("mnmg.ivf_flat_build")
def ivf_flat_build(comms: Comms, params, dataset, seed: int = 0,
                   replication: int = 1) -> DistributedIvfFlat:
    """Distributed IVF-Flat build: global coarse centers by the
    distributed balanced EM, per-rank list stores filled SPMD from the row
    shards (the host handles labels and slot tables only). `replication`
    > 1 mirrors each rank's tables onto its r-1 ring holders (r x memory),
    so searches fail over losslessly through up to r-1 rank failures."""
    strict_f32_matmul()
    x = _rows(dataset)
    n = x.shape[0]
    if params.n_lists > n:
        raise ValueError(f"n_lists={params.n_lists} > dataset rows {n}")
    r = comms.get_size()
    xs, _, per = _shard_rows(comms, x)
    w = comms.shard(_valid_weights(n, per, r), axis=0)
    rng = np.random.default_rng(seed)
    sub = _take_rows(x, rng.choice(n, min(n, max(params.n_lists * 8, 1024)), replace=False))
    centers0 = _plusplus_init(sub.to(comms.device), params.n_lists, seed)
    centers, _, _ = _kmeans_fit_sharded(
        comms, xs, w, comms.replicate(centers0), max_iter=params.kmeans_n_iters,
        metric_name=_metric_name(params.metric), balance=True, seed=seed, n_valid=n)
    labels = _spmd_predict(comms, xs, centers).cpu().numpy()[:n]
    local_tbl, gids, sizes, _ = _pack_rank_tables(labels, n, per, r, params.n_lists)
    ldata = _spmd_pack_rows(comms, xs, comms.shard(local_tbl, axis=0), per, torch.float32)
    return _maybe_replicate(DistributedIvfFlat(
        comms, params, comms.replicate(centers), ldata, _place_rank_major(comms, gids), n,
        host_gids=gids, list_sizes=sizes), replication)


def _pack_local_tables(comms: Comms, labels_local: np.ndarray, valid_counts: np.ndarray,
                       counts: np.ndarray, per: int, n_lists: int):
    """Per-process slot-table packing of the *_local builds: each process
    packs its own ranks' lists from its local labels, the processes agree
    on the list width, and the slot gids are caller row ids (positions in
    the process-order concatenation of the partitions). Returns (tbl_sh,
    gids_sh, gids_local, sizes_local): the first two sharded, the last two
    this process's host mirrors ((lranks, n_lists, max_list) gids and
    (lranks, n_lists) fill counts)."""
    from raft_tpu_torch.neighbors.ivf_flat import _pack_lists

    pi = _process_index(comms)
    my_ranks = _ranks_by_proc(comms).get(pi, [])
    lranks = len(my_ranks)
    packed = []
    my_max = 1
    for li, j in enumerate(my_ranks):
        nv = int(valid_counts[j])
        t, _ = _pack_lists(torch.from_numpy(np.ascontiguousarray(
            labels_local[li * per: li * per + nv], np.int64)), n_lists)
        packed.append(t.numpy())
        my_max = max(my_max, t.shape[1])
    max_list = _process_max(comms, my_max)
    proc_offset = int(np.asarray(counts[:pi], np.int64).sum())
    local_tbl = np.full((lranks, n_lists, max_list), -1, np.int32)
    gids_local = np.full((lranks, n_lists, max_list), -1, np.int32)
    sizes_local = np.zeros((lranks, n_lists), np.int32)
    for li, t in enumerate(packed):
        local_tbl[li, :, : t.shape[1]] = t
        valid = t >= 0
        gids_local[li, :, : t.shape[1]][valid] = proc_offset + li * per + t[valid]
        sizes_local[li] = valid.sum(axis=1).astype(np.int32)
    return (comms.shard_from_local(local_tbl, axis=0),
            comms.shard_from_local(gids_local.copy(), axis=0), gids_local, sizes_local)


def ivf_flat_build_local(comms: Comms, params, local_dataset, seed: int = 0,
                         replication: int = 1) -> DistributedIvfFlat:
    """Distributed IVF-Flat build where each process contributes its own
    partition (collective; the raft-dask per-worker model). Coarse centers
    train with the distributed balanced EM over every process's rows; each
    process packs its ranks' tables from its local labels. Searches like
    `ivf_flat_build`'s index; grow it with the collective
    `ivf_flat_extend_local` (`ivf_flat_extend` and save need the global
    host mirrors and refuse it)."""
    strict_f32_matmul()
    local = _rows(local_dataset)
    counts, per, lranks = _local_layout(comms, local.shape[0])
    n = int(counts.sum())
    if params.n_lists > n:
        raise ValueError(f"n_lists={params.n_lists} > total rows {n}")
    xp, wl = _pack_local(local, per, lranks)
    xs = comms.shard_from_local(xp, axis=0)
    w = comms.shard_from_local(wl, axis=0)
    valid_counts = _rank_valid_counts(comms, counts, per)
    gpos = _valid_global_positions(comms, counts, per)
    rng = np.random.default_rng(seed)
    sel = gpos[rng.choice(n, min(n, max(params.n_lists * 8, 1024)), replace=False)]
    sub = torch.as_tensor(_gather_replicated(comms, xs, sel), device=comms.device)
    centers0 = _plusplus_init(sub, params.n_lists, seed)
    centers, _, _ = _kmeans_fit_sharded(
        comms, xs, w, comms.replicate(centers0), max_iter=params.kmeans_n_iters,
        metric_name=_metric_name(params.metric), balance=True, seed=seed, n_valid=n,
        valid_counts=valid_counts)
    labels_local = _local_shard_rows_host(comms, _spmd_predict(comms, xs, centers))
    tbl_sh, gids_sh, gids_local, sizes_local = _pack_local_tables(
        comms, labels_local, valid_counts, counts, per, params.n_lists)
    ldata = _spmd_pack_rows(comms, xs, tbl_sh, per, torch.float32)
    return _maybe_replicate(DistributedIvfFlat(
        comms, params, comms.replicate(centers), ldata, gids_sh, n,
        local_gids=gids_local, local_sizes=sizes_local), replication)


class DistributedIvfPq:
    """Data-parallel IVF-PQ: rotation, coarse centers and codebooks
    trained distributed (replicated afterwards), per-rank code tables over
    the local shard, searched SPMD and merged.

    codes (R, n_lists, max_list, pq_dim) uint8 and slot_gids (R, n_lists,
    max_list) int32 are sharded on axis 0; slot_gids holds global row ids
    (-1 pad), the application-level MNMG ANN sharding of the reference
    (SURVEY §5.7). Host mirrors as in DistributedIvfFlat. The int8
    reconstruction store of the list-major engine (`recon8`,
    `recon_scale`, `recon_norm`) is derived at the first search."""

    def __init__(self, comms, params, rotation, centers, pq_centers, codes,
                 slot_gids, n, host_gids=None, list_sizes=None,
                 extended: bool = False, bridged: bool = False,
                 local_gids=None, local_sizes=None):
        self.comms = comms
        self.params = params
        self.rotation = rotation
        self.centers = centers
        self.pq_centers = pq_centers
        self.codes = codes
        self.slot_gids = slot_gids
        self.n = n
        self.host_gids = host_gids
        self.list_sizes = list_sizes
        self.local_gids = local_gids
        self.local_sizes = local_sizes
        # extend appends each batch under a fresh per-rank gid block, so a
        # rank's gids stop being one contiguous range: the refined search
        # then refines after the merge (mnmg_ivf_search._refine_merged)
        self.extended = extended
        self.bridged = bridged  # see DistributedIvfFlat.bridged
        self.replicas = None  # see DistributedIvfFlat.replicas
        self.recon8 = None
        self.recon_scale = None
        self.recon_norm = None
        self.slot_gids_pad = None  # gid view width-matched to recon8
        self.fused_kb = None
        self._refine_cache = None
        self._id_bound = None

    @property
    def id_bound(self) -> int:
        """See DistributedIvfFlat.id_bound."""
        if self._id_bound is None:
            self._id_bound = _distributed_id_bound(self)
        return self._id_bound

    def clear_refine_cache(self) -> None:
        """Release the sharded dataset copy a refined search pinned (one
        entry, keyed by the dataset's identity)."""
        self._refine_cache = None


def _spmd_label_encode(comms: Comms, xs, rotation, centers, pq_centers, metric,
                       per_cluster: bool):
    """Label and PQ-encode the sharded rows, each rank its own block
    (`ivf_pq.label_and_encode`; the O(n d) encode never leaves the
    devices). Returns sharded (labels (n,) int32, codes (n, pq_dim))."""
    from raft_tpu_torch.neighbors.ivf_pq import label_and_encode

    def body(ac, xs, rotation, centers, pq_centers):
        labels, codes = label_and_encode(xs, rotation, centers, pq_centers, metric, per_cluster)
        return labels.to(torch.int32), codes

    return comms.run(body, xs, rotation, centers, pq_centers,
                     in_specs=(P(comms.axis, None), P(), P(), P()),
                     out_specs=(P(comms.axis), P(comms.axis, None)), keep_blocks=True)


def _pack_rank_tables(labels_np, n, per, r, n_lists):
    """Host slot tables from assignment labels (int work on n labels; the
    row payload stays on the devices and is packed by `_spmd_pack_rows`).
    Returns (local_tbl, gids, sizes, max_list): local_tbl (R, n_lists,
    max_list) holds shard-local row indices (-1 pad), gids the same slots
    as global ids."""
    from raft_tpu_torch.neighbors.ivf_flat import _pack_lists

    tables, sizes = [], []
    max_list = 1
    for rr in range(r):
        lo, hi = rr * per, min((rr + 1) * per, n)
        if lo >= hi:
            tables.append(np.full((n_lists, 1), -1, np.int32))
            sizes.append(np.zeros(n_lists, np.int32))
            continue
        t, sz = _pack_lists(torch.from_numpy(np.ascontiguousarray(labels_np[lo:hi], np.int64)),
                            n_lists)
        tables.append(t.numpy())
        sizes.append(sz.numpy().astype(np.int32))
        max_list = max(max_list, t.shape[1])
    local_tbl = np.full((r, n_lists, max_list), -1, np.int32)
    gids = np.full((r, n_lists, max_list), -1, np.int32)
    for rr, t in enumerate(tables):
        local_tbl[rr, :, : t.shape[1]] = t
        valid = t >= 0
        gids[rr, :, : t.shape[1]][valid] = t[valid] + rr * per
    return local_tbl, gids, np.stack(sizes), max_list


def _spmd_pack_rows(comms: Comms, rows_sh, local_tbl_sh, per: int, out_dtype):
    """Gather each rank's flat rows (its block of an (n, d) array) into its
    list-major table (1, n_lists, max_list, d): the distributed
    process_and_fill_codes (ivf_pq_build.cuh:724) for PQ codes and the
    list-store fill for IVF-Flat."""

    def body(ac, rows, tbl):
        t = tbl[0].long()  # (n_lists, max_list) local row ids
        packed = rows[t.clamp(0, per - 1)].to(out_dtype)
        return packed.masked_fill(~(t >= 0)[..., None], 0)[None]

    return comms.run(body, rows_sh, local_tbl_sh,
                     in_specs=(P(comms.axis, None), P(comms.axis, None, None)),
                     out_specs=P(comms.axis), keep_blocks=True)


def _coarse_fit_rotated(comms: Comms, params, x, rotation, rot_rep, rng, seed: int):
    """The distributed coarse fit over the rotated trainset fraction,
    shared by the PQ and RaBitQ builds (trainset sizing, seeding and the
    EM cannot diverge per quantizer). Draws from the caller's numpy `rng`
    in order, so the caller's later draws see the JAX package's stream.
    Returns (centers, xt trainset rows, n_train)."""
    n = x.shape[0]
    n_lists = params.n_lists
    r = comms.get_size()
    frac = min(max(params.kmeans_trainset_fraction, 0.0), 1.0)
    n_train = min(n, max(n_lists * 4, int(n * frac)))
    xt = _take_rows(x, rng.choice(n, n_train, replace=False))
    xts, _, per_t = _shard_rows(comms, xt)
    xt_rot = _rotate_fn(comms)(xts, rot_rep)
    w = comms.shard(_valid_weights(n_train, per_t, r), axis=0)
    seed_rows = _take_rows(xt, rng.choice(n_train, min(n_train, max(n_lists * 8, 1024)),
                                          replace=False))
    centers0 = _plusplus_init(seed_rows.to(comms.device) @ rotation.T, n_lists, seed)
    centers, _, _ = _kmeans_fit_sharded(
        comms, xt_rot, w, comms.replicate(centers0), max_iter=max(params.kmeans_n_iters, 2),
        metric_name=_metric_name(params.metric), balance=True, seed=seed, n_valid=n_train)
    return centers, xt, n_train


def _train_quantizers(comms: Comms, params, d: int, seed: int):
    """(pq geometry, torch generator, rotation) of a PQ build."""
    from raft_tpu_torch.neighbors import ivf_pq as ivf_pq_mod
    from raft_tpu_torch.random.rng import make_generator

    pq_dim, pq_len, rot_dim = _pq_geometry(params, d)
    gen = make_generator(seed, comms.device)
    rotation = ivf_pq_mod._make_rotation(gen, rot_dim, d,
                                         params.force_random_rotation or rot_dim != d)
    return (pq_dim, pq_len, rot_dim), gen, rotation


def _codebooks(params, gen, x_cb_rot, centers, n_lists: int, pq_dim: int, pq_len: int):
    """Codebook EM on a rotated residual sample (labels by the training
    metric)."""
    from raft_tpu_torch.cluster import kmeans_balanced

    cb_labels = kmeans_balanced._predict_long(x_cb_rot, centers,
                                              metric=_metric_name(params.metric),
                                              device=x_cb_rot.device)
    residuals = x_cb_rot - centers[cb_labels]
    return _train_codebooks(params, gen, residuals, cb_labels, n_lists, pq_dim, pq_len)


@obs.spanned("mnmg.ivf_pq_build")
def ivf_pq_build(comms: Comms, params, dataset, seed: int = 0,
                 replication: int = 1) -> DistributedIvfPq:
    """Distributed IVF-PQ build (ivf_pq_build.cuh:1074 at MNMG scale):
    coarse centers by the distributed EM over the rotated trainset
    fraction (kmeans_trainset_fraction, as the single-device build),
    codebooks on the single-device build's capped residual sample, and the
    whole dataset labelled and encoded SPMD with the codes staying on the
    devices; the host handles labels and slot tables only."""
    from raft_tpu_torch.neighbors import ivf_pq as ivf_pq_mod

    strict_f32_matmul()
    x = _rows(dataset)
    n, d = x.shape
    if params.n_lists > n:
        raise ValueError(f"n_lists={params.n_lists} > dataset rows {n}")
    r = comms.get_size()
    per = -(-n // r)
    n_lists = params.n_lists
    per_cluster = params.codebook_kind == ivf_pq_mod.PER_CLUSTER
    (pq_dim, pq_len, _), gen, rotation = _train_quantizers(comms, params, d, seed)
    rot_rep = comms.replicate(rotation)
    rng = np.random.default_rng(seed)
    centers, xt, n_train = _coarse_fit_rotated(comms, params, x, rotation, rot_rep, rng, seed)
    cb_sel = rng.choice(n_train, min(n_train, _codebook_cap(params, n_lists)), replace=False)
    x_cb_rot = _take_rows(xt, cb_sel).to(comms.device) @ rotation.T
    del xt
    pq_centers = _codebooks(params, gen, x_cb_rot, centers, n_lists, pq_dim, pq_len)
    xs, _, _ = _shard_rows(comms, x)
    cen_rep = comms.replicate(centers)
    pqc_rep = comms.replicate(pq_centers)
    labels_sh, codes_sh = _spmd_label_encode(comms, xs, rot_rep, cen_rep, pqc_rep,
                                             params.metric, per_cluster)
    local_tbl, gids, sizes, _ = _pack_rank_tables(_host_np(labels_sh), n, per, r, n_lists)
    packed = _spmd_pack_rows(comms, codes_sh, comms.shard(local_tbl, axis=0), per, torch.uint8)
    return _maybe_replicate(DistributedIvfPq(
        comms, params, rot_rep, cen_rep, pqc_rep, packed, _place_rank_major(comms, gids), n,
        host_gids=gids, list_sizes=sizes), replication)


def ivf_pq_build_local(comms: Comms, params, local_dataset, seed: int = 0,
                       replication: int = 1) -> DistributedIvfPq:
    """Distributed IVF-PQ build where each process contributes its own
    partition (collective). The trainset fraction is drawn per process
    from its local rows, the coarse centers train with the distributed
    balanced EM, the codebooks on a capped residual sample gathered to
    every process (the same quantizers everywhere), and the whole data is
    labelled and encoded SPMD with per-process table packing. Searches
    like `ivf_pq_build`'s index (slot gids are caller row ids in
    process-concatenation order); extend and save need the global host
    mirrors and refuse it."""
    from raft_tpu_torch.neighbors import ivf_pq as ivf_pq_mod

    strict_f32_matmul()
    local = _rows(local_dataset)
    counts, per, lranks = _local_layout(comms, local.shape[0])
    n = int(counts.sum())
    d = local.shape[1]
    n_lists = params.n_lists
    if n_lists > n:
        raise ValueError(f"n_lists={n_lists} > total rows {n}")
    per_cluster = params.codebook_kind == ivf_pq_mod.PER_CLUSTER
    (pq_dim, pq_len, _), gen, rotation = _train_quantizers(comms, params, d, seed)
    rot_rep = comms.replicate(rotation)

    # the trainset: every process contributes its proportional fraction
    frac = min(max(params.kmeans_trainset_fraction, 0.0), 1.0)
    n_train_target = min(n, max(n_lists * 4, int(n * frac)))
    pi = _process_index(comms)
    my_n = int(counts[pi])
    my_train = min(my_n, max(1, int(round(n_train_target * my_n / max(n, 1)))))
    rng_p = np.random.default_rng(seed * 1_000_003 + pi)
    xt_local = _take_rows(local, rng_p.choice(my_n, my_train, replace=False))
    counts_t, per_t, _ = _local_layout(comms, my_train)
    xt_p, wt_l = _pack_local(xt_local, per_t, lranks)
    xts = comms.shard_from_local(xt_p, axis=0)
    wt = comms.shard_from_local(wt_l, axis=0)
    n_train = int(counts_t.sum())
    valid_counts_t = _rank_valid_counts(comms, counts_t, per_t)
    xt_rot = _rotate_fn(comms)(xts, rot_rep)

    gpos_t = _valid_global_positions(comms, counts_t, per_t)
    rng = np.random.default_rng(seed)
    sel = gpos_t[rng.choice(n_train, min(n_train, max(n_lists * 8, 1024)), replace=False)]
    sub = torch.as_tensor(_gather_replicated(comms, xt_rot, sel), device=comms.device)
    centers0 = _plusplus_init(sub, n_lists, seed)
    centers, _, _ = _kmeans_fit_sharded(
        comms, xt_rot, wt, comms.replicate(centers0), max_iter=max(params.kmeans_n_iters, 2),
        metric_name=_metric_name(params.metric), balance=True, seed=seed, n_valid=n_train,
        valid_counts=valid_counts_t)

    # the codebooks: a capped residual sample gathered to every process
    cb_sel = gpos_t[rng.choice(n_train, min(n_train, _codebook_cap(params, n_lists)),
                               replace=False)]
    x_cb_rot = torch.as_tensor(_gather_replicated(comms, xt_rot, cb_sel), device=comms.device)
    pq_centers = _codebooks(params, gen, x_cb_rot, centers, n_lists, pq_dim, pq_len)

    xp, _ = _pack_local(local, per, lranks)
    xs = comms.shard_from_local(xp, axis=0)
    cen_rep = comms.replicate(centers)
    pqc_rep = comms.replicate(pq_centers)
    labels_sh, codes_sh = _spmd_label_encode(comms, xs, rot_rep, cen_rep, pqc_rep,
                                             params.metric, per_cluster)
    valid_counts = _rank_valid_counts(comms, counts, per)
    tbl_sh, gids_sh, gids_local, sizes_local = _pack_local_tables(
        comms, _host_np(labels_sh), valid_counts, counts, per, n_lists)
    packed = _spmd_pack_rows(comms, codes_sh, tbl_sh, per, torch.uint8)
    return _maybe_replicate(DistributedIvfPq(
        comms, params, rot_rep, cen_rep, pqc_rep, packed, gids_sh, n,
        local_gids=gids_local, local_sizes=sizes_local), replication)


def _check_driver_extend(index, local_fn: str, builder: str) -> None:
    if index.comms.spans_processes():
        raise ValueError(
            "distributed extend is single-controller; on a multi-process "
            f"mesh use {local_fn} (each controller passes its own new rows)")
    if getattr(index, "bridged", False):
        raise ValueError(
            "extend on a bridged (distribute_index) layout can collide "
            "caller ids; extend the single-chip index and re-distribute")
    if index.host_gids is None or index.list_sizes is None:
        raise ValueError(
            f"index lacks global host mirrors (built with {builder}?); use {local_fn}")


def ivf_pq_extend(index: DistributedIvfPq, new_vectors) -> DistributedIvfPq:
    """Distributed extend (ivf_pq_build.cuh:1061 at MNMG scale): the new
    batch is sharded by rows, labelled and encoded SPMD, and appended into
    grown per-rank tables: O(n_new + table copy), as the single-device
    extend."""
    from raft_tpu_torch.neighbors import ivf_pq as ivf_pq_mod

    comms = index.comms
    r = comms.get_size()
    nv = _rows(new_vectors)
    n_new = nv.shape[0]
    if n_new == 0:
        return index
    _check_driver_extend(index, "ivf_pq_extend_local", "ivf_pq_build_local")
    strict_f32_matmul()
    n_lists = index.params.n_lists
    per_cluster = index.params.codebook_kind == ivf_pq_mod.PER_CLUSTER
    old_max = index.codes.shape[2]
    nvs, _, per_new = _shard_rows(comms, nv)
    labels_sh, codes_sh = _spmd_label_encode(comms, nvs, index.rotation, index.centers,
                                             index.pq_centers, index.params.metric, per_cluster)
    new_tbl, host_gids, new_sizes, new_max = _append_rank_tables(
        _host_np(labels_sh), index.list_sizes, index.host_gids, old_max, per_new, n_new,
        n_lists, index.n, r)
    packed = _spmd_grow_tables(comms, index.codes, codes_sh, comms.shard(new_tbl, axis=0),
                               per_new, new_max, torch.uint8)
    return _carry_replication(index, DistributedIvfPq(
        comms, index.params, index.rotation, index.centers, index.pq_centers, packed,
        _place_rank_major(comms, host_gids), index.n + n_new, host_gids=host_gids,
        list_sizes=new_sizes, extended=True))


def _place_append_batches(labels_np, per_new: int, n_valid: int, old_sizes, n_lists: int,
                          old_max: int):
    """Per-rank destination slots of a rank-blocked new batch appended
    after each list's fill: rank rr's valid rows are the prefix
    clip(n_valid - rr*per_new, 0, per_new) of its block
    (`ivf_flat._append_slots`, O(n_new) numpy). The one placement walk of
    the single-controller and collective extends. Returns (placements,
    new_sizes, max_size)."""
    from raft_tpu_torch.neighbors.ivf_flat import _append_slots

    new_sizes = np.array(old_sizes, np.int32, copy=True)
    mx = old_max
    placements = []  # per rank: (labels, slot_abs) or None for empty shards
    for rr in range(new_sizes.shape[0]):
        nv = int(np.clip(n_valid - rr * per_new, 0, per_new))
        if nv == 0:
            placements.append(None)
            continue
        lab = np.asarray(labels_np[rr * per_new: rr * per_new + nv], np.int64)
        slot_abs, sizes_rr, _ = _append_slots(lab, new_sizes[rr].astype(np.int64), n_lists)
        new_sizes[rr] = sizes_rr.astype(np.int32)
        mx = max(mx, int(sizes_rr.max()))
        placements.append((lab, slot_abs))
    return placements, new_sizes, mx


def _align_group(mx: int, old_max: int, group: int = 32) -> int:
    """The grown list width: a multiple of the slot group, never below the
    old width."""
    return max(-(-mx // group) * group, old_max)


def _stamp_append_tables(placements, old_gids, old_max: int, new_max: int, n_lists: int,
                         id_base):
    """Grow the gid tables and build the new-row placement table: row j of
    rank rr's valid prefix lands at its slot with id id_base[rr] + j (the
    one id stamp of both extend paths). Returns (new_tbl local new-row
    ids, grown gids)."""
    r = len(placements)
    new_tbl = np.full((r, n_lists, new_max), -1, np.int32)
    gids = np.full((r, n_lists, new_max), -1, np.int32)
    gids[:, :, :old_max] = old_gids
    for rr, pl in enumerate(placements):
        if pl is None:
            continue
        lab, slot_abs = pl
        j = np.arange(len(lab), dtype=np.int32)
        new_tbl[rr, lab, slot_abs] = j
        gids[rr, lab, slot_abs] = int(id_base[rr]) + j
    return new_tbl, gids


def _append_rank_tables(labels_np, old_sizes, old_host_gids, old_max: int, per_new: int,
                        n_new: int, n_lists: int, n_old: int, r: int):
    """Host bookkeeping of the single-controller extend. Returns (new_tbl
    local new-row ids, host_gids, new_sizes, new_max)."""
    placements, new_sizes, mx = _place_append_batches(labels_np, per_new, n_new, old_sizes,
                                                       n_lists, old_max)
    new_max = _align_group(mx, old_max)
    new_tbl, host_gids = _stamp_append_tables(placements, old_host_gids, old_max, new_max,
                                              n_lists,
                                              n_old + per_new * np.arange(r, dtype=np.int64))
    return new_tbl, host_gids, new_sizes, new_max


def _spmd_grow_tables(comms: Comms, old_tbl, rows_sh, new_tbl_sh, per_new: int, new_max: int,
                      out_dtype):
    """Grow each rank's list table to new_max slots and place its block of
    the new rows at their destination slots (the distributed
    _grow_and_scatter)."""
    n_lists, old_max = int(old_tbl.shape[1]), int(old_tbl.shape[2])

    def body(ac, old, rows, tbl):
        t = tbl[0].long()  # (n_lists, new_max)
        out = torch.zeros((n_lists, new_max) + tuple(old.shape[3:]), dtype=out_dtype,
                          device=old.device)
        out[:, :old_max] = old[0]
        hit = t >= 0
        out[hit] = rows[t[hit].clamp(0, max(per_new - 1, 0))].to(out_dtype)
        return out[None]

    return comms.run(body, old_tbl, rows_sh, new_tbl_sh,
                     in_specs=(P(comms.axis), P(comms.axis, None), P(comms.axis, None, None)),
                     out_specs=P(comms.axis), keep_blocks=True)


def ivf_flat_extend(index: DistributedIvfFlat, new_vectors) -> DistributedIvfFlat:
    """Distributed IVF-Flat extend: the new batch is sharded by rows,
    labelled SPMD and appended into grown per-rank list stores:
    O(n_new + table copy)."""
    comms = index.comms
    r = comms.get_size()
    nv = _rows(new_vectors)
    n_new = nv.shape[0]
    if n_new == 0:
        return index
    _check_driver_extend(index, "ivf_flat_extend_local", "ivf_flat_build_local")
    n_lists = index.params.n_lists
    old_max = index.list_data.shape[2]
    nvs, _, per_new = _shard_rows(comms, nv)
    labels = _spmd_predict(comms, nvs, index.centers).cpu().numpy()
    new_tbl, host_gids, new_sizes, new_max = _append_rank_tables(
        labels, index.list_sizes, index.host_gids, old_max, per_new, n_new, n_lists, index.n, r)
    ldata = _spmd_grow_tables(comms, index.list_data, nvs, comms.shard(new_tbl, axis=0),
                              per_new, new_max, torch.float32)
    return _carry_replication(index, DistributedIvfFlat(
        comms, index.params, index.centers, ldata, _place_rank_major(comms, host_gids),
        index.n + n_new, host_gids=host_gids, list_sizes=new_sizes))


def _extend_local_impl(index, local_new, label_payload_fn, store, out_dtype, dim: int):
    """Collective extend where each process appends its own new rows. New
    ids continue the build's id space: positions in the process-order
    concatenation of the new partitions, after the old total.

    Every process packs and shards its rows, labels (and encodes) them
    SPMD, places its ranks' new rows against its per-process mirrors, the
    processes agree on the new list width, and the tables grow on the
    devices. Returns (grown store, gids_sh, gids_local, sizes_local,
    n_total), or None for an empty batch. `dim` checks the row width up
    front (a mismatch would otherwise surface mid-collective)."""
    comms = index.comms
    local = _rows(local_new)
    if local.ndim != 2 or local.shape[1] != dim:
        raise ValueError(f"new rows must be (n, {dim}), got {tuple(local.shape)}")
    if getattr(index, "bridged", False):
        raise ValueError(
            "extend on a bridged (distribute_index) layout can collide "
            "caller ids; extend the single-chip index and re-distribute")
    if index.local_gids is None or index.local_sizes is None:
        raise ValueError(
            "index lacks the per-process mirrors extend_local appends "
            "against (kept by *_build_local builds and checkpoint loads)")
    counts_new, per_new, lranks = _local_layout(comms, local.shape[0])
    total_new = int(counts_new.sum())
    if total_new == 0:
        return None
    n_lists = index.params.n_lists
    old_max = int(store.shape[2])
    xp, _ = _pack_local(local, per_new, lranks)
    nvs = comms.shard_from_local(xp, axis=0)
    labels_sh, payload_sh = label_payload_fn(nvs)
    pi = _process_index(comms)
    placements, sizes_new, my_max = _place_append_batches(
        _host_np(labels_sh), per_new, int(counts_new[pi]), index.local_sizes, n_lists, old_max)
    new_max = _align_group(_process_max(comms, my_max), old_max)
    new_base = index.n + int(counts_new[:pi].sum())
    new_tbl, gids_grown = _stamp_append_tables(
        placements, index.local_gids, old_max, new_max, n_lists,
        new_base + per_new * np.arange(lranks, dtype=np.int64))
    tbl_sh = comms.shard_from_local(new_tbl, axis=0)
    grown = _spmd_grow_tables(comms, store, payload_sh, tbl_sh, per_new, new_max, out_dtype)
    gids_sh = comms.shard_from_local(gids_grown.copy(), axis=0)
    return grown, gids_sh, gids_grown, sizes_new, index.n + total_new


def ivf_flat_extend_local(index: DistributedIvfFlat,
                          local_new_vectors) -> DistributedIvfFlat:
    """Collective multi-process IVF-Flat extend: every process calls with
    its own new rows (zero-row partitions are fine). The new rows' ids
    continue the id space: the old total plus their position in the
    process-order concatenation of the new partitions."""
    comms = index.comms

    def label(nvs):
        labels = _spmd_predict(comms, nvs, index.centers)
        return _local_shard_rows_host(comms, labels), nvs

    res = _extend_local_impl(index, local_new_vectors, label, index.list_data, torch.float32,
                             dim=int(index.list_data.shape[-1]))
    if res is None:
        return index
    ldata, gids_sh, gids_local, sizes_local, n_total = res
    return _carry_replication(index, DistributedIvfFlat(
        comms, index.params, index.centers, ldata, gids_sh, n_total,
        local_gids=gids_local, local_sizes=sizes_local))


def ivf_pq_extend_local(index: DistributedIvfPq, local_new_vectors) -> DistributedIvfPq:
    """Collective multi-process IVF-PQ extend (see ivf_flat_extend_local).
    The returned index derives its int8 reconstruction store at its first
    search and is marked extended; unlike driver-built extends (which
    refine after the merge over the full dataset) a *_local-extended
    layout cannot refine: its partitions' ids straddle the original and
    the appended id blocks."""
    from raft_tpu_torch.neighbors import ivf_pq as ivf_pq_mod

    per_cluster = index.params.codebook_kind == ivf_pq_mod.PER_CLUSTER
    comms = index.comms

    def label_encode(nvs):
        return _spmd_label_encode(comms, nvs, index.rotation, index.centers,
                                  index.pq_centers, index.params.metric, per_cluster)

    strict_f32_matmul()
    res = _extend_local_impl(index, local_new_vectors, label_encode, index.codes, torch.uint8,
                             dim=int(index.rotation.shape[1]))
    if res is None:
        return index
    codes, gids_sh, gids_local, sizes_local, n_total = res
    return _carry_replication(index, DistributedIvfPq(
        comms, index.params, index.rotation, index.centers, index.pq_centers, codes, gids_sh,
        n_total, extended=True, local_gids=gids_local, local_sizes=sizes_local))

