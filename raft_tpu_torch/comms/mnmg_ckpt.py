"""Sharded and single-file checkpoints of the distributed IVF indexes
(counterpart of raft_tpu/comms/mnmg_ckpt.py): per-process part files,
the manifest as commit marker, fold-merge loads onto smaller worlds.

The files are the JAX package's format of record, through the port's
`core/serialize` container: a checkpoint either package writes, the other
loads (RaBitQ codes are stored as uint32 words, as the JAX package stores
them). Every write is the atomic write-to-temp-then-rename container with
per-array CRC-32C checksums; loads verify them, and on a replicated
index's checkpoint (build `replication=` / `replicate_index`) a corrupt
shard table is healed from a peer's mirror slice, saved beside the
primaries. Fault site "ckpt.corrupt_file" flips seeded data-region bytes
right after a save, so the detect-and-heal path can be drilled."""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import faults
from raft_tpu_torch.core.serialize import ChecksumError, serialize_arrays
from raft_tpu_torch.comms.comms import Comms, _process_index_count
from raft_tpu_torch.comms.mnmg_common import _host_np, _ranks_by_proc
from raft_tpu_torch.comms.mnmg_ivf_build import (
    DistributedIvfFlat, DistributedIvfPq, _place_rank_major, _process_index,
)
from raft_tpu_torch.distance.distance_types import DistanceType

CORRUPT_SITE = "ckpt.corrupt_file"


def _write_ckpt(filename: str, arrays: dict, meta: dict) -> None:
    """The one checkpoint write path: the atomic checksummed container
    write, then the "ckpt.corrupt_file" fault site (after the rename, so a
    drill models rot of a committed checkpoint, not a torn write)."""
    from raft_tpu_torch.core.serialize import container_data_start

    serialize_arrays(filename, {k: _host_np(v) for k, v in arrays.items()}, meta)
    faults.corrupt_file(CORRUPT_SITE, filename, start=container_data_start(filename),
                        rank=_process_index_count()[0])


def _as_u32(a: np.ndarray) -> np.ndarray:
    """Packed int32 words as the format's uint32 (the same bits)."""
    a = np.ascontiguousarray(a)
    return a.view(np.uint32) if a.dtype == np.int32 else a


def _as_i32(a: np.ndarray) -> np.ndarray:
    """uint32 words of a file as the port's int32 words (the same bits)."""
    a = np.ascontiguousarray(a)
    return a.view(np.int32) if a.dtype == np.uint32 else a


def _replica_arrays(index, store_name: str) -> dict:
    """The mirror payload a replicated index's checkpoint carries: the
    ring replica copies of the shard tables ((R, r-1, ...) rank-major) and
    the matching fill-count mirror. A load that finds a corrupt primary
    array rebuilds it from these (each rank's slice was written by its
    peer holder, so one flipped shard never loses data)."""
    rep = getattr(index, "replicas", None)
    if rep is None:
        return {}
    sizes = np.asarray(index.list_sizes)
    r = rep.r
    R = sizes.shape[0]
    rep_sizes = np.stack([sizes[(np.arange(R) - 1 - m) % R] for m in range(r - 1)], axis=1)
    store = _host_np(rep.tables[store_name])
    out = {
        "replica_store": _as_u32(store) if "aux" in rep.tables else store,
        "replica_gids": _host_np(rep.tables["slot_gids"]),
        "replica_sizes": rep_sizes,
    }
    if "aux" in rep.tables:  # IVF-RaBitQ: the correction table mirrors too
        out["replica_aux"] = _host_np(rep.tables["aux"])
    return out


def _heal_from_mirrors(filename: str, arrays: dict, meta: dict, bad: list, store_key: str,
                       extra_healable: dict = None) -> dict:
    """Heal a single-file checkpoint whose shard tables failed checksum
    verification from the replica mirror arrays (written by the peer
    holders): primary[u] is rebuilt from holder (u+1)'s slot-0 copy.
    Corrupt mirror arrays are dropped (live replicas derive again from the
    healed primaries at load); a primary whose mirror is gone too, or an
    unmirrored field (the quantizers), raises the ChecksumError.
    `extra_healable` adds primary -> mirror pairs (IVF-RaBitQ's correction
    table)."""
    r = int(meta.get("replication", 1))
    mirror_fields = {"replica_store", "replica_gids", "replica_sizes"}
    healable = {store_key: "replica_store", "host_gids": "replica_gids",
                "list_sizes": "replica_sizes"}
    if extra_healable:
        healable.update(extra_healable)
        mirror_fields |= set(extra_healable.values())
    prim_bad = [b for b in bad if b not in mirror_fields]
    healed = dict(arrays)
    for b in set(bad) & mirror_fields:
        healed.pop(b, None)
    if not prim_bad:
        obs.event("ckpt.heal", file=filename, fields=sorted(bad), source="dropped_mirrors")
        return healed
    if r <= 1:
        raise ChecksumError(filename, bad)
    R = int(meta["n_ranks"])
    src = (np.arange(R) + 1) % R  # slot 0 of rank u+1 holds u's shard
    recovered = set()
    # gid tables heal before sizes: the sizes fallback derives from the
    # gid pads, valid for clean or just-healed gids
    order = [store_key, "host_gids", "list_sizes"]
    for b in sorted(prim_bad, key=lambda x: order.index(x) if x in order else len(order)):
        mirror = healable.get(b)
        if mirror is not None and mirror not in bad:
            healed[b] = np.ascontiguousarray(np.asarray(arrays[mirror])[src, 0])
        elif b == "list_sizes" and ("host_gids" not in bad or "host_gids" in recovered):
            healed[b] = (np.asarray(healed["host_gids"]) >= 0).sum(axis=-1).astype(np.int32)
        else:
            raise ChecksumError(filename, bad)
        recovered.add(b)
    obs.event("ckpt.heal", file=filename, fields=sorted(prim_bad), source="mirror")
    return healed


def _fold_merge_tables(store, gids, sizes, r: int, device=None):
    """Merge a checkpoint's `fold` stored ranks per world rank: per-list
    slots concatenate along the slot axis (all hold global ids), then the
    valid slots compact to a prefix (extend appends at list_sizes[l],
    which assumes no interior pad gaps). The store moves and compacts on
    `device` (the loading world's), the gid and fill-count mirrors come
    back to the host: returns (store tensor, gids numpy, sizes numpy)."""
    store = torch.as_tensor(store).to(device)
    gids = torch.as_tensor(np.asarray(gids)).to(store.device)
    r_stored = store.shape[0]
    fold = r_stored // r
    n_lists, max_list = store.shape[1], store.shape[2]
    trail = tuple(store.shape[3:])
    store = store.reshape((r, fold, n_lists, max_list) + trail).movedim(1, 2)
    store = store.reshape((r, n_lists, fold * max_list) + trail)
    gids = gids.reshape(r, fold, n_lists, max_list).movedim(1, 2)
    gids = gids.reshape(r, n_lists, fold * max_list)
    sizes = np.asarray(sizes).reshape(r, fold, n_lists).sum(axis=1)
    pad_last = torch.argsort((gids < 0).to(torch.int8), dim=-1, stable=True)
    gids = torch.gather(gids, -1, pad_last)
    idx = pad_last.reshape(pad_last.shape + (1,) * len(trail)).expand(store.shape)
    return torch.gather(store, 2, idx), gids.cpu().numpy(), sizes


def _load_rank_tables(store_np, gids_np, sizes_np, r_stored: int, r: int, device=None):
    """Re-shard a checkpoint's rank-major tables onto an r-rank world
    (fold-merge on `device` when smaller), else copy the deserializer's
    read-only gid view into a writable mirror."""
    if r_stored != r:
        if r_stored % r != 0:
            raise ValueError(f"stored rank count {r_stored} not divisible by mesh size {r}")
        return _fold_merge_tables(store_np, gids_np, sizes_np, r, device)
    return store_np, gids_np.copy(), sizes_np


def ivf_flat_save(filename: str, index: DistributedIvfFlat) -> None:
    """Serialize a distributed IVF-Flat index (centers, rank-major list
    stores and fill counts); `ivf_flat_load` re-shards onto the loading
    session's world. A replicated index also writes its mirror tables, so
    a corrupt primary array heals from them at load."""
    if index.host_gids is None or index.list_sizes is None:
        raise ValueError("index lacks host mirrors; rebuild with ivf_flat_build")
    if index.comms.spans_processes():
        raise ValueError("distributed save is single-controller")
    rep = getattr(index, "replicas", None)
    _write_ckpt(
        filename,
        {"centers": index.centers, "list_data": index.list_data,
         "host_gids": index.host_gids, "list_sizes": index.list_sizes,
         **_replica_arrays(index, "list_data")},
        {"kind": "mnmg_ivf_flat", "version": 1, "n": index.n,
         "n_ranks": int(index.list_data.shape[0]), "metric": int(index.params.metric),
         "n_lists": index.params.n_lists, "bridged": bool(getattr(index, "bridged", False)),
         "replication": int(rep.r) if rep is not None else 1})


def _save_local_impl(filename: str, index, store_arr, kind: str, quant_arrays: dict,
                     extra_meta: dict) -> None:
    """Collective sharded checkpoint: every process writes its ranks'
    tables to `{filename}.part{pi}` (no gather across processes, no host
    ever holding the whole index), process 0 writes the manifest (the
    replicated quantizers and the rank -> part map), and a barrier at the
    end makes the checkpoint complete when the call returns. `ivf_*_load`
    re-assembles it on any world whose size divides the stored rank
    count."""
    comms = index.comms
    if getattr(index, "bridged", False):
        raise ValueError(
            "bridged (distribute_index) layouts checkpoint via the "
            "single-chip index they were distributed from")
    local_gids, local_sizes = index.local_gids, index.local_sizes
    if local_gids is None or local_sizes is None:
        if index.host_gids is not None and index.list_sizes is not None:
            # a single-controller build: this process's slices of the
            # global host mirrors
            local_gids, local_sizes = _local_mirror_slices(
                comms, np.asarray(index.host_gids), np.asarray(index.list_sizes))
        else:
            raise ValueError(
                "index lacks the per-process mirrors a sharded save "
                "writes (kept by *_build_local builds, *_build builds, "
                "and checkpoint loads)")
    ranks_by_proc = _ranks_by_proc(comms)
    pi = _process_index(comms)
    my_ranks = ranks_by_proc.get(pi, [])
    u32 = hasattr(index, "aux")

    def local_rows(arr):
        # a sharded array's blocks here are exactly this process's ranks'
        rows = np.concatenate([b.detach().cpu().numpy() for b in arr.blocks], axis=0)
        return _as_u32(rows) if u32 else rows

    part_arrays = {"store": local_rows(store_arr), "gids": local_gids, "sizes": local_sizes}
    rep = getattr(index, "replicas", None)
    if rep is not None:
        # each part also carries this process's hosted replica slots (the
        # mirror copies of its ring predecessors' shards): the peer
        # slices a corrupt part heals from at load
        store_name = "codes" if hasattr(index, "codes") else "list_data"
        part_arrays["mirror_store"] = local_rows(rep.tables[store_name])
        part_arrays["mirror_gids"] = local_rows(rep.tables["slot_gids"])
    _write_ckpt(f"{filename}.part{pi}", part_arrays,
                {"kind": kind + "_part", "ranks": [int(j) for j in my_ranks]})

    def barrier():
        if comms.spans_processes():
            import torch.distributed as dist

            dist.barrier()

    # the manifest is the commit marker: every part is complete on disk
    # before it exists, so a crash mid-save leaves no valid-looking
    # manifest pointing at torn parts
    barrier()
    if pi == 0:
        nproc = comms.get_size() if comms.process_world else 1
        _write_ckpt(filename, quant_arrays, {
            "kind": kind, "version": 1, "n": index.n, "n_ranks": comms.get_size(),
            "n_parts": nproc,
            "parts": [[int(j) for j in ranks_by_proc.get(p, [])] for p in range(nproc)],
            "replication": int(rep.r) if rep is not None else 1, **extra_meta})
    barrier()  # loads issued right after the return see the manifest


def _load_local_tables(comms: Comms, filename: str, meta: dict):
    """Per-process assembly of a sharded checkpoint: read only the part
    files covering this process's ranks (fold-merging when the world is
    smaller than the stored rank count). Returns host (store, gids, sizes)
    of this process's ranks, in rank order.

    Checksum-verified: a part whose primary tables fail the CRC is healed
    rank by rank from the mirror slices its ring peers' parts carry
    (checkpoints of replicated indexes); only when no intact copy of a
    needed shard exists does the load raise `ChecksumError`."""
    from raft_tpu_torch.core.serialize import deserialize_arrays_checked

    r = comms.get_size()
    r_stored = int(meta["n_ranks"])
    rep_r = int(meta.get("replication", 1))
    if r_stored % r:
        raise ValueError(f"stored rank count {r_stored} not divisible by mesh size {r}")
    fold = r_stored // r
    my_ranks = _ranks_by_proc(comms).get(_process_index(comms), [])
    needed = [j * fold + k for j in my_ranks for k in range(fold)]
    where = {}
    for p, ranks in enumerate(meta["parts"]):
        for row, g in enumerate(ranks):
            where[int(g)] = (p, row)
    missing = [g for g in needed if g not in where]
    if missing:
        raise ValueError(f"manifest maps no part for stored ranks {missing}")
    part_cache: dict = {}

    def read_part(p):
        if p not in part_cache:
            arrays, _, bad = deserialize_arrays_checked(f"{filename}.part{p}", to_device=False)
            part_cache[p] = (arrays, set(bad))
        return part_cache[p]

    def heal_rank(g):
        """Rebuild stored rank g's tables from a peer part's mirror slice
        (holder h = g+1+m hosts g's copy at slot m)."""
        for m in range(rep_r - 1):
            h = (g + 1 + m) % r_stored
            loc = where.get(h)
            if loc is None:
                continue
            p2, row2 = loc
            arrays2, bad2 = read_part(p2)
            if "mirror_store" not in arrays2 or {"mirror_store", "mirror_gids"} & bad2:
                continue
            mg = np.asarray(arrays2["mirror_gids"])[row2, m]
            ms = np.asarray(arrays2["mirror_store"])[row2, m]
            obs.event("ckpt.heal", file=f"{filename}.part{where[g][0]}", rank=int(g),
                      holder=int(h), source="mirror")
            return ms, mg, (mg >= 0).sum(axis=-1).astype(np.int32)
        raise ChecksumError(f"{filename}.part{where[g][0]}", ["store", "gids"])

    by_part = {}
    for g in needed:
        p, row = where[g]
        by_part.setdefault(p, []).append((g, row))
    rows = {}
    for p, entries in by_part.items():
        arrays, bad = read_part(p)
        store_p = np.asarray(arrays["store"])
        gids_p = np.asarray(arrays["gids"])
        sizes_p = np.asarray(arrays["sizes"])
        if {"store", "gids"} & bad:
            for g, _row in entries:
                rows[g] = heal_rank(g)
            continue
        if "sizes" in bad:
            # gids verified clean: the fill counts derive from the pads
            sizes_p = (gids_p >= 0).sum(axis=-1).astype(np.int32)
            obs.event("ckpt.heal", file=f"{filename}.part{p}", fields=["sizes"], source="gids")
        for g, row in entries:
            rows[g] = (store_p[row], gids_p[row], sizes_p[row])
    store = np.stack([rows[g][0] for g in needed])
    gids = np.stack([rows[g][1] for g in needed])
    sizes = np.stack([rows[g][2] for g in needed])
    if fold > 1:
        store, gids, sizes = _fold_merge_tables(store, gids, sizes, len(my_ranks),
                                                comms.device)
    return store, gids, sizes.astype(np.int32)


def _local_mirror_slices(comms: Comms, gids: np.ndarray, sizes: np.ndarray):
    """This process's rank slices of a checkpoint's rank-major host tables:
    the per-process mirrors that make `*_extend_local` work on loaded
    indexes (in `_ranks_by_proc` order, matching `_pack_local_tables`)."""
    my_ranks = _ranks_by_proc(comms).get(_process_index(comms), [])
    return gids[my_ranks].copy(), sizes[my_ranks].astype(np.int32).copy()


def ivf_flat_save_local(filename: str, index: DistributedIvfFlat) -> None:
    """Collective sharded checkpoint of a distributed IVF-Flat index: every
    process writes its own ranks' tables (`{filename}.part{p}`), process 0
    the manifest; no host ever holds the whole index. Load with
    `ivf_flat_load` on any world whose size divides the stored rank count
    (a shared filesystem)."""
    _save_local_impl(filename, index, index.list_data, "mnmg_ivf_flat_sharded",
                     {"centers": _host_np(index.centers)},
                     {"metric": int(index.params.metric), "n_lists": index.params.n_lists})


def _load_verified(filename: str, store_key: str, extra_healable: dict = None):
    """Checked read of a single-file or manifest container: checksum
    failures of the primary shard tables heal from the in-file mirrors
    (`_heal_from_mirrors`); anything else raises `ChecksumError`."""
    from raft_tpu_torch.core.serialize import check_ckpt_version, deserialize_arrays_checked

    arrays, meta, bad = deserialize_arrays_checked(filename, to_device=False)
    # the version gate before the heal: a newer checkpoint may carry fields
    # whose heal semantics this build cannot know
    check_ckpt_version(meta, filename)
    if bad:
        arrays = _heal_from_mirrors(filename, arrays, meta, bad, store_key,
                                    extra_healable=extra_healable)
    return arrays, meta


def _reattach_replicas(index, meta):
    """Mirror a loaded index again at its checkpoint's replication factor
    (from the freshly loaded primaries: always coherent, even where the
    checkpoint's own mirror arrays healed the load)."""
    # a fold-merge load can land on a world smaller than r: clamp
    r = min(int(meta.get("replication", 1)), index.comms.get_size())
    if r > 1:
        from raft_tpu_torch.comms.replication import replicate_index

        replicate_index(index, r)
    return index


def ivf_flat_load(comms: Comms, filename: str) -> DistributedIvfFlat:
    """Load a distributed IVF-Flat index, a single-file checkpoint
    (`ivf_flat_save`) or a sharded one (`ivf_flat_save_local`), re-sharded
    onto this session's world (the stored rank count a multiple of the
    world size). Checksum-verified; corrupt shard tables heal from the
    checkpoint's mirror slices, and a `replication` > 1 checkpoint comes
    back with live replicas."""
    from raft_tpu_torch.neighbors import ivf_flat as ivf_flat_mod

    # fault site: flaky or slow reads (`resilience.rehydrate` retries)
    faults.fault_point("mnmg_ckpt.load", rank=_process_index_count()[0])
    arrays, meta = _load_verified(filename, "list_data")
    params = None
    if meta.get("kind") in ("mnmg_ivf_flat_sharded", "mnmg_ivf_flat"):
        params = ivf_flat_mod.IndexParams(n_lists=int(meta["n_lists"]),
                                          metric=DistanceType(meta["metric"]))
    spans = comms.spans_processes()
    if meta.get("kind") == "mnmg_ivf_flat_sharded":
        ldata, gids_l, sizes_l = _load_local_tables(comms, filename, meta)
        return _reattach_replicas(DistributedIvfFlat(
            comms, params, comms.replicate(np.asarray(arrays["centers"])),
            comms.shard_from_local(ldata, axis=0),
            comms.shard_from_local(gids_l.copy(), axis=0), int(meta["n"]),
            # single-controller: this process's assembly is the whole
            # rank-major table, so the classic extend and save work too
            host_gids=None if spans else gids_l, list_sizes=None if spans else sizes_l,
            local_gids=gids_l, local_sizes=sizes_l), meta)
    if meta.get("kind") != "mnmg_ivf_flat":
        raise ValueError(f"not a distributed ivf_flat file: {meta.get('kind')}")
    ldata, gids, sizes = _load_rank_tables(
        np.asarray(arrays["list_data"]), np.asarray(arrays["host_gids"]),
        np.asarray(arrays["list_sizes"]), int(meta["n_ranks"]), comms.get_size(),
        comms.device)
    local_gids, local_sizes = _local_mirror_slices(comms, gids, sizes)
    return _reattach_replicas(DistributedIvfFlat(
        comms, params, comms.replicate(np.asarray(arrays["centers"])),
        _place_rank_major(comms, ldata), _place_rank_major(comms, gids), int(meta["n"]),
        host_gids=None if spans else gids,
        list_sizes=None if spans else sizes.astype(np.int32),
        bridged=bool(meta.get("bridged", False)),
        local_gids=local_gids, local_sizes=local_sizes), meta)


def ivf_pq_save(filename: str, index: DistributedIvfPq) -> None:
    """Serialize a distributed IVF-PQ index (the quantizers, the
    rank-major code and slot tables and the fill counts), the distributed
    counterpart of ivf_pq.save (ivf_pq_serialize.cuh). `ivf_pq_load`
    re-shards onto the loading session's world. A replicated index also
    writes its mirror tables (see ivf_flat_save)."""
    from raft_tpu_torch.neighbors.ivf_pq import PER_CLUSTER

    if index.host_gids is None or index.list_sizes is None:
        raise ValueError("index lacks host mirrors; rebuild with ivf_pq_build")
    if index.comms.spans_processes():
        raise ValueError("distributed save is single-controller")
    rep = getattr(index, "replicas", None)
    _write_ckpt(
        filename,
        {"rotation": index.rotation, "centers": index.centers, "pq_centers": index.pq_centers,
         "codes": index.codes, "host_gids": index.host_gids, "list_sizes": index.list_sizes,
         **_replica_arrays(index, "codes")},
        {"kind": "mnmg_ivf_pq", "version": 1, "n": index.n,
         "n_ranks": int(index.codes.shape[0]), "metric": int(index.params.metric),
         "n_lists": index.params.n_lists, "pq_dim": int(index.codes.shape[-1]),
         "pq_bits": index.params.pq_bits,
         "per_cluster": index.params.codebook_kind == PER_CLUSTER,
         "extended": bool(getattr(index, "extended", False)),
         "bridged": bool(getattr(index, "bridged", False)),
         "replication": int(rep.r) if rep is not None else 1})


def ivf_pq_save_local(filename: str, index: DistributedIvfPq) -> None:
    """Collective sharded checkpoint of a distributed IVF-PQ index (see
    ivf_flat_save_local): per-process part files and a process-0 manifest
    with the replicated quantizers. Load with `ivf_pq_load`."""
    from raft_tpu_torch.neighbors.ivf_pq import PER_CLUSTER

    _save_local_impl(
        filename, index, index.codes, "mnmg_ivf_pq_sharded",
        {"rotation": _host_np(index.rotation), "centers": _host_np(index.centers),
         "pq_centers": _host_np(index.pq_centers)},
        {"metric": int(index.params.metric), "n_lists": index.params.n_lists,
         "pq_dim": int(index.codes.shape[-1]), "pq_bits": index.params.pq_bits,
         "per_cluster": index.params.codebook_kind == PER_CLUSTER,
         "extended": bool(getattr(index, "extended", False))})


def ivf_rabitq_save(filename: str, index) -> None:
    """Serialize a distributed IVF-RaBitQ index (rotation and centers, the
    rank-major packed-code, correction and slot tables, the fill counts)
    through the CRC container, codes as uint32 words. A replicated index
    also writes its mirror tables, the correction-table mirror
    (`replica_aux`) among them."""
    if index.host_gids is None or index.list_sizes is None:
        raise ValueError("index lacks host mirrors; rebuild with ivf_rabitq_build")
    if index.comms.spans_processes():
        raise ValueError("distributed save is single-controller")
    rep = getattr(index, "replicas", None)
    _write_ckpt(
        filename,
        {"rotation": index.rotation, "centers": index.centers,
         "codes": _as_u32(_host_np(index.codes)), "aux": index.aux,
         "host_gids": index.host_gids, "list_sizes": index.list_sizes,
         **_replica_arrays(index, "codes")},
        {"kind": "mnmg_ivf_rabitq", "version": 1, "n": index.n,
         "n_ranks": int(index.codes.shape[0]), "metric": int(index.params.metric),
         "n_lists": index.params.n_lists, "bridged": bool(getattr(index, "bridged", False)),
         "replication": int(rep.r) if rep is not None else 1})


def ivf_rabitq_load(comms: Comms, filename: str):
    """Load a distributed IVF-RaBitQ checkpoint, re-sharded onto this
    session's world (fold-merge shares the flat and PQ path).
    Checksum-verified: corrupt code, correction or slot tables heal from
    the checkpoint's mirror slices, and a `replication` > 1 checkpoint
    comes back with live replicas."""
    from raft_tpu_torch.comms.mnmg_rabitq import DistributedIvfRabitq
    from raft_tpu_torch.neighbors import ivf_rabitq as ivf_rabitq_mod

    faults.fault_point("mnmg_ckpt.load", rank=_process_index_count()[0])
    arrays, meta = _load_verified(filename, "codes", extra_healable={"aux": "replica_aux"})
    if meta.get("kind") != "mnmg_ivf_rabitq":
        raise ValueError(f"not a distributed ivf_rabitq file: {meta.get('kind')}")
    r = comms.get_size()
    host_gids = np.asarray(arrays["host_gids"])
    list_sizes = np.asarray(arrays["list_sizes"])
    codes, gids, sizes = _load_rank_tables(_as_i32(np.asarray(arrays["codes"])), host_gids,
                                           list_sizes, int(meta["n_ranks"]), r, comms.device)
    # the correction table re-shards under the same gid permutation
    aux, _, _ = _load_rank_tables(np.asarray(arrays["aux"]), host_gids, list_sizes,
                                  int(meta["n_ranks"]), r, comms.device)
    params = ivf_rabitq_mod.IndexParams(n_lists=int(meta["n_lists"]),
                                        metric=DistanceType(meta["metric"]),
                                        store_dataset=False)
    spans = comms.spans_processes()
    return _reattach_replicas(DistributedIvfRabitq(
        comms, params, comms.replicate(np.asarray(arrays["rotation"])),
        comms.replicate(np.asarray(arrays["centers"])),
        _place_rank_major(comms, codes), _place_rank_major(comms, aux),
        _place_rank_major(comms, gids), int(meta["n"]),
        host_gids=None if spans else gids,
        list_sizes=None if spans else sizes.astype(np.int32),
        bridged=bool(meta.get("bridged", False))), meta)


def _pq_params_from_meta(meta):
    from raft_tpu_torch.neighbors import ivf_pq as ivf_pq_mod

    return ivf_pq_mod.IndexParams(
        n_lists=int(meta["n_lists"]), pq_dim=int(meta["pq_dim"]),
        pq_bits=int(meta.get("pq_bits", 8)), metric=DistanceType(meta["metric"]),
        codebook_kind=(ivf_pq_mod.PER_CLUSTER if meta.get("per_cluster")
                       else ivf_pq_mod.PER_SUBSPACE))


def ivf_pq_load(comms: Comms, filename: str) -> DistributedIvfPq:
    """Load a distributed IVF-PQ index, single-file (`ivf_pq_save`) or
    sharded (`ivf_pq_save_local`), re-sharded onto this session's world.
    The stored rank count must be a multiple of the world size: the ranks
    of one world rank merge by concatenating their per-list slots.
    Checksum-verified with mirror healing (see ivf_flat_load)."""
    faults.fault_point("mnmg_ckpt.load", rank=_process_index_count()[0])
    # the tables go from the host to their ranks' devices one block at a
    # time, never whole onto one device
    arrays, meta = _load_verified(filename, "codes")
    spans = comms.spans_processes()
    quant = [comms.replicate(np.asarray(arrays[f]))
             for f in ("rotation", "centers", "pq_centers")] if "rotation" in arrays else None
    if meta.get("kind") == "mnmg_ivf_pq_sharded":
        codes_l, gids_l, sizes_l = _load_local_tables(comms, filename, meta)
        return _reattach_replicas(DistributedIvfPq(
            comms, _pq_params_from_meta(meta), *quant,
            comms.shard_from_local(codes_l, axis=0),
            comms.shard_from_local(gids_l.copy(), axis=0), int(meta["n"]),
            host_gids=None if spans else gids_l, list_sizes=None if spans else sizes_l,
            extended=bool(meta.get("extended", False)),
            local_gids=gids_l, local_sizes=sizes_l), meta)
    if meta.get("kind") != "mnmg_ivf_pq":
        raise ValueError(f"not a distributed ivf_pq file: {meta.get('kind')}")
    codes, gids, sizes = _load_rank_tables(
        np.asarray(arrays["codes"]), np.asarray(arrays["host_gids"]),
        np.asarray(arrays["list_sizes"]), int(meta["n_ranks"]), comms.get_size(),
        comms.device)
    local_gids, local_sizes = _local_mirror_slices(comms, gids, sizes)
    return _reattach_replicas(DistributedIvfPq(
        comms, _pq_params_from_meta(meta), *quant,
        _place_rank_major(comms, codes), _place_rank_major(comms, gids), int(meta["n"]),
        host_gids=None if spans else gids,
        list_sizes=None if spans else sizes.astype(np.int32),
        extended=bool(meta.get("extended", False)),
        bridged=bool(meta.get("bridged", False)),
        local_gids=local_gids, local_sizes=local_sizes), meta)
