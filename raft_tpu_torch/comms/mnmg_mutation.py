"""Rank-local online mutation of the distributed indexes (counterpart of
raft_tpu/comms/mnmg_mutation.py).

The Distributed* layouts carry global row ids in `slot_gids` (-1 = pad),
and every per-rank engine scores a -1 slot as the worst value, the
mechanism the single-device tombstones ride (neighbors/mutation). So
distributed mutation is an elementwise transform of the gid tables:

- **delete**: gids in the victim set become -1 on the primary
  `slot_gids`, on the r-way replica mirror (`replicas.tables`) and on the
  host mirrors (`host_gids`, `local_gids`). An elementwise map commutes
  with the ring placement that built the mirrors, so every copy stays
  coherent with no collective: each rank masks the blocks it holds.
- **upsert**: delete the old ids, append through the distributed extend
  (which mirrors again, `_carry_replication`), then remap the fresh tail
  gid block [old_n, old_n + n) onto the caller's ids, elementwise again.

Payload tables (`list_data` / `codes` / `aux`) are untouched by deletes:
dead slots keep their rows but never win a merge. Cached failover views
and the gid-derived stores (`_GID_DERIVED`) are dropped; they rebuild
from the mutated tables at the next degraded or fused search.

The serve layer defers mutation while the health mask is degraded, so a
masked rank never misses one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.comms.mnmg_common import _host_np, _map_blocks

#: gid-derived lazy stores that must rebuild after a gid transform
_GID_DERIVED = ("slot_gids_pad", "_refine_cache", "_id_bound")


def _clone(index):
    import copy
    import dataclasses

    out = copy.copy(index)
    rep = getattr(index, "replicas", None)
    if rep is not None:
        out.replicas = dataclasses.replace(rep, tables=dict(rep.tables), _views={})
    return out


def _map_gids(index, fn, host_fn):
    """Apply an elementwise gid transform to every copy of the gid tables:
    the primary, the replica mirror (each rank's blocks, in place on its
    device) and the host mirrors. `fn` maps an int32 tensor block,
    `host_fn` an int32 numpy array."""
    out = _clone(index)
    out.slot_gids = _map_blocks(fn, index.slot_gids)
    rep = getattr(out, "replicas", None)
    if rep is not None and "slot_gids" in rep.tables:
        rep.tables["slot_gids"] = _map_blocks(fn, rep.tables["slot_gids"])
    for name in ("host_gids", "local_gids"):
        tbl = getattr(index, name, None)
        if tbl is not None:
            setattr(out, name, host_fn(_host_np(tbl)))
    for name in _GID_DERIVED:
        if hasattr(out, name):
            setattr(out, name, None)
    return out


def delete(index, ids):
    """Mask every slot holding one of `ids` to the pad sentinel across all
    copies; returns the new index (the input object is untouched, so
    in-flight searches keep their gid tables)."""
    ids = np.unique(np.asarray(ids, np.int64).ravel())

    def fn(g):
        victims = torch.as_tensor(ids, dtype=g.dtype, device=g.device)
        return torch.where(torch.isin(g, victims), torch.full_like(g, -1), g)

    def host_fn(g):
        return np.where(np.isin(g, ids), -1, g).astype(g.dtype)

    out = _map_gids(index, fn, host_fn)
    if obs.enabled():
        obs.counter("mutation.tombstones").inc(int(ids.size))
        obs.event("mutation", op="delete", index_kind="mnmg", n=int(ids.size))
    return out


def _remap_tail(index, old_n: int, new_ids: np.ndarray):
    """Rewrite the freshly appended gid block [old_n, old_n + n) onto the
    caller's ids, every copy. Extend assigns the block in batch order (gid
    old_n + i is batch row i), so the lookup is a gather."""
    lut = np.asarray(new_ids, np.int64)
    n = lut.shape[0]

    def fn(g):
        fresh = (g >= old_n) & (g < old_n + n)
        src = (g.long() - old_n).clamp(0, max(n - 1, 0))
        return torch.where(fresh, torch.as_tensor(lut, device=g.device)[src].to(g.dtype), g)

    def host_fn(g):
        fresh = (g >= old_n) & (g < old_n + n)
        src = np.clip(g.astype(np.int64) - old_n, 0, max(n - 1, 0))
        return np.where(fresh, lut[src], g).astype(g.dtype)

    return _map_gids(index, fn, host_fn)


def upsert(index, kind: str, vectors, ids: Optional[np.ndarray] = None):
    """Distributed upsert: retire the old ids, append through the
    distributed extend (the replicas mirror again inside it), then remap
    the fresh tail gids onto the caller's ids. `ids=None` is a pure insert
    (extend's own fresh gids stand). Returns the new index."""
    from raft_tpu_torch.comms.mnmg_common import _rows
    from raft_tpu_torch.comms.mnmg_ivf_build import ivf_flat_extend, ivf_pq_extend

    if kind == "ivf_flat":
        extend = ivf_flat_extend
    elif kind == "ivf_pq":
        extend = ivf_pq_extend
    else:
        # DistributedIvfRabitq has no distributed extend: refuse loudly
        # instead of dropping the rows
        raise NotImplementedError(
            f"distributed upsert is not available for {kind!r}: no "
            "distributed extend exists (deletes work; rebuild or use "
            "the single-chip mutation path for upserts)")
    vectors = _rows(vectors)
    if ids is not None:
        ids = np.asarray(ids, np.int64).ravel()
        if ids.shape[0] != vectors.shape[0]:
            raise ValueError(f"{vectors.shape[0]} vectors but {ids.shape[0]} ids")
        index = delete(index, ids)
    old_n = int(index.n)
    out = extend(index, vectors)
    if ids is not None:
        out = _remap_tail(out, old_n, ids)
    if obs.enabled():
        obs.counter("mutation.upserts").inc(int(vectors.shape[0]))
        obs.event("mutation", op="upsert", index_kind="mnmg", n=int(vectors.shape[0]))
    return out


def apply_batch(index, kind: str, batch: tuple):
    """Apply one `neighbors.mutation.MutationFeed` batch to a distributed
    index, returning the new index. Rebalance is a no-op at this scale:
    deletes leave masked holes the per-rank stores carry until a rebuild."""
    op = batch[0]
    if op == "upsert":
        return upsert(index, kind, batch[1], batch[2])
    if op == "delete":
        return delete(index, batch[1])
    if op == "rebalance":
        return index
    raise ValueError(f"unknown mutation op {op!r}")
