"""r-way shard replication (counterpart of raft_tpu/comms/replication.py):
ring placement, the deterministic failover election, the device mirrors
of the distributed IVF indexes and the cached failover views their
searches consult, and the row-sharded failover of the brute-force k-NN.

Ring placement: rank i's shard is mirrored onto holders i+1, ...,
i+(r-1) (mod world), so r copies of every shard exist and any r-1
simultaneous failures leave a survivor. At search time the first healthy,
non-stale holder in ring order is elected for every unhealthy rank, and
the search answers as a fully healthy world does: bit for bit, coverage
1.0, the rank listed in `repaired_ranks`.

`core.faults` site "replica.stale": a `kill_rank` fault there declares a
rank's hosted replica copies unusable (a stale mirror) without killing
the rank; elections skip stale holders, and a shard whose every holder is
dead or stale falls back to the degraded path.

Mirrors and patches are per-rank bodies over the comms world: at build
(`replicate_index`) every rank sends its primary block of each mirrored
table to its r-1 holders once; a failover patch (`patch_tables`) sends an
elected holder's copy to the dead rank, which takes it as its primary
block. The patched view is cached per failure pattern (`failover_view`):
the first degraded search after a failure pays one patch, later ones
cost what a healthy search costs. Memory is the classic r-way trade:
each rank holds its shard and r-1 mirror copies.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import faults
from raft_tpu_torch.comms.comms import Comms, P

STALE_SITE = "replica.stale"


@dataclasses.dataclass(frozen=True)
class ReplicaPlacement:
    """Deterministic ring placement of r copies of every shard over a
    `world`-rank world: rank i's primary shard is mirrored onto holders
    i+1, ..., i+(r-1) (mod world); equivalently rank i hosts replica slot
    m of rank (i-1-m)'s shard. r=1 means no replication."""

    world: int
    r: int

    def __post_init__(self):
        if not (1 <= self.r <= self.world):
            raise ValueError(
                f"replication factor r={self.r} must be in [1, world="
                f"{self.world}]"
            )

    def holders(self, rank: int) -> Tuple[int, ...]:
        """Ranks holding a replica of `rank`'s shard, in election order."""
        return tuple((rank + 1 + m) % self.world for m in range(self.r - 1))

    def hosted(self, rank: int) -> Tuple[int, ...]:
        """Shard owners whose replicas `rank` hosts; the index in the
        tuple is the replica slot: slot m holds rank (rank-1-m)'s shard."""
        return tuple((rank - 1 - m) % self.world for m in range(self.r - 1))

    def slot(self, holder: int, shard: int) -> int:
        """Replica slot of `shard`'s copy on `holder` (raises if the holder
        hosts none)."""
        m = (holder - 1 - shard) % self.world
        if not (0 <= m < self.r - 1):
            raise ValueError(
                f"rank {holder} holds no replica of shard {shard} "
                f"(r={self.r})"
            )
        return m

    def elect(self, shard: int, health, stale: Tuple[int, ...] = ()) -> Optional[int]:
        """The first healthy, non-stale holder of `shard` in ring order,
        or None when no survivor remains."""
        for h in self.holders(shard):
            if bool(health.mask[h]) and h not in stale:
                return h
        return None

    def assignment(self, health, stale: Tuple[int, ...] = ()) -> Dict[int, int]:
        """{dead rank: elected holder} for every unhealthy rank with a
        surviving holder (a pure function of placement, mask and stale)."""
        out: Dict[int, int] = {}
        for u in range(self.world):
            if bool(health.mask[u]):
                continue
            h = self.elect(u, health, stale=stale)
            if h is not None:
                out[int(u)] = int(h)
        return out


def stale_holders(plan: Optional[faults.FaultPlan] = None) -> Tuple[int, ...]:
    """Ranks whose hosted replica copies the (installed or passed) fault
    plan declares stale: `kill_rank` faults at site "replica.stale"."""
    plan = plan if plan is not None else faults.active_plan()
    if plan is None:
        return ()
    return plan.killed_ranks(STALE_SITE)


@dataclasses.dataclass
class ShardReplicas:
    """The mirror state attached to a Distributed* index: `tables` maps
    each mirrored primary attribute to its (R, r-1, ...) sharded mirror
    (slot m of rank j is rank (j-1-m)'s primary block), and `_views`
    caches failover views per failure pattern."""

    placement: ReplicaPlacement
    tables: Dict[str, Any]
    _views: dict = dataclasses.field(default_factory=dict)

    @property
    def r(self) -> int:
        return self.placement.r


def _mirror_fn(comms: Comms, r: int, qcfg=None):
    """The mirror body of a world: each rank's (1, ...) primary block goes
    to its r-1 ring holders (out[j, m] = in[(j-1-m) % R]), stacked into
    its (1, r-1, ...) replica block.

    With a resolved `qcfg` (comms/quantized.QuantConfig) on a float
    table the fan-out ships the block-quantized encoding (int8 payload
    plus f32 scales, decoded at the holder) or bf16, so the stored
    replica carries codec error and a failover from it is no longer bit
    for bit (see `mirror_table`)."""
    R = comms.get_size()
    perms = [[(i, (i + 1 + m) % R) for i in range(R)] for m in range(r - 1)]

    def body(ac, a):
        outs = []
        if qcfg is not None and qcfg.mode == "int8":
            from raft_tpu_torch.comms import quantized

            rank = ac.get_rank()
            qa, sc = quantized.quantize_blocks(a, qcfg.block)
            sc = faults.corrupt_in_trace(quantized.ENCODE_SITE, sc, rank)
            for perm in perms:
                qy = ac._ppermute(qa, perm)
                scy = faults.corrupt_in_trace(quantized.DECODE_SITE, ac._ppermute(sc, perm),
                                              rank)
                outs.append(quantized.dequantize_blocks(qy, scy, a.shape, a.dtype))
        elif qcfg is not None and qcfg.mode == "bf16":
            ab = a.to(torch.bfloat16)
            outs = [ac._ppermute(ab, perm).to(a.dtype) for perm in perms]
        else:
            outs = [ac._ppermute(a, perm) for perm in perms]
        return torch.stack(outs, dim=1)

    def run(a):
        return comms.run(body, a, in_specs=P(comms.axis), out_specs=P(comms.axis),
                         keep_blocks=True)

    return run


def mirror_table(comms: Comms, arr, r: int, quantization=None):
    """Mirror a (R, ...) rank-major sharded table onto its ring replica
    holders; returns the (R, r-1, ...) sharded replica array.

    `quantization` (None | "off" | "int8" | "bf16" | "auto" | a resolved
    QuantConfig; comms/quantized.resolve) opts the fan-out into
    block-scaled wire transport. The default (None) keeps the mirror byte
    exact, which the lossless-failover contract (bit for bit, coverage
    1.0) rests on. Integer tables (codes, slot_gids) are never quantized."""
    qcfg = None
    if quantization is not None and quantization != "off":
        from raft_tpu_torch.comms import quantized

        qcfg = quantized.resolve(quantization, comms.device)
    if qcfg is not None and not arr.dtype.is_floating_point:
        qcfg = None  # integer tables always exact (the failover id contract)
    if qcfg is not None and obs.enabled():
        from raft_tpu_torch.comms import quantized

        n = 1
        for dim in arr.shape:
            n *= int(dim)
        n //= comms.get_size()  # per-rank primary block
        if qcfg.mode == "int8":
            wire, wdt = (r - 1) * quantized.packet_bytes(n, qcfg.block), "int8+f32-scales"
        else:
            wire, wdt = (r - 1) * n * 2, "bfloat16"
        obs.collective("mirror", arr, axis=comms.axis, world=comms.get_size(),
                       wire_bytes=wire, wire_dtype=wdt)
    return _mirror_fn(comms, r, qcfg)(arr)


def _patch_fn(comms: Comms, moves: Tuple[Tuple[int, int, int], ...]):
    """The failover-patch body of an assignment: for each static (dead,
    holder, slot) move the holder's replica copy goes to the dead rank,
    which takes it as its primary block; healthy ranks keep theirs."""
    by_slot: Dict[int, list] = {}
    for dead, holder, m in moves:
        by_slot.setdefault(m, []).append((holder, dead))

    def body(ac, p, rp):
        rank = ac.get_rank()
        out = p
        for m, pairs in sorted(by_slot.items()):
            moved = ac._ppermute(rp[:, m].contiguous(), pairs)
            if any(rank == u for _, u in pairs):
                out = moved
        return out

    def run(primary, rep):
        return comms.run(body, primary, rep, in_specs=P(comms.axis), out_specs=P(comms.axis),
                         keep_blocks=True)

    return run


def patch_tables(comms: Comms, primary, rep, moves: Tuple[Tuple[int, int, int], ...]):
    """Re-materialize dead ranks' primary blocks from their elected
    holders' replica copies (`moves` = static (dead, holder, slot)
    triples). Returns the patched (R, ...) sharded table: blocks bit for
    bit the primaries before the failure."""
    return _patch_fn(comms, moves)(primary, rep)


# -- index integration -------------------------------------------------

def _replicated_attrs(index) -> Tuple[str, ...]:
    """The primary tables a Distributed* index mirrors (the rank-major
    sharded arrays a shard failure loses)."""
    if hasattr(index, "aux"):  # DistributedIvfRabitq
        return ("codes", "aux", "slot_gids")
    if hasattr(index, "codes"):  # DistributedIvfPq
        return ("codes", "slot_gids")
    return ("list_data", "slot_gids")  # DistributedIvfFlat


def replicate_index(index, r: int, quantization=None):
    """Attach r-way ring replicas to a built or loaded Distributed* index
    (idempotent per r; r=1 detaches): every rank ships its block of each
    mirrored table to its r-1 holders once, here; a failover later costs
    one patch per failure pattern. `quantization` opts the float mirror
    tables into block-scaled wire transport (see `mirror_table`); the
    default keeps every mirror byte exact and failover bit for bit."""
    comms = index.comms
    if r == 1:
        index.replicas = None
        return index
    placement = ReplicaPlacement(comms.get_size(), int(r))
    existing = getattr(index, "replicas", None)
    if existing is not None and existing.placement == placement:
        return index
    tables = {name: mirror_table(comms, getattr(index, name), placement.r,
                                 quantization=quantization)
              for name in _replicated_attrs(index)}
    index.replicas = ShardReplicas(placement, tables)
    if obs.enabled():
        obs.event("replication", action="mirror", r=placement.r, world=placement.world)
    return index


def _health_key(health, stale: Tuple[int, ...]) -> tuple:
    return (health.mask.tobytes(), stale)


def failover_view(index, health):
    """The search-time entry point: given a (possibly degraded)
    `RankHealth`, return `(search_index, effective_health,
    repaired_ranks)`.

    - healthy mask or no replicas: the index and mask pass through;
    - degraded with surviving holders: a cached view of the index whose
      primary tables have each dead rank's shard re-materialized from its
      elected holder's copy, and an effective mask in which those ranks
      count healthy, so the answer is the all-healthy one bit for bit at
      coverage 1.0. Failures past r-1 stay masked (the degraded path)."""
    replicas = getattr(index, "replicas", None)
    if health is None or not health.degraded or replicas is None:
        return index, health, ()
    if health.world != replicas.placement.world:
        # a mis-sized mask passes through to _resolve_health's reject
        return index, health, ()
    from raft_tpu_torch.comms.resilience import RankHealth

    stale = stale_holders()
    key = _health_key(health, stale)
    cached = replicas._views.get(key)
    if cached is not None:
        view, eff_mask, repaired = cached
        return view, RankHealth(eff_mask.copy()), repaired
    assignment = replicas.placement.assignment(health, stale=stale)
    if not assignment:
        return index, health, ()
    comms = index.comms
    moves = tuple(sorted((u, h, replicas.placement.slot(h, u)) for u, h in assignment.items()))
    view = copy.copy(index)
    for name in _replicated_attrs(index):
        setattr(view, name, patch_tables(comms, getattr(index, name), replicas.tables[name],
                                         moves))
    _reset_derived_stores(view)
    view.replicas = None  # views never re-enter failover
    eff_mask = np.array(health.mask, copy=True)
    for u in assignment:
        eff_mask[u] = True
    repaired = tuple(sorted(assignment))
    for u, h in sorted(assignment.items()):
        obs.event("failover", rank=u, holder=h, slot=replicas.placement.slot(h, u))
    # each cached view pins full-size patched copies of the primary
    # tables: keep the current pattern and one predecessor only
    while len(replicas._views) >= 2:
        replicas._views.pop(next(iter(replicas._views)))
    replicas._views[key] = (view, eff_mask, repaired)
    return view, RankHealth(eff_mask.copy()), repaired


def failover_sharded_rows(comms: Comms, xs, replication: int, health):
    """Failover for the brute-force k-NN's row-sharded dataset. `knn`
    ships its shards from the caller's dataset on every call, so the
    dataset itself is the replica source: the ring placement only decides
    which dead ranks are coverable. Each unhealthy rank with a healthy,
    non-stale ring holder serves at full fidelity (its bit flips in the
    effective health); past r-1 failures the degraded path masks the
    shard as before. Returns `(xs, effective_health, repaired_ranks)`;
    pass-through when healthy or unreplicated."""
    if replication <= 1:
        return xs, health, ()
    placement = ReplicaPlacement(comms.get_size(), int(replication))
    if health is None or not health.degraded or health.world != placement.world:
        return xs, health, ()
    from raft_tpu_torch.comms.resilience import RankHealth

    stale = stale_holders()
    assignment = placement.assignment(health, stale=stale)
    if not assignment:
        return xs, health, ()
    eff_mask = np.array(health.mask, copy=True)
    for u in assignment:
        eff_mask[u] = True
    for u, h in sorted(assignment.items()):
        obs.event("failover", rank=u, holder=h, slot=placement.slot(h, u))
    return xs, RankHealth(eff_mask), tuple(sorted(assignment))


def _reset_derived_stores(index) -> None:
    """Clear the lazily built derived stores a table patch invalidates
    (they rebuild from the patched tables, so the rebuilt values match a
    never-failed index bit for bit). The JAX list leaves the RaBitQ
    bit-plane store (`codes_t`, `bp_meta`) standing while it clears its
    padded gid view, which its fused search then lacks; the port clears
    the three together."""
    for name in ("recon8", "recon_scale", "recon_norm", "resid_bf16", "resid_norm",
                 "slot_gids_pad", "codes_t", "bp_meta", "_refine_cache"):
        if hasattr(index, name):
            setattr(index, name, None)
