"""r-way shard replication (counterpart of raft_tpu/comms/replication.py),
the part the distributed brute-force k-NN needs: ring placement, the
deterministic failover election and the row-sharded failover.

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

Not yet here: the device mirrors and patches of the distributed IVF
indexes (`ShardReplicas`, `replicate_index`, `failover_view`), which come
with those indexes (the distributed IVF drivers).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np

from raft_tpu_torch import obs
from raft_tpu_torch.core import faults
from raft_tpu_torch.comms.comms import Comms

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
