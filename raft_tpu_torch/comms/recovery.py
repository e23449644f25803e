"""Self-healing recovery of the distributed indexes (counterpart of
raft_tpu/comms/recovery.py): re-materialize lost shards, verify the
world, and flip rejoining ranks live again.

The failure lifecycle (replication.py holds the failover half):

    healthy --(fault)--> degraded, failover serves replica copies
            --(repair)--> primaries re-materialized on the sick rank
            --(rank_rejoin)--> verified barrier, mask flips healthy
            --> healthy again, primaries serve, mirrors coherent

`repair` is the data-plane heal: every unhealthy rank's primary tables
are rewritten from its elected holder's replica copy (the failover patch,
applied to the index itself so the healed primaries persist), then the
mirrors derive again from the healed primaries, so the next failure finds
coherent replicas. A shard with no surviving copy (more than r-1
failures, or stale mirrors) falls back to `resilience.rehydrate` from a
checkpoint, which returns a fresh index.

`rank_rejoin` is the control-plane heal: a verified `health_barrier`
proves the world answers collectives end to end, and only then does the
rank's mask bit flip healthy.

Both land obs events ("repair", "rejoin"), so a chaos drill leaves an
auditable heal timeline beside the fault and health events.
"""

from __future__ import annotations

from typing import Optional, Tuple

from raft_tpu_torch import obs
from raft_tpu_torch.comms import replication
from raft_tpu_torch.comms.comms import Comms
from raft_tpu_torch.core.logger import logger


class RecoveryError(RuntimeError):
    """A lost shard could not be re-materialized: no surviving replica
    holder and no checkpoint to rehydrate from."""


def lost_ranks(index, health) -> Tuple[int, ...]:
    """Unhealthy ranks whose shard has no surviving (healthy, non-stale)
    replica holder: the ones only a checkpoint can bring back."""
    replicas = getattr(index, "replicas", None)
    stale = replication.stale_holders()
    out = []
    for u in range(health.world):
        if bool(health.mask[u]):
            continue
        if replicas is None or replicas.placement.elect(u, health, stale=stale) is None:
            out.append(int(u))
    return tuple(out)


def repair(comms: Comms, health, index, checkpoint: Optional[str] = None):
    """Re-materialize every unhealthy rank's shard. Replica-repairable
    ranks heal from their elected holders' copies (in place: the index's
    primary tables are rewritten and its mirrors derived again); ranks with
    no surviving copy fall back to `resilience.rehydrate(checkpoint)`, and
    without a checkpoint raise `RecoveryError`. Returns the healed index
    (the same object after a replica repair, a fresh one after
    rehydration). `health` is not modified: flipping masks is
    `rank_rejoin`'s job, after the barrier proves the rank back."""
    if not health.degraded:
        return index
    lost = lost_ranks(index, health)
    if lost:
        if checkpoint is None:
            raise RecoveryError(
                f"ranks {list(lost)} have no surviving replica copy "
                f"(r={getattr(getattr(index, 'replicas', None), 'r', 1)}) "
                "and no checkpoint was given to rehydrate from")
        from raft_tpu_torch.comms.resilience import rehydrate

        logger.warning("repair: ranks %s lost every replica copy; rehydrating from %r",
                       list(lost), checkpoint)
        fresh, _ = rehydrate(comms, checkpoint)
        r = getattr(getattr(index, "replicas", None), "r", 1)
        if r > 1:
            replication.replicate_index(fresh, r)
        obs.event("repair", source="checkpoint", ranks=list(lost), checkpoint=str(checkpoint))
        return fresh
    replicas = index.replicas
    stale = replication.stale_holders()
    assignment = replicas.placement.assignment(health, stale=stale)
    moves = tuple(sorted((u, h, replicas.placement.slot(h, u)) for u, h in assignment.items()))
    for name in replication._replicated_attrs(index):
        setattr(index, name, replication.patch_tables(comms, getattr(index, name),
                                                      replicas.tables[name], moves))
    replication._reset_derived_stores(index)
    # the healed rank's hosted replica slots are as suspect as its primary
    # was: derive every mirror again from the healed primaries (dropping
    # the old ShardReplicas first, with its cached failover views)
    index.replicas = None
    replication.replicate_index(index, replicas.r)
    for u, h in sorted(assignment.items()):
        obs.event("repair", source="replica", rank=u, holder=h)
    return index


def rank_rejoin(comms: Comms, health, rank: int, timeout_s: float = 30.0):
    """Flip `rank` healthy after a verified world barrier (the deadline
    `health_barrier`): the barrier must complete, proving the world,
    rejoining rank included, answers collectives, before the mask bit
    flips. Returns the updated health; a barrier timeout propagates as
    `HealthCheckTimeout` and the mask stays degraded."""
    from raft_tpu_torch.comms.resilience import health_barrier

    elapsed = health_barrier(comms, timeout_s=timeout_s)
    health.mark_healthy(rank)
    obs.event("rejoin", rank=int(rank), barrier_s=elapsed, coverage=health.coverage())
    return health


def heal(comms: Comms, health, index, checkpoint: Optional[str] = None,
         timeout_s: float = 30.0):
    """The heal loop in one call: `repair` every unhealthy rank's shard,
    then rejoin them behind one verified barrier (one world barrier proves
    every rejoining rank; per-rank barriers would multiply the latency).
    Returns `(index, health)`: the index possibly fresh (rehydration),
    health fully healthy on success."""
    from raft_tpu_torch.comms.resilience import health_barrier

    if not health.degraded:
        return index, health
    index = repair(comms, health, index, checkpoint=checkpoint)
    dead = [int(x) for x in range(health.world) if not health.mask[x]]
    elapsed = health_barrier(comms, timeout_s=timeout_s)
    for u in dead:
        health.mark_healthy(u)
        obs.event("rejoin", rank=u, barrier_s=elapsed, coverage=health.coverage())
    return index, health
