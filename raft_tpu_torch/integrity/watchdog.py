"""Quarantine and repair: the containment half of the integrity story
(counterpart of the single-device half of raft_tpu/integrity/watchdog.py).

`IntegrityWatchdog` wraps a `Scrubber` in the serve-loop contract: one
bounded slice per `step(index)`, and when a slice names a bad list the
watchdog masks it at once through the tombstone path (every engine skips
dead slots, so the quarantined index serves bit for bit like one that
never held those rows, and `coverage()` reports the loss), then repairs
between batches through a pluggable `repair` callable
(`checkpoint_repairer`: the mutation root's checkpoint and log). A
repaired index is digest-verified (`digest.check_fresh`) before it
replaces the quarantined one; a repair that fails verification is
refused and the quarantine stands.

Quarantine masks every slot of the bad list, not just the live ones: the
rot may sit in `slot_rows` itself, so occupancy cannot be trusted.

Rot of a distributed index is per rank, not per list (its primaries are
rank-major blocks): `mnmg_digests` takes one digest per (table, rank),
`verify_mnmg` names the rotted ranks, and `repair_ranks` restores them
from their ring mirrors through the heal loop (`comms.recovery.heal`).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Set

import numpy as np

from raft_tpu_torch import obs
from raft_tpu_torch.integrity import digest
from raft_tpu_torch.integrity.scrub import ROT_SITE, Scrubber


def quarantine(index, list_id: int, kind: Optional[str] = None):
    """Mask every slot of `list_id` dead on a clone (the old object keeps
    serving). Returns the new index: its tombstone digests refresh through
    the normal path, while the rotted payload rows keep their stale,
    mismatching digests on purpose (the scrubber skips quarantined lists).
    Derived stores are dropped, so no search reads a stale one."""
    from raft_tpu_torch.neighbors import mutation

    kind = kind or digest.kind_of(index)
    mask = mutation._tomb_mask(index).clone()
    mask[int(list_id), :] = True
    out = mutation._clone(index)
    out.tombstones = mask
    mutation._drop_derived(out)
    digest.refresh(out, index, kind)
    if obs.enabled():
        obs.counter("integrity.quarantines").inc()
        obs.event("integrity.quarantine", list=int(list_id))
    return out


def checkpoint_repairer(root: str, device=None) -> Callable:
    """Repair callable for local serving: rebuild the index from the
    mutation root's checkpoint and log (integrity.restore) at the log's
    committed state, on `device` (default: the damaged index's). A serve
    loop with uncommitted batches should commit before repair. The
    watchdog verifies the restored index before swapping it in."""
    def _repair(index):
        from raft_tpu_torch.integrity.restore import restore

        dev = device if device is not None else index.device
        restored, _ = restore(root, verify=True, device=dev)
        return restored

    return _repair


class IntegrityWatchdog:
    """Serve-side integrity loop. `step(index)` runs one scrub slice and
    handles any mismatch; it returns the index to serve next: the one
    passed in, a quarantined clone on detection, or a verified repair.
    `coverage()` in [0, 1] is the share of lists not quarantined."""

    def __init__(self, kind: Optional[str] = None, *, budget_lists: int = 8,
                 repair: Optional[Callable] = None):
        self.scrubber = Scrubber(kind, budget_lists=budget_lists)
        self.repair = repair
        self.quarantined: Set[int] = set()
        self.table_alarms: Set[str] = set()
        self.repairs = 0
        self.failed_repairs = 0
        self._n_lists = 0

    def coverage(self) -> float:
        if not self.quarantined:
            return 1.0
        n = max(int(self._n_lists), 1)
        return max(0.0, 1.0 - len(self.quarantined) / n)

    def step(self, index):
        """One watchdog tick (call between serve batches)."""
        kind = self.scrubber.kind or digest.kind_of(index)
        self._n_lists = int(index.n_lists)
        bad = self.scrubber.slice_scan(index, skip=self.quarantined)
        for field, lid in bad:
            if lid < 0:
                # table rot has no smaller mask than repair: keep the alarm
                self.table_alarms.add(field)
                continue
            if lid in self.quarantined:
                continue
            index = quarantine(index, lid, kind)
            self.quarantined.add(lid)
        if (self.quarantined or self.table_alarms) and self.repair is not None:
            index = self._try_repair(index, kind)
        return index

    def _try_repair(self, index, kind: str):
        try:
            repaired = self.repair(index)
            if repaired is None:
                return index
            digest.check_fresh(repaired, kind)
        except Exception as e:  # noqa: BLE001 -- the quarantine outlives a failed repair
            self.failed_repairs += 1
            if obs.enabled():
                obs.counter("integrity.failed_repairs").inc()
                obs.event("integrity.repair", ok=False, error=str(e)[:200])
            return index
        self.repairs += 1
        if obs.enabled():
            obs.counter("integrity.repairs").inc()
            obs.event("integrity.repair", ok=True, lists=sorted(self.quarantined),
                      tables=sorted(self.table_alarms))
        self.quarantined.clear()
        self.table_alarms.clear()
        self._n_lists = int(repaired.n_lists)
        return repaired


# ---------------------------------------------------------------------------
# distributed indexes: per-rank shard digests and mirror repair
# ---------------------------------------------------------------------------


def mnmg_digests(index) -> Dict[str, np.ndarray]:
    """One CRC-32C per (mirrored table, rank) over the rank-major primary
    shards: the distributed sidecar, per rank because that is the repair
    granularity the mirrors provide."""
    from raft_tpu_torch.comms.replication import _replicated_attrs
    from raft_tpu_torch.core.serialize import crc32c

    out: Dict[str, np.ndarray] = {}
    for name in _replicated_attrs(index):
        arr = getattr(index, name)
        out[name] = np.asarray([crc32c(np.ascontiguousarray(b.detach().cpu().numpy()))
                                for b in arr.blocks], np.uint32)
    return out


def verify_mnmg(index, baseline: Dict[str, np.ndarray]) -> List[int]:
    """Hash the shards again against a `mnmg_digests` baseline; returns the
    sorted rotted ranks (a mismatch in any table convicts the rank)."""
    bad: Set[int] = set()
    current = mnmg_digests(index)
    for name, want in baseline.items():
        got = current.get(name)
        if got is None or got.shape != np.asarray(want).shape:
            bad.update(range(int(index.comms.get_size())))
            continue
        bad.update(int(r) for r in np.flatnonzero(got != np.asarray(want)))
    if obs.enabled():
        obs.counter("integrity.scans").inc()
        for r in sorted(bad):
            obs.counter("integrity.mismatches").inc()
            obs.event("integrity.mismatch", field="shard", rank=int(r))
    return sorted(bad)


def rot_rank(index, rank: int, *, frac: float = 0.05, seed: int = 0) -> None:
    """Rot one rank's primary payload shard (a drill helper; the
    FaultPlan-driven form seeds through `maybe_rot_mnmg`): the low byte of
    a seeded `frac` of its cells flips, on a fresh block, so objects that
    share the old block (failover views, earlier indexes) keep it."""
    import torch

    from raft_tpu_torch.comms.comms import ShardedArray
    from raft_tpu_torch.comms.replication import _replicated_attrs

    name = _replicated_attrs(index)[0]  # the payload table
    arr = getattr(index, name)
    blocks = list(arr.blocks)
    local = index.comms.local_ranks()
    b = blocks[local.index(int(rank))]
    host = np.ascontiguousarray(b.detach().cpu().numpy()).copy()
    rng = np.random.default_rng(seed)
    cells = host.reshape(-1)
    n = max(1, int(frac * cells.size))
    sel = rng.choice(cells.size, size=min(n, cells.size), replace=False)
    view = cells.view(np.uint8).reshape(cells.size, host.itemsize)
    view[sel, 0] ^= 0xFF
    blocks[local.index(int(rank))] = torch.from_numpy(host).to(b.device)
    setattr(index, name, ShardedArray(blocks, arr.dim, index.comms.get_size()))
    if obs.enabled():
        obs.counter("integrity.rot_injected").inc()
        obs.event("integrity.rot", field=name, rank=int(rank))


def maybe_rot_mnmg(index, *, salt: int = 0) -> List[int]:
    """FaultPlan-driven rot of a distributed index's shards at
    ``integrity.table.rot`` (`corrupt_shard` faults; `rank` picks the
    victim, -1 draws one seeded). Returns the rotted ranks."""
    from raft_tpu_torch.core import faults

    plan = faults.active_plan()
    if plan is None:
        return []
    hits = plan.matching(ROT_SITE, "corrupt_shard")
    if not hits:
        return []
    world = int(index.comms.get_size())
    rotted: List[int] = []
    for fi, f in enumerate(hits):
        rng = np.random.default_rng((plan.site_seed(ROT_SITE), salt, fi))
        rank = int(f.rank) if f.rank >= 0 else int(rng.integers(world))
        rot_rank(index, rank, frac=max(float(f.fraction), 1e-3),
                 seed=int(rng.integers(1 << 31)))
        rotted.append(rank)
    return sorted(set(rotted))


def repair_ranks(index, ranks, checkpoint: Optional[str] = None, timeout_s: float = 30.0):
    """Mirror repair of rotted ranks: a RankHealth with the convicted ranks
    unhealthy runs the heal loop (the replica patch, the checkpoint
    rehydration fallback, one verified barrier). Returns the repaired
    index."""
    from raft_tpu_torch.comms import recovery
    from raft_tpu_torch.comms.resilience import RankHealth

    health = RankHealth.all_healthy(int(index.comms.get_size()))
    for r in ranks:
        health.mark_unhealthy(int(r))
    index, _ = recovery.heal(index.comms, health, index, checkpoint=checkpoint,
                             timeout_s=timeout_s)
    if obs.enabled():
        obs.counter("integrity.repairs").inc()
        obs.event("integrity.repair", ok=True, ranks=sorted(int(r) for r in ranks))
    return index
