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
"""

from __future__ import annotations

from typing import Callable, Optional, Set

from raft_tpu_torch import obs
from raft_tpu_torch.integrity import digest
from raft_tpu_torch.integrity.scrub import Scrubber


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
