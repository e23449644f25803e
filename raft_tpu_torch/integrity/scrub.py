"""Online scrubbing: bounded re-hash slices over a live index, and the
seeded table-rot injector the drills exercise it with (counterpart of
raft_tpu/integrity/scrub.py).

The scrubber only reads: it names bad (field, list) pairs and keeps a
resumable cursor; containment (quarantine) and repair are the watchdog's
(integrity/watchdog).

Fault sites:

- ``integrity.table.rot``: seeded in-memory rot of a live payload list,
  injected by `maybe_rot` under a `corrupt_shard` fault. The low byte of
  a seeded fraction of the victim row's elements flips (finite for
  floats), and no digest is refreshed: rot bypasses the mutation
  protocol.
- ``integrity.scrub.crash``: the SIGKILL window after a scrub-cursor
  commit. Only the name is here; its hook comes with the resumable scrub
  job stage.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import faults
from raft_tpu_torch.integrity import digest

#: fault sites (core.faults)
ROT_SITE = "integrity.table.rot"
SCRUB_CRASH_SITE = "integrity.scrub.crash"

#: the payload tables `maybe_rot` picks victims from, per kind (slot_rows
#: and tombstones rot is detected the same way; drills rot them through
#: `rot_list`)
_ROT_FIELDS = {
    "ivf_flat": ("list_data",),
    "ivf_pq": ("codes",),
    "ivf_rabitq": ("codes", "aux"),
}


def _flip_low_bytes(row: np.ndarray, frac: float, rng: np.random.Generator) -> np.ndarray:
    """A copy of one list row with the low byte of a seeded `frac` of its
    elements XOR-flipped (little-endian byte 0 of each element: mantissa
    bits for floats, value bits for ints)."""
    out = np.ascontiguousarray(row).copy()
    cells = out.reshape(-1)
    n = max(1, int(frac * cells.size))
    sel = rng.choice(cells.size, size=min(n, cells.size), replace=False)
    view = cells.view(np.uint8).reshape(cells.size, out.itemsize)
    view[sel, 0] ^= 0xFF
    return out


def rot_list(index, list_id: int, field: str, *, frac: float = 1.0, seed: int = 0):
    """Rot one list of one field of `index` in place (the drill helper;
    `maybe_rot` is the FaultPlan-driven one): the table is replaced by a
    copy on its device with that list's row rotted, the draws those of
    the JAX package. Derived stores are dropped, so the rotted bytes are
    what the scans read."""
    from raft_tpu_torch.neighbors import mutation

    arr = getattr(index, field)
    rng = np.random.default_rng(seed)
    lid = int(list_id)
    rotted = arr.clone()
    row = arr[lid].cpu().numpy()
    rotted[lid] = torch.from_numpy(_flip_low_bytes(row, frac, rng)).to(arr.device)
    setattr(index, field, rotted)
    mutation._drop_derived(index)
    if obs.enabled():
        obs.counter("integrity.rot_injected").inc()
        obs.event("integrity.rot", field=field, list=lid)


def maybe_rot(index, kind: Optional[str] = None, *, salt: int = 0) -> List[Tuple[str, int]]:
    """Seeded in-memory rot driven by the active FaultPlan: each
    `corrupt_shard` fault matching ``integrity.table.rot`` rots `count`
    seeded (payload field, list) victims at `fraction` of the row's
    elements. Returns the victim pairs, the same as the JAX package's for
    the same plan and `salt`."""
    plan = faults.active_plan()
    if plan is None:
        return []
    hits = plan.matching(ROT_SITE, "corrupt_shard")
    if not hits:
        return []
    kind = kind or digest.kind_of(index)
    n_lists = int(index.n_lists)
    victims: List[Tuple[str, int]] = []
    for fi, f in enumerate(hits):
        rng = np.random.default_rng((plan.site_seed(ROT_SITE), int(salt), fi))
        for _ in range(max(1, int(f.count))):
            field = _ROT_FIELDS[kind][int(rng.integers(len(_ROT_FIELDS[kind])))]
            lid = int(rng.integers(n_lists))
            rot_list(index, lid, field, frac=float(f.fraction), seed=int(rng.integers(1 << 31)))
            victims.append((field, lid))
    return victims


class Scrubber:
    """Bounded-slice re-hash walker: each `slice_scan` verifies up to
    `budget_lists` lists against the sidecar and advances `cursor`; a full
    lap also hashes the table-granularity fields again. The cursor is
    plain state, so a supervisor can persist it and a serve loop can run
    one slice between batches."""

    def __init__(self, kind: Optional[str] = None, *, budget_lists: int = 8):
        if budget_lists < 1:
            raise ValueError(f"budget_lists must be >= 1, got {budget_lists}")
        self.kind = kind
        self.budget_lists = int(budget_lists)
        self.cursor = 0
        self.lists_scanned = 0
        self.laps = 0
        self.mismatches = 0

    def slice_scan(self, index, skip=()) -> List[Tuple[str, int]]:
        """One bounded slice. Returns mismatches as (field, list_id) pairs;
        table mismatches (checked at lap ends) report list_id -1. Lists in
        `skip` (quarantined) are not flagged again. An index without a
        sidecar gets one attached and reports nothing."""
        kind = self.kind or digest.kind_of(index)
        if getattr(index, "list_digests", None) is None:
            digest.attach(index, kind)
            if obs.enabled():
                obs.event("integrity.scan", lists=0, cursor=0, attached=True)
            return []
        n_lists = int(index.n_lists)
        start = self.cursor if self.cursor < n_lists else 0
        end = min(start + self.budget_lists, n_lists)
        skip = set(skip)
        ids = [i for i in range(start, end) if i not in skip]
        bad = digest.verify_lists(index, ids, kind)
        if end >= n_lists:
            bad.extend((f, -1) for f in digest.verify_tables(index, kind))
            self.cursor = 0
            self.laps += 1
        else:
            self.cursor = end
        self.lists_scanned += len(ids)
        self.mismatches += len(bad)
        if obs.enabled():
            obs.counter("integrity.scans").inc()
            obs.counter("integrity.lists_scanned").inc(len(ids))
            obs.event("integrity.scan", lists=len(ids), cursor=self.cursor)
            for field, lid in bad:
                obs.counter("integrity.mismatches").inc()
                obs.event("integrity.mismatch", field=field, list=lid)
        return bad

    def full_scan(self, index, skip=()) -> List[Tuple[str, int]]:
        """Every list and the tables, as slices over one lap from list 0."""
        kind = self.kind or digest.kind_of(index)
        if getattr(index, "list_digests", None) is None:
            digest.attach(index, kind)
            return []
        bad: List[Tuple[str, int]] = []
        n_lists = int(index.n_lists)
        self.cursor = 0
        for _ in range(-(-n_lists // self.budget_lists) + 1):
            bad.extend(self.slice_scan(index, skip=skip))
            if self.cursor == 0:
                break
        return bad
