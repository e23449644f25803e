"""Live mutable indexes: crash-atomic upsert / delete with tombstones
(counterpart of raft_tpu/neighbors/mutation.py).

Every IVF engine scores a slot as the worst value wherever its slot
table reads -1, the mechanism of pads and prefilters. Mutation rides it:

- **delete** marks the victim's (list, slot) cells in the index's
  `tombstones` mask; `core.bitset.make_slot_filter` folds the mask into
  the slot table every engine scans, so dead rows reach the list kernels
  as +inf base (never a candidate, never re-ranked). `tombstones is
  None` means all live.
- **upsert** tombstones every live slot holding the id, then appends the
  new row through the index's own `extend`; `ensure_append_slack`
  reserves tail slots so that steady churn scatters into existing
  columns.
- **compact** / **rebalance** pack each list's live rows left in slot
  order, cut the store to the live geometry plus the reserved slack, and
  drop the mask back to None.

Each operation returns a new object, a shallow clone, and never writes
into a tensor the old index shares (the zero-dip swap: a search in
flight keeps scanning the old object). The mask, the slot tables and the
payload gathers run on the index's device (`torch.isin`,
`torch.argsort(stable=True)`) and give the JAX package's tables bit for
bit. Derived stores (`_DERIVED_ATTRS`) are dropped on any change of slot
geometry and rebuild at their next search; `fused_kb` survives.

Every operation refreshes the index's integrity sidecar
(integrity/digest): the digests of the lists whose slot table or mask it
changed are patched over the changed slots, and a change of geometry
hashes everything.

Crash atomicity (`Mutator`): each batch's payload is a CRC'd container
(`_save_batch`, written atomically) written BEFORE its line is appended
to the CRC'd `mutlog.jsonl` (torn-line-terminating appends); checkpoint
commits save the whole index with `mut_cursor` = applied entries. A
resume loads the checkpoint, replays the log's valid dense prefix past
the cursor, dedupes a re-issued sequence by sequence number and refuses
a log shorter than the checkpoint's cursor. `Mutator(retain=K)` keeps the
K newest commits as point-in-time snapshots (integrity/restore).

Fault sites (core/faults): `mutation.log.commit` (`crash_point` after
each log append and after each checkpoint commit: the two SIGKILL
windows), `mutation.tombstone` and `mutation.rebalance` (`fault_point`
before any state changes). With obs enabled, delete, upsert and compact
count `mutation.tombstones`, `mutation.upserts` and
`mutation.rebalances` and publish a "mutation" event each, as does each
`Mutator` checkpoint commit.
"""

from __future__ import annotations

import copy
import json
import os
from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import faults
from raft_tpu_torch.core.serialize import crc32c

#: fault sites (core/faults)
LOG_COMMIT_SITE = "mutation.log.commit"
TOMBSTONE_SITE = "mutation.tombstone"
REBALANCE_SITE = "mutation.rebalance"

#: index kinds the mutation protocol understands
KINDS = ("ivf_flat", "ivf_pq", "ivf_rabitq")

LOG_NAME = "mutlog.jsonl"
CKPT_NAME = "index.ckpt"

#: slot-group width of every list store (the 32-slot rounding of
#: `_pack_lists` / `_append_slots`)
GROUP = 32


class MutationLogError(RuntimeError):
    """The mutation log and its checkpoint disagree in a way replay cannot
    reconcile (an externally truncated log, a payload / line op mismatch,
    an unknown op): resuming would diverge, so the open refuses."""


def _index_module(kind: str):
    """The `neighbors` module of a mutable index kind (resolved at call
    time: mutation orchestrates the index modules)."""
    if kind == "ivf_flat":
        from raft_tpu_torch.neighbors import ivf_flat as mod
    elif kind == "ivf_pq":
        from raft_tpu_torch.neighbors import ivf_pq as mod
    elif kind == "ivf_rabitq":
        from raft_tpu_torch.neighbors import ivf_rabitq as mod
    else:
        raise ValueError(f"unknown index kind {kind!r}; one of {KINDS}")
    return mod


def kind_of(index) -> str:
    """Index kind from the instance's defining module."""
    mod = type(index).__module__.rsplit(".", 1)[-1]
    if mod not in KINDS:
        raise TypeError(f"not a mutable index: {type(index)!r}")
    return mod


def _payload_attrs(kind: str) -> Tuple[str, ...]:
    """The per-kind list-major payload tables that share slot geometry
    with `slot_rows` (axis 1 = slots)."""
    if kind == "ivf_flat":
        return ("list_data",)
    if kind == "ivf_pq":
        return ("codes",)
    return ("codes", "aux")


#: derived stores dropped by any change of slot geometry (each rebuilds at
#: its next search): IVF-Flat's bf16 residual store, IVF-PQ's int8
#: reconstruction store, RaBitQ's bit-plane store and its radii
_DERIVED_ATTRS = ("resid_bf16", "resid_norm", "recon8", "recon_scale", "recon_norm",
                  "slot_rows_pad", "codes_t", "bp_meta", "_list_radii")


def _clone(index):
    """Shallow copy: a mutation returns a NEW index object."""
    return copy.copy(index)


def _drop_derived(index) -> None:
    for name in _DERIVED_ATTRS:
        if hasattr(index, name):
            setattr(index, name, None)


def _round_group(n: int) -> int:
    return -(-max(int(n), 1) // GROUP) * GROUP


def _tomb_mask(index) -> torch.Tensor:
    """The dead-slot mask as bool at the slot table's width (a mask
    narrower than a lane-padded table widens with live pad columns)."""
    from raft_tpu_torch.core.bitset import carry_tombstones

    sr = index.slot_rows
    if index.tombstones is None:
        return torch.zeros(sr.shape, dtype=torch.bool, device=sr.device)
    return carry_tombstones(index.tombstones, int(sr.shape[1])).to(sr.device)


def _ids_tensor(ids, device) -> torch.Tensor:
    if isinstance(ids, torch.Tensor):
        return ids.to(device=device, dtype=torch.int32).reshape(-1)
    return torch.as_tensor(np.array(ids, np.int32).reshape(-1), device=device)


def live_rows(index) -> int:
    """Occupied slots minus tombstones: the truthful row count of a
    mutated index (`index.size` counts every appended row, superseded
    upsert versions included)."""
    sr = index.slot_rows
    return int(((sr >= 0) & ~_tomb_mask(index)).sum())


def tombstone(index, ids):
    """Mark every LIVE slot holding one of `ids` dead; returns (new_index,
    n_dead). Ids absent from the index (or already dead) are ignored, so
    delete is idempotent; with nothing to mark the index itself comes
    back. The slot table is untouched (placement survives for
    compaction); only the mask grows, as a new tensor, and only the
    flipped mask rows' digests change in the sidecar."""
    from raft_tpu_torch.integrity.digest import refresh

    faults.fault_point(TOMBSTONE_SITE)
    sr = index.slot_rows
    sid = index.source_ids
    if index.size == 0:
        return index, 0
    t = _tomb_mask(index)
    ids = torch.unique(_ids_tensor(ids, sid.device))
    # positions whose id is a victim -> their (list, slot) cells; an
    # upserted id holds several positions, but only live slots flip
    victim_pos = torch.isin(sid, ids)
    dead_new = victim_pos[torch.clamp(sr, min=0).long()] & (sr >= 0) & ~t
    n = int(dead_new.sum())
    if n == 0:
        return index, 0
    out = _clone(index)
    out.tombstones = t | dead_new
    refresh(out, index)
    if obs.enabled():
        obs.counter("mutation.tombstones").inc(n)
        obs.event("mutation", op="delete", index_kind=kind_of(index), n=n)
    return out, n


def delete(index, ids):
    """Online delete: tombstone `ids`. Returns the new index."""
    out, _ = tombstone(index, ids)
    return out


def upsert(index, vectors, ids=None):
    """Online upsert: retire any live row holding each id, then append the
    new rows through the index's own `extend` (label, encode, place in
    the tail slots). `ids=None` assigns fresh ids from `index.id_bound`
    on (a pure insert). Returns the new index; the old object keeps
    serving unchanged."""
    kind = kind_of(index)
    mod = _index_module(kind)
    n = int(vectors.shape[0]) if hasattr(vectors, "shape") else len(vectors)
    if ids is None:
        base = index.id_bound
        ids = torch.arange(base, base + n, dtype=torch.int32, device=index.device)
    ids = _ids_tensor(ids, index.device)
    if ids.shape[0] != n:
        raise ValueError(f"{n} vectors but {ids.shape[0]} ids")
    out, _ = tombstone(index, ids)
    out = mod.extend(out, vectors, new_indices=ids)
    if obs.enabled():
        obs.counter("mutation.upserts").inc(int(ids.shape[0]))
        obs.event("mutation", op="upsert", index_kind=kind, n=int(ids.shape[0]))
    return out


def ensure_append_slack(index, slack: int):
    """Reserve at least `slack` free tail slots in every list (rounded to
    the 32-slot group), so upsert batches scatter into existing pad
    columns instead of growing the store each time. Grow-only; derived
    stores rebuild at the wider geometry. Returns the new index (the
    input when it is already wide enough and records this slack)."""
    from raft_tpu_torch.core.bitset import carry_tombstones
    from raft_tpu_torch.integrity.digest import refresh

    slack = int(slack)
    if slack < 0:
        raise ValueError(f"slack must be >= 0, got {slack}")
    kind = kind_of(index)
    sizes = index.list_sizes
    width = int(index.slot_rows.shape[1])
    need = _round_group((int(sizes.max()) if sizes.numel() else 0) + slack)
    if need <= width:
        if index.append_slack != slack:
            index = _clone(index)
            index.append_slack = slack
        return index
    extra = need - width
    pad = torch.nn.functional.pad
    out = _clone(index)
    for name in _payload_attrs(kind):
        tbl = getattr(index, name)
        setattr(out, name, pad(tbl, (0, 0) * (tbl.ndim - 2) + (0, extra)))
    out.slot_rows = pad(index.slot_rows, (0, extra), value=-1)
    out.tombstones = carry_tombstones(index.tombstones, need)
    out.append_slack = slack
    _drop_derived(out)
    refresh(out, index)  # the geometry grew: a full digest pass
    return out


def compact(index, *, slack: Optional[int] = None):
    """Drop tombstoned rows: live slots pack left in slot order (a stable
    sort a list, on the index's device), the store width becomes the
    live geometry plus the reserved `slack` (default: the index's
    recorded `append_slack`), and the mask returns to None. Superseded
    `source_ids` entries stay (slot values index into them, so positions
    must not shift); `list_radii` stay (a max over former members still
    bounds the survivors). Slots past each list's live rows read -1 and
    keep the payload the gather put there, as in the JAX package."""
    from raft_tpu_torch.integrity.digest import refresh

    kind = kind_of(index)
    slack = index.append_slack if slack is None else int(slack)
    sr = index.slot_rows
    n_lists, width = int(sr.shape[0]), int(sr.shape[1])
    t = _tomb_mask(index)
    live = (sr >= 0) & ~t
    live_sizes = live.sum(dim=1).to(torch.int32)
    new_max = _round_group((int(live_sizes.max()) if live_sizes.numel() else 0) + slack)
    # stable left-pack: sorting "dead" puts live slots first in their
    # original order; one shared gather for every payload table
    order = torch.argsort((~live).to(torch.int8), dim=1, stable=True)
    packed_live = torch.gather(live, 1, order)
    new_sr = torch.where(packed_live, torch.gather(sr, 1, order), -1)
    if new_max <= width:
        new_sr = new_sr[:, :new_max]
        cut = order[:, :new_max]
    else:
        grow = new_max - width
        new_sr = torch.nn.functional.pad(new_sr, (0, grow), value=-1)
        cut = torch.cat([order, order[:, -1:].expand(-1, grow)], dim=1)
    rows = torch.arange(n_lists, device=sr.device)[:, None]
    out = _clone(index)
    for name in _payload_attrs(kind):
        gathered = getattr(index, name)[rows, cut]  # a new tensor
        if new_max > width:
            gathered[:, width:] = 0
        setattr(out, name, gathered)
    out.slot_rows = new_sr.to(sr.dtype).contiguous()
    out.list_sizes = live_sizes
    out.tombstones = None
    out.append_slack = slack
    _drop_derived(out)
    refresh(out, index)  # the repack moved slots: their lists hash again
    if obs.enabled():
        obs.counter("mutation.rebalances").inc()
        obs.event("mutation", op="rebalance", index_kind=kind, n=int(t.sum()), width=new_max)
    return out


def rebalance(index, *, min_dead_frac: float = 0.0, slack: Optional[int] = None):
    """Compact when the store is tombstone-heavy enough to pay for it:
    dead slots / occupied slots >= `min_dead_frac` (0.0 = whenever a slot
    is dead). Returns (index, compacted)."""
    faults.fault_point(REBALANCE_SITE)
    sr = index.slot_rows
    occupied = int((sr >= 0).sum())
    dead = int((_tomb_mask(index) & (sr >= 0)).sum())
    if occupied == 0 or dead == 0 or dead < min_dead_frac * occupied:
        return index, False
    return compact(index, slack=slack), True


# ---------------------------------------------------------------------------
# crash-atomic mutation log
# ---------------------------------------------------------------------------


def _host(a, dtype) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return np.asarray(a, dtype)


def _save_batch(path: str, op: str, seq: int, ids, vectors) -> None:
    """One mutation batch's payload container (CRC'd, atomic: a kill
    mid-write leaves no file, so a payload exists whole or its log line
    was never appended)."""
    from raft_tpu_torch.core.serialize import serialize_arrays

    arrays = {"ids": _host(ids, np.int32)}
    if vectors is not None:
        arrays["vectors"] = _host(vectors, np.float32)
    serialize_arrays(path, arrays, {"kind": "mutation_batch", "version": 1, "op": op,
                                    "seq": int(seq)})


def _load_batch(path: str):
    """Read one payload container back; returns (op, seq, ids, vectors;
    None for deletes and rebalances), as numpy arrays."""
    from raft_tpu_torch.core.serialize import read_ckpt

    arrays, meta = read_ckpt(path, "mutation_batch", to_device=False)
    ids = np.array(arrays["ids"])
    vectors = arrays.get("vectors")
    if vectors is not None:
        vectors = np.array(vectors)
    return meta["op"], int(meta["seq"]), ids, vectors


class MutationLog:
    """Append-only CRC'd mutation journal (`mutlog.jsonl`).

    One line per committed batch: ``{"v", "seq", "op", "payload", "crc"}``,
    `crc` the CRC-32C of the line's canonical encoding without the crc
    field. Appends terminate a torn final line first, and the payload
    container is written before its line, so the valid lines whose seq
    forms a dense prefix are exactly the durable mutations."""

    def __init__(self, root: str):
        self.root = os.path.abspath(os.fspath(root))
        os.makedirs(self.root, exist_ok=True)

    @property
    def path(self) -> str:
        return os.path.join(self.root, LOG_NAME)

    def payload_path(self, seq: int) -> str:
        return os.path.join(self.root, f"mut_{int(seq):06d}.ckpt")

    @staticmethod
    def _line_crc(entry: dict) -> int:
        body = {k: v for k, v in entry.items() if k != "crc"}
        blob = json.dumps(body, sort_keys=True, separators=(",", ":")).encode()
        return crc32c(blob)

    def entries(self) -> list:
        """Valid entries, as the longest dense seq prefix. Torn or rotted
        lines are skipped (a kill mid-append leaves a torn tail, and the
        resumed run appends its re-issued copy after it); a valid line
        whose seq is not the next one ends the log there, so a gap is
        never bridged."""
        if not os.path.exists(self.path):
            return []
        out = []
        with open(self.path, "r", encoding="utf-8", errors="replace") as fh:
            for line in fh:
                line = line.strip()
                if not line:
                    continue
                try:
                    e = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn line; the next line may be its redo
                if not isinstance(e, dict) or e.get("crc") != self._line_crc(e):
                    continue  # rotted line; ditto
                if int(e.get("seq", -1)) != len(out):
                    break
                out.append(e)
        return out

    def append(self, op: str, seq: int, payload: Optional[str]) -> dict:
        entry = {"v": 1, "seq": int(seq), "op": op, "payload": payload}
        entry["crc"] = self._line_crc(entry)
        line = json.dumps(entry, sort_keys=True)
        with open(self.path, "a+b") as fh:
            fh.seek(0, os.SEEK_END)
            if fh.tell() > 0:
                fh.seek(-1, os.SEEK_END)
                if fh.read(1) != b"\n":
                    fh.write(b"\n")  # terminate a torn predecessor
            fh.write(line.encode() + b"\n")
            fh.flush()
            os.fsync(fh.fileno())
        return entry


def _apply_entry(index, log: MutationLog, entry: dict, slack: int = 0):
    """Apply one logged entry to `index` and return the result: its
    payload is read back from `log`'s disk. The one apply of the live
    path, the resume and point-in-time restore (integrity/restore), so a
    replay is what the Mutator committed."""
    op = entry["op"]
    if op == "rebalance":
        return rebalance(index, slack=slack or None)[0]
    op2, _, ids, vectors = _load_batch(log.payload_path(entry["seq"]))
    if op2 != op:
        raise MutationLogError(f"payload op {op2!r} != log op {op!r} at seq {entry['seq']}")
    if op == "upsert":
        return upsert(index, vectors, ids)
    if op == "delete":
        return delete(index, ids)
    raise MutationLogError(f"unknown logged op {op!r}")


class Mutator:
    """Crash-atomic online mutation of one index (module docstring).

    Layout under `root`: `mutlog.jsonl`, the `mut_<seq>.ckpt` payloads and
    `index.ckpt` (the committed checkpoint, carrying `mut_cursor`). Open
    with the cold-start index; when a committed checkpoint exists it
    replaces the argument, loaded onto `device` (default: the given
    index's device, else `resolve_device(None)`, the card), and the log's
    tail past the cursor replays. A caller that runs again re-issues its
    sequence from the top; calls whose seq the log already holds are skipped.
    `ckpt_every` batches between commits bounds replay; `slack` is the
    per-list append reserve (`ensure_append_slack`); `retain` keeps the
    newest `retain` commits as point-in-time snapshots (`commit`;
    integrity/restore), 0 none."""

    def __init__(self, root: str, index=None, *, kind: Optional[str] = None,
                 ckpt_every: int = 8, slack: int = 0, retain: int = 0, device=None):
        self.log = MutationLog(root)
        self.ckpt_every = max(1, int(ckpt_every))
        self.slack = int(slack)
        self.retain = max(0, int(retain))
        if os.path.exists(self.ckpt_path):
            if kind is None:
                kind = kind_of(index) if index is not None else None
            if kind is None:
                raise ValueError("resume needs kind= (or an index)")
            if device is None and index is not None:
                device = index.device
            index = _index_module(kind).load(self.ckpt_path, device=device)
        elif index is None:
            raise ValueError("no committed checkpoint: pass the index")
        self.kind = kind or kind_of(index)
        self.index = index
        if self.slack:
            self.index = ensure_append_slack(self.index, self.slack)
        entries = self.log.entries()
        cursor = int(self.index.mut_cursor)
        if cursor > len(entries):
            raise MutationLogError(
                f"checkpoint cursor {cursor} beyond the log ({len(entries)} entries) — the "
                "log was truncated externally; refusing a divergent resume")
        for e in entries[cursor:]:
            self._apply(e)
        self.applied = len(entries)
        self._issued = 0

    @property
    def ckpt_path(self) -> str:
        return os.path.join(self.log.root, CKPT_NAME)

    def _apply(self, entry: dict) -> None:
        """Apply one logged entry to the in-memory index (the replay path
        and the live path share it: the payload is read back from disk)."""
        self.index = _apply_entry(self.index, self.log, entry, self.slack)

    def _submit(self, op: str, ids, vectors=None):
        seq = self._issued
        self._issued += 1
        if seq < self.applied:
            return self.index  # already durable (an earlier run logged it)
        if vectors is not None or op in ("upsert", "delete"):
            _save_batch(self.log.payload_path(seq), op, seq, ids, vectors)
        self.log.append(op, seq, None if op == "rebalance"
                        else os.path.basename(self.log.payload_path(seq)))
        self._apply({"op": op, "seq": seq})
        self.applied += 1
        # SIGKILL window 1: the log is ahead of the checkpoint, so the
        # resume must replay this entry
        faults.crash_point(LOG_COMMIT_SITE)
        if self.applied - int(self.index.mut_cursor) >= self.ckpt_every:
            self.commit()
        return self.index

    def upsert(self, vectors, ids):
        """Log and apply one upsert batch. Returns the current index."""
        return self._submit("upsert", ids, _host(vectors, np.float32))

    def delete(self, ids):
        """Log and apply one delete batch. Returns the current index."""
        return self._submit("delete", ids)

    def rebalance(self):
        """Log and apply a compaction, then commit at once (the geometry
        change makes checkpointing now cheaper than replaying it).
        Returns the current index."""
        out = self._submit("rebalance", np.empty((0,), np.int32))
        self.commit()
        return out

    def commit(self):
        """Checkpoint the index with `mut_cursor` = applied entries (one
        atomic file), then remove the payload containers it supersedes.
        An index without a digest sidecar gains one here, so every
        committed checkpoint can be scrubbed. With `retain`, a
        byte-for-byte copy of the checkpoint becomes the snapshot
        `pitr_<cursor>.ckpt`, the newest `retain` snapshots are kept, and
        payloads are removed only below the oldest kept cursor."""
        if int(self.index.mut_cursor) != self.applied:
            from raft_tpu_torch.integrity.digest import attach

            idx = _clone(self.index)
            idx.mut_cursor = self.applied
            idx.append_slack = self.slack
            if getattr(idx, "list_digests", None) is None:
                attach(idx, self.kind)
            _index_module(self.kind).save(self.ckpt_path, idx)
            self.index = idx
            sweep_below = self.applied
            if self.retain:
                import shutil

                from raft_tpu_torch.integrity.restore import prune, snapshot_path

                shutil.copyfile(self.ckpt_path, snapshot_path(self.log.root, self.applied))
                kept = prune(self.log.root, keep=self.retain)
                sweep_below = min(kept) if kept else self.applied
            for seq in range(sweep_below):
                p = self.log.payload_path(seq)
                if os.path.exists(p):
                    try:
                        os.remove(p)
                    except OSError:
                        pass  # an orphan payload is ignored garbage
            if obs.enabled():
                obs.event("mutation", op="commit", index_kind=self.kind, cursor=self.applied)
        # SIGKILL window 2: after the commit, so the resume must not replay
        faults.crash_point(LOG_COMMIT_SITE)
        return self.index


# ---------------------------------------------------------------------------
# serve-layer feed
# ---------------------------------------------------------------------------


class MutationFeed:
    """Thread-safe queue of mutation batches for a serving loop: a mutator
    (any thread) `publish`es, the loop drains between device batches and
    swaps its index reference, so searches in flight keep the old object.

    Batches are the `apply_batch` shapes: ``("upsert", vectors, ids)``,
    ``("delete", ids)``, ``("rebalance",)``."""

    def __init__(self):
        import threading

        self._lock = threading.Lock()
        self._pending: list = []

    def publish(self, batch: tuple) -> None:
        if not batch or batch[0] not in ("upsert", "delete", "rebalance"):
            raise ValueError(f"unknown mutation batch {batch!r:.60}")
        with self._lock:
            self._pending.append(batch)

    def drain(self) -> list:
        with self._lock:
            out, self._pending = self._pending, []
        return out


def apply_batch(index, batch: tuple):
    """Apply one feed batch to an index, returning the new index."""
    op = batch[0]
    if op == "upsert":
        return upsert(index, batch[1], batch[2])
    if op == "delete":
        return delete(index, batch[1])
    if op == "rebalance":
        out, _ = rebalance(index)
        return out
    raise ValueError(f"unknown mutation op {op!r}")
