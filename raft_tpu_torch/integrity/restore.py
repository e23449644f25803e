"""Point-in-time recovery: a base checkpoint plus a bounded mutation-log
replay to a target committed seq, digest-verified before anyone serves
the result (counterpart of raft_tpu/integrity/restore.py).

A resume after a kill is "load the committed checkpoint, replay the log
tail"; recovery applies the same machinery to any committed seq.
`Mutator(retain=K)` keeps the K newest commit checkpoints as
cursor-stamped snapshots (`pitr_<cursor>.ckpt`, byte-for-byte copies of
the commit's `index.ckpt`) and sweeps payload containers only below the
oldest retained cursor, so every retained base can replay forward.
`restore(root, seq)` takes the newest verifiable base at or below the
target and replays `[base.cursor, seq)`; a base that fails to load or to
verify is passed over for the next older one.
"""

from __future__ import annotations

import glob
import os
import re
from typing import List, Optional, Tuple

from raft_tpu_torch import obs
from raft_tpu_torch.integrity import digest

#: cursor-stamped commit snapshots under the mutation root
SNAPSHOT_PREFIX = "pitr_"
_SNAPSHOT_RE = re.compile(r"pitr_(\d+)\.ckpt$")


def snapshot_path(root: str, cursor: int) -> str:
    return os.path.join(os.fspath(root), f"{SNAPSHOT_PREFIX}{int(cursor):06d}.ckpt")


def retained(root: str) -> List[Tuple[int, str]]:
    """The retained snapshots as (cursor, path), oldest first."""
    out = []
    for p in glob.glob(os.path.join(os.fspath(root), f"{SNAPSHOT_PREFIX}*.ckpt")):
        m = _SNAPSHOT_RE.search(os.path.basename(p))
        if m:
            out.append((int(m.group(1)), p))
    return sorted(out)


def prune(root: str, keep: int) -> List[int]:
    """Drop all but the newest `keep` snapshots; returns the surviving
    cursors, oldest first. keep <= 0 removes every snapshot."""
    snaps = retained(root)
    drop = snaps[:-keep] if keep > 0 else snaps
    for _, p in drop:
        try:
            os.remove(p)
        except OSError:
            pass  # a lingering snapshot is wasted disk, not corruption
    return [c for c, _ in (snaps[-keep:] if keep > 0 else [])]


def _bases(root: str) -> List[Tuple[int, str]]:
    """Candidate replay bases, oldest first: the retained snapshots and
    the live committed checkpoint."""
    from raft_tpu_torch.core.serialize import peek_meta
    from raft_tpu_torch.neighbors.mutation import CKPT_NAME

    out = retained(root)
    live = os.path.join(os.fspath(root), CKPT_NAME)
    if os.path.exists(live):
        try:
            out.append((int(peek_meta(live).get("mut_cursor", 0)), live))
        except Exception:  # noqa: BLE001 -- a torn live checkpoint is no candidate
            pass
    return sorted(out)


def restore(root: str, seq: Optional[int] = None, *, out: Optional[str] = None,
            verify: bool = True, base_cursor: Optional[int] = None, device=None):
    """Reconstruct the committed state at `seq` (default: the log's whole
    committed length) on `resolve_device(device)`. Returns (index,
    out_path or None); with `out` the result is also saved, byte for byte
    the checkpoint a crash-free run would have committed at that seq.

    `verify=True` digest-checks the chosen base (falling back to older
    bases on a mismatch) and the final state; `base_cursor` pins one base
    (the drills force a real replay with it)."""
    from raft_tpu_torch.core.config import resolve_device
    from raft_tpu_torch.core.serialize import peek_meta
    from raft_tpu_torch.neighbors import mutation

    dev = resolve_device(device)
    log = mutation.MutationLog(root)
    entries = log.entries()
    seq = len(entries) if seq is None else int(seq)
    if seq < 0 or seq > len(entries):
        raise digest.IntegrityError(
            f"restore target seq {seq} outside the committed log (0..{len(entries)})")
    candidates = [(c, p) for c, p in _bases(root) if c <= seq]
    if base_cursor is not None:
        candidates = [(c, p) for c, p in candidates if c == int(base_cursor)]
    if not candidates:
        raise digest.IntegrityError(f"no base checkpoint at or below seq {seq} under {root}")
    last_err: Optional[Exception] = None
    for cursor, path in reversed(candidates):
        try:
            # inside the try: a snapshot rotted in its header falls back too
            kind = peek_meta(path)["kind"]
            idx = mutation._index_module(kind).load(path, device=dev)
            if verify and getattr(idx, "list_digests", None) is not None:
                digest.check_fresh(idx, kind)
        except Exception as e:  # noqa: BLE001 -- a rotted or torn base: try an older one
            last_err = e
            if obs.enabled():
                obs.event("integrity.restore", base=cursor, ok=False, error=str(e)[:200])
            continue
        index = _replay(mutation, idx, log, entries, seq)
        if getattr(index, "list_digests", None) is None:
            digest.attach(index, kind)
        if verify:
            digest.check_fresh(index, kind)
        out_path = None
        if out is not None:
            out_path = os.fspath(out)
            mutation._index_module(kind).save(out_path, index)
        if obs.enabled():
            obs.counter("integrity.restores").inc()
            obs.event("integrity.restore", base=cursor, seq=seq, ok=True)
        return index, out_path
    raise digest.IntegrityError(
        f"every base checkpoint at or below seq {seq} failed to load/verify: {last_err!r}")


def _replay(mutation, idx, log, entries, seq: int):
    """Replay entries [idx.mut_cursor, seq), the Mutator's resume path
    bounded at `seq`, and stamp the commit's cursor and slack."""
    slack = int(idx.append_slack)
    if slack:
        idx = mutation.ensure_append_slack(idx, slack)
    start = int(idx.mut_cursor)
    if start > seq:
        raise digest.IntegrityError(f"base cursor {start} beyond restore target {seq}")
    for e in entries[start:seq]:
        idx = mutation._apply_entry(idx, log, e, slack)
    final = mutation._clone(idx)
    final.mut_cursor = seq
    final.append_slack = slack
    return final
