"""Content digests for live indexes: per-list / per-table CRC-32C sidecars
over the payload of the three index kinds (counterpart of
raft_tpu/integrity/digest.py).

The checkpoint CRC (core/serialize) proves bytes survived the disk round
trip; these sidecars cover the tables while they are live: computed at
build, kept fresh by every mutation (only the touched lists hash again),
carried through save / load, and checked again by the scrubber
(integrity/scrub) between serve batches.

Granularity is the containment unit: a "list" field digests one uint32 a
list row (a mismatch names the list to quarantine), a "table" field one
uint32 for the whole table (a mismatch means repair).

A digest covers the bytes `save` writes: tombstones as u8, RaBitQ codes
as their uint32 words (the port's int32 words, the same bytes), so a
sidecar computed on the card holds against the file and against the JAX
package. Rows are hashed on the host with `core.serialize.crc32c_rows`;
only the rows being hashed leave the device (`index_select`, then one
copy), never whole tables for a few rows. A refresh copies less: CRC is
affine, so a touched row's digest is patched from its stored one with
the bytes of its changed slot range alone (`_patched_digests`), and an
appended table from its stored digest with the new tail alone.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.serialize import _BLOCK as _CRC_BLOCK
from raft_tpu_torch.core.serialize import crc32c, crc32c_extend, crc32c_patch, crc32c_rows

# kind -> {serialized array field -> digest granularity} (the JAX
# package's literal; the sidecar fields themselves are exempt)
DIGEST_FIELDS = {
    "ivf_flat": {
        "centers": "table",
        "list_data": "list",
        "slot_rows": "list",
        "list_sizes": "table",
        "source_ids": "table",
        "list_radii": "table",
        "tombstones": "list",
    },
    "ivf_pq": {
        "rotation": "table",
        "centers": "table",
        "pq_centers": "table",
        "codes": "list",
        "slot_rows": "list",
        "list_sizes": "table",
        "source_ids": "table",
        "list_radii": "table",
        "tombstones": "list",
    },
    "ivf_rabitq": {
        "rotation": "table",
        "centers": "table",
        "codes": "list",
        "aux": "list",
        "slot_rows": "list",
        "list_sizes": "table",
        "source_ids": "table",
        "tombstones": "list",
    },
}

#: rows a device-to-host copy of `_row_digests` takes at most (bytes)
_COPY_BYTES = 1 << 28


class IntegrityError(RuntimeError):
    """A digest check failed where the caller required a clean result
    (verified restore, post-repair verification)."""


def kind_of(index) -> str:
    """Index kind from the payload attributes (IVF-PQ carries pq_centers,
    RaBitQ aux without list_data)."""
    if getattr(index, "pq_centers", None) is not None:
        return "ivf_pq"
    if hasattr(index, "aux") and not hasattr(index, "list_data"):
        return "ivf_rabitq"
    if hasattr(index, "list_data"):
        return "ivf_flat"
    raise TypeError(f"not a digestable local index: {type(index).__name__}")


def _canon(field: str, arr) -> torch.Tensor:
    """The field as a tensor whose bytes are the serialized ones
    (tombstones as u8), on its own device."""
    t = torch.as_tensor(arr).detach()
    if field == "tombstones":
        t = t.to(torch.uint8)
    return t


def _host(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.cpu().numpy())


def _row_digests(field: str, arr, rows) -> np.ndarray:
    """(len(rows),) uint32: the digest of each given list row. The rows
    are gathered on the field's device and copied in bounded chunks."""
    t = _canon(field, arr)
    rows = np.asarray(rows, np.int64).reshape(-1)
    out = np.empty(len(rows), np.uint32)
    if not len(rows):
        return out
    row_bytes = max(1, t[0].numel() * t.element_size())
    per = max(1, _COPY_BYTES // row_bytes)
    full = len(rows) == t.shape[0] and bool((rows == np.arange(len(rows))).all())
    for s in range(0, len(rows), per):
        if full:
            part = t[s:s + per]
        else:
            idx = torch.as_tensor(rows[s:s + per], device=t.device)
            part = torch.index_select(t, 0, idx)
        out[s:s + per] = crc32c_rows(_host(part))
    return out


def _table_digest(field: str, arr) -> int:
    return int(crc32c(_host(_canon(field, arr))))


def _bytes(t: torch.Tensor) -> torch.Tensor:
    if t.numel() == 0:  # an empty table may carry a stride of 0, which `view` refuses
        return torch.empty(0, dtype=torch.uint8, device=t.device)
    return t.contiguous().reshape(-1).view(torch.uint8)


def _patched_digests(field: str, old, new, prev: np.ndarray, rows) -> np.ndarray:
    """(len(rows),) uint32: the digests of `rows` of `new` patched from
    their digests over `old` (`prev`, one a row of `rows`); `new` has
    `old`'s shape or a wider slot axis (a grown store: the old rows are
    read as zero-extended, their digests extended over the zeros). Each
    row's changed slot range is found on the device (bytes compared, so
    -0.0 and NaN payloads count), and only old XOR new over that range
    is copied to the host (`crc32c_patch`); the rows go in order of range
    length, so a chunk pads little. A row whose stored digest was already
    stale (rot) stays stale: the patch carries the mismatch instead of
    hashing the rot in."""
    o, t = _canon(field, old).to(new.device), _canon(field, new)
    rows = np.asarray(rows, np.int64).reshape(-1)
    width, wo = int(t.shape[1]), int(o.shape[1])
    slot_bytes = max(1, t[0, 0].numel() * t.element_size())
    prev = np.asarray(prev, np.uint32).reshape(-1)
    if wo < width:
        prev = crc32c_extend(prev, bytes((width - wo) * slot_bytes))
    per = max(1, _COPY_BYTES // max(1, width * slot_bytes))

    def changed_slots(idx):
        """(len(idx), width) bool: the slots of rows `idx` whose bytes
        differ (old past its width reads zero)."""
        x = _bytes(torch.index_select(t, 0, idx)).view(len(idx), width, slot_bytes)
        ne = x.ne(0)
        if wo:
            y = _bytes(torch.index_select(o, 0, idx)).view(len(idx), wo, slot_bytes)
            ne[:, :wo] = x[:, :wo] != y
        return ne.any(dim=2)

    def xor_slots(ridx, cols):
        """old XOR new bytes at slots `cols` of rows `ridx` (old past its
        width reads zero), as (len(ridx), len(cols[0]), slot_bytes)."""
        x = _bytes(t[ridx, cols]).view(cols.shape[0], cols.shape[1], slot_bytes)
        if wo:
            inside = (cols < wo)[:, :, None]
            x = x ^ _bytes(o[ridx, cols.clamp(max=wo - 1)]).view(x.shape) * inside
        return x

    first = np.empty(len(rows), np.int64)
    last = np.empty(len(rows), np.int64)
    pos = torch.arange(width, device=t.device)
    for s in range(0, len(rows), per):
        ne = changed_slots(torch.as_tensor(rows[s:s + per], device=t.device))
        first[s:s + per] = torch.where(ne, pos, width).amin(dim=1).cpu().numpy()
        last[s:s + per] = torch.where(ne, pos, -1).amax(dim=1).cpu().numpy()
    out = prev.copy()
    changed = np.flatnonzero(last >= 0)
    span = last[changed] - first[changed] + 1
    order = changed[np.argsort(span, kind="stable")]
    s = 0
    while s < len(order):
        # rows in order of span: the chunk's last row has its widest span
        n_rows = 1
        while (s + n_rows < len(order)
               and (n_rows + 1) * (last[order[s + n_rows]] - first[order[s + n_rows]] + 1)
               * slot_bytes <= _COPY_BYTES):
            n_rows += 1
        part = order[s:s + n_rows]
        s += n_rows
        lo, hi = first[part], last[part]
        span_max = int((hi - lo + 1).max())
        # right-aligned: column j of a row is slot hi + 1 - span_max + j,
        # zero before the row's own range
        src = torch.as_tensor(hi + 1 - span_max, device=t.device)[:, None] + \
            torch.arange(span_max, device=t.device)
        keep = src >= torch.as_tensor(lo, device=t.device)[:, None]
        ridx = torch.as_tensor(rows[part], device=t.device)[:, None]
        seg = (xor_slots(ridx, src.clamp(min=0)) * keep[:, :, None]).reshape(len(part), -1)
        # leading zeros leave the patch unchanged: whole CRC blocks a row
        seg = torch.nn.functional.pad(seg, ((-seg.shape[1]) % _CRC_BLOCK, 0))
        out[part] = crc32c_patch(prev[part], _host(seg), (width - 1 - hi) * slot_bytes)
    return out


def _appended_digest(field: str, old, new, prev: int) -> int:
    """The digest of table `new`: extended from `old`'s (`prev`) over the
    new tail where `new` starts with `old`'s bytes (an append), else
    hashed whole."""
    o, t = _bytes(_canon(field, old).to(new.device)), _bytes(_canon(field, new))
    if (tuple(old.shape[1:]) == tuple(new.shape[1:]) and t.numel() >= o.numel()
            and torch.equal(t[:o.numel()], o)):
        return int(crc32c_extend(np.array([prev], np.uint32), _host(t[o.numel():]))[0])
    return int(crc32c(_host(t)))


def compute(index, kind: Optional[str] = None
            ) -> Tuple[Dict[str, np.ndarray], Dict[str, int]]:
    """Full digest pass. Returns (lists, tables): each present
    list-granularity field -> (n_lists,) uint32 row digests, each present
    table-granularity field -> one digest. Absent (None) fields have no
    entry."""
    kind = kind or kind_of(index)
    n_lists = int(index.n_lists)
    lists: Dict[str, np.ndarray] = {}
    tables: Dict[str, int] = {}
    for field, gran in DIGEST_FIELDS[kind].items():
        arr = getattr(index, field, None)
        if arr is None:
            continue
        if gran == "table":
            tables[field] = _table_digest(field, arr)
        else:
            lists[field] = _row_digests(field, arr, range(n_lists))
    return lists, tables


def attach(index, kind: Optional[str] = None) -> None:
    """Compute and attach the sidecar in place (the build-time hook)."""
    lists, tables = compute(index, kind)
    index.list_digests = lists
    index.table_digests = tables


def _changed_rows(old: torch.Tensor, new: torch.Tensor) -> np.ndarray:
    """The rows where two equal-shape tables differ (none when they are
    one tensor)."""
    if old is new:
        return np.zeros(0, np.int64)
    diff = (old.to(new.device) != new).reshape(new.shape[0], -1).any(dim=1)
    return torch.nonzero(diff).reshape(-1).cpu().numpy()


def refresh(out, old, kind: Optional[str] = None) -> None:
    """Refresh `out`'s sidecar after a mutation that derived it from `old`
    (extend, tombstone, compact, rebalance). No-op when `old` carries no
    sidecar.

    The touched rows follow the mutation protocol: every legitimate op
    moves `slot_rows` (appends, compaction) and/or the tombstone mask
    (deletes) of exactly the lists it touched, a store grown wider
    touches every row, and a narrower one invalidates everything. Rot
    does neither, which keeps it detectable: nothing here hashes a list
    that no op touched. A payload table that is the same object as before
    keeps its digests. A touched row of a table that kept its shape or
    grew wider is patched from its stored digest over its changed slots
    only (`_patched_digests`), a table that grew by an append is extended
    over its tail (`_appended_digest`): the bits of a re-hash wherever
    the stored digest held, and where it did not (rot in a touched
    list), the mismatch stays for the scrubber, which the JAX package's
    re-hash of a touched row would accept."""
    if old is None or getattr(old, "list_digests", None) is None:
        return
    kind = kind or kind_of(out)
    n_lists = int(out.n_lists)
    old_sr, new_sr = old.slot_rows, out.slot_rows
    if int(old.n_lists) != n_lists or old_sr.shape[1] > new_sr.shape[1]:
        attach(out, kind)  # the store narrowed: every slot moved
        return
    # a store grown wider changed every row's length: each row is patched
    touched = (np.arange(n_lists) if old_sr.shape[1] < new_sr.shape[1]
               else _changed_rows(old_sr, new_sr))
    ot, nt = getattr(old, "tombstones", None), getattr(out, "tombstones", None)
    if (ot is None) != (nt is None):
        tomb_touched = np.arange(n_lists)
    elif nt is None or nt is ot:
        tomb_touched = np.zeros(0, np.int64)
    else:
        om, nm = _canon("tombstones", ot), _canon("tombstones", nt)
        tomb_touched = (np.arange(n_lists) if tuple(om.shape) != tuple(nm.shape)
                        else _changed_rows(om, nm))
    lists = dict(old.list_digests)
    tables = dict(getattr(old, "table_digests", None) or {})
    for field, gran in DIGEST_FIELDS[kind].items():
        arr = getattr(out, field, None)
        oarr = getattr(old, field, None)
        if arr is None:
            lists.pop(field, None)
            tables.pop(field, None)
            continue
        if gran == "table":
            if oarr is None or field not in tables:
                tables[field] = _table_digest(field, arr)
            elif arr is not oarr:
                tables[field] = _appended_digest(field, oarr, arr, tables[field])
            continue
        rows = tomb_touched if field == "tombstones" else touched
        prev = lists.get(field)
        if oarr is None or prev is None or prev.shape[0] != n_lists:
            lists[field] = _row_digests(field, arr, range(n_lists))
        elif arr is not oarr and len(rows):
            d = prev.copy()
            if (oarr.shape[0] == arr.shape[0] and oarr.shape[2:] == arr.shape[2:]
                    and oarr.shape[1] <= arr.shape[1]):
                d[rows] = _patched_digests(field, oarr, arr, prev[rows], rows)
            else:
                d[rows] = _row_digests(field, arr, rows)
            lists[field] = d
        # the same object (a clone shares it): the digests still hold
    out.list_digests = lists
    out.table_digests = tables


def extend_rows(index, field: str, pad_bytes: bytes) -> None:
    """Extend the stored digests of list field `field` by the same
    `pad_bytes` appended to every row, without reading the rows: a store
    widened in place (ivf_flat `_pad_store_to_lanes`) keeps a sidecar
    that still detects rot from before the widening. A new dict replaces
    the old one (clones share it)."""
    sidecar = getattr(index, "list_digests", None)
    if not sidecar or field not in sidecar:
        return
    index.list_digests = {**sidecar, field: crc32c_extend(sidecar[field], pad_bytes)}


def verify_lists(index, list_ids: Sequence[int], kind: Optional[str] = None
                 ) -> List[Tuple[str, int]]:
    """Hash the given lists again against the sidecar. Returns [(field,
    list_id), ...] mismatches (empty: a clean slice)."""
    kind = kind or kind_of(index)
    sidecar = getattr(index, "list_digests", None)
    if not sidecar:
        return []
    list_ids = [int(i) for i in list_ids]
    bad: List[Tuple[str, int]] = []
    for field, want in sidecar.items():
        arr = getattr(index, field, None)
        if arr is None:
            continue
        got = _row_digests(field, arr, list_ids)
        for j, i in enumerate(list_ids):
            if got[j] != want[i]:
                bad.append((field, i))
    return bad


def verify_tables(index, kind: Optional[str] = None) -> List[str]:
    """Hash the table-granularity fields again. Returns the mismatched
    field names (empty: clean)."""
    kind = kind or kind_of(index)
    sidecar = getattr(index, "table_digests", None)
    if not sidecar:
        return []
    return [f for f, want in sidecar.items()
            if getattr(index, f, None) is not None
            and _table_digest(f, getattr(index, f)) != int(want)]


def verify(index, kind: Optional[str] = None) -> List[Tuple[str, int]]:
    """Full verification: every list of every list field, then every
    table. Table mismatches report list id -1."""
    kind = kind or kind_of(index)
    bad = verify_lists(index, range(int(index.n_lists)), kind)
    bad.extend((f, -1) for f in verify_tables(index, kind))
    return bad


def check_fresh(index, kind: Optional[str] = None) -> None:
    """Raise IntegrityError unless the attached sidecar matches the
    content exactly (the verified-restore / post-repair gate)."""
    kind = kind or kind_of(index)
    if getattr(index, "list_digests", None) is None:
        raise IntegrityError(f"{kind}: no digest sidecar attached")
    bad = verify(index, kind)
    if bad:
        raise IntegrityError(f"{kind}: digest mismatch at {bad[:8]!r} ({len(bad)} total)")


# ---------------------------------------------------------------------------
# checkpoint packing: the per-list vectors ride as ONE (n_fields, n_lists)
# uint32 array field; the per-table digests ride in the meta JSON
# ---------------------------------------------------------------------------


def _packed_order(index, kind: str) -> List[str]:
    # a row order without a manifest: the sorted list-field names present
    # on the index (save-side and load-side presence agree)
    spec = DIGEST_FIELDS[kind]
    return [f for f in sorted(spec) if spec[f] == "list" and getattr(index, f, None) is not None]


def pack_lists(index, kind: str) -> Optional[np.ndarray]:
    """Sidecar -> one stacked uint32 array for serialization (None when no
    sidecar is attached, or it lacks a present field)."""
    sidecar = getattr(index, "list_digests", None)
    if sidecar is None:
        return None
    order = _packed_order(index, kind)
    if not all(f in sidecar for f in order):
        return None  # stale sidecar: do not serialize a partial one
    if not order:
        return np.zeros((0, int(index.n_lists)), np.uint32)
    return np.stack([np.asarray(sidecar[f], np.uint32) for f in order])


def unpack_lists(index, kind: str, packed, table_meta) -> None:
    """Load-side inverse of pack_lists: attach the sidecar from the
    checkpoint fields, or leave it absent (None) when the file predates
    digests or the packed shape no longer matches the field set."""
    index.list_digests = None
    index.table_digests = None
    if packed is None:
        return
    order = _packed_order(index, kind)
    packed = np.asarray(packed, np.uint32)
    if packed.ndim != 2 or packed.shape[0] != len(order) or packed.shape[1] != int(index.n_lists):
        return  # a foreign or old field layout: no sidecar
    index.list_digests = {f: packed[i].copy() for i, f in enumerate(order)}
    index.table_digests = {str(k): int(v) for k, v in (table_meta or {}).items()}
