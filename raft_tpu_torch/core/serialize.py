"""Versioned binary serialization of named array containers (counterpart
of raft_tpu/core/serialize.py), in the JAX package's container format,
read and written byte for byte the same:

    magic  8 bytes  b"RAFTTPU\\0"
    u32    container version
    u64    header length
    header JSON: {"meta": {...}, "fields": [{name,dtype,shape,offset,nbytes,
                                             crc32c}]}
    raw little-endian buffers, 64-byte aligned

Every field carries a CRC-32C (Castagnoli) of its raw buffer, verified on
read (`ChecksumError` names the file and the corrupt fields). Path writes
go through `atomic_write` (write to a temporary file, then `os.replace`),
so a crash mid-write leaves the previous container whole.

`serialize_arrays` takes tensors on any device (or numpy arrays), moves
them to the host and writes them little-endian. `deserialize_arrays`
returns tensors on `resolve_device(device)` (the card unless the caller
asks for the CPU), or numpy arrays with `to_device=False`. This is the
JAX package's pure-Python writer, its format of record; its native C++
codec is not part of the port.

`CKPT_SCHEMA` registers the single-device checkpoint kinds (`ivf_flat`,
`ivf_pq`, `ivf_rabitq`, `mutation_batch`) with the JAX package's fields,
categories, `since` versions and absent-on-load rules; `read_ckpt`
enforces them.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import struct
from typing import Any, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch

from raft_tpu_torch.core.config import resolve_device

MAGIC = b"RAFTTPU\x00"
CONTAINER_VERSION = 1
_ALIGN = 64

# -- the checkpoint schema registry ------------------------------------
#
# kind -> {"version": <current writer version>,
#          "fields": {name: (category, dtype_class, since, absent)}}
#
#   category     "array" (container payload) | "meta" (header JSON) |
#                "runtime" (never serialized: derived state a load
#                re-creates at its default)
#   dtype_class  coarse dtype family (documentation; the CRC detects rot)
#   since        writer version that first emitted the field
#   absent       what a load does when the field is missing (or fails
#                its CRC, for arrays): "refuse" (missing -> typed
#                SerializationError, corrupt -> ChecksumError), "default"
#                (the documented default; corrupt -> dropped), "derive"
#                (re-derived from other state)
CKPT_SCHEMA = {
    "ivf_flat": {
        "version": 4,
        "fields": {
            "centers": ("array", "f32", 1, "refuse"),
            "list_data": ("array", "f32", 1, "refuse"),
            "slot_rows": ("array", "i32", 1, "refuse"),
            "list_sizes": ("array", "i32", 1, "refuse"),
            "source_ids": ("array", "i32", 1, "refuse"),
            "list_radii": ("array", "f32", 2, "default"),
            # live mutation (v3): dead-row mask (absent = all live), the
            # applied-log cursor at the commit, the per-list append slack
            "tombstones": ("array", "u8", 3, "default"),
            # integrity sidecar (v4): absent = no sidecar
            "list_digests": ("array", "u32", 4, "default"),
            "table_digests": ("meta", "json", 4, "default"),
            "kind": ("meta", "str", 1, "refuse"),
            "version": ("meta", "int", 1, "default"),
            "metric": ("meta", "int", 1, "refuse"),
            "metric_arg": ("meta", "float", 1, "default"),
            "n_lists": ("meta", "int", 1, "refuse"),
            "adaptive_centers": ("meta", "bool", 1, "default"),
            "mut_cursor": ("meta", "int", 3, "default"),
            "append_slack": ("meta", "int", 3, "default"),
            "fused_kb": ("runtime", None, 1, "default"),
        },
    },
    "ivf_pq": {
        "version": 3,
        "fields": {
            "rotation": ("array", "f32", 1, "refuse"),
            "centers": ("array", "f32", 1, "refuse"),
            "pq_centers": ("array", "f32", 1, "refuse"),
            "codes": ("array", "i32", 1, "refuse"),
            "slot_rows": ("array", "i32", 1, "refuse"),
            "list_sizes": ("array", "i32", 1, "refuse"),
            "source_ids": ("array", "i32", 1, "refuse"),
            "list_radii": ("array", "f32", 1, "default"),
            # live mutation (v2)
            "tombstones": ("array", "u8", 2, "default"),
            # integrity sidecar (v3)
            "list_digests": ("array", "u32", 3, "default"),
            "table_digests": ("meta", "json", 3, "default"),
            "kind": ("meta", "str", 1, "refuse"),
            "version": ("meta", "int", 1, "default"),
            "metric": ("meta", "int", 1, "refuse"),
            "n_lists": ("meta", "int", 1, "refuse"),
            "pq_bits": ("meta", "int", 1, "refuse"),
            "codebook_kind": ("meta", "str", 1, "refuse"),
            "mut_cursor": ("meta", "int", 2, "default"),
            "append_slack": ("meta", "int", 2, "default"),
            "fused_kb": ("runtime", None, 1, "default"),
        },
    },
    "ivf_rabitq": {
        "version": 3,
        "fields": {
            "rotation": ("array", "f32", 1, "refuse"),
            "centers": ("array", "f32", 1, "refuse"),
            "codes": ("array", "u32", 1, "refuse"),
            "aux": ("array", "f32", 1, "refuse"),
            "slot_rows": ("array", "i32", 1, "refuse"),
            "list_sizes": ("array", "i32", 1, "refuse"),
            "source_ids": ("array", "i32", 1, "refuse"),
            # live mutation (v2)
            "tombstones": ("array", "u8", 2, "default"),
            # integrity sidecar (v3)
            "list_digests": ("array", "u32", 3, "default"),
            "table_digests": ("meta", "json", 3, "default"),
            "kind": ("meta", "str", 1, "refuse"),
            "version": ("meta", "int", 1, "default"),
            "metric": ("meta", "int", 1, "refuse"),
            "n_lists": ("meta", "int", 1, "refuse"),
            "mut_cursor": ("meta", "int", 2, "default"),
            "append_slack": ("meta", "int", 2, "default"),
            # re-derived from the rotation's shape / process defaults
            "quantizer": ("meta", "str", 1, "derive"),
            "rot_dim": ("meta", "int", 1, "derive"),
            "query_bits": ("meta", "int", 1, "derive"),
            "fused_kb": ("runtime", None, 1, "default"),
            "codes_t": ("runtime", None, 1, "default"),
            "bp_meta": ("runtime", None, 1, "default"),
        },
    },
    "mnmg_ivf_flat": {
        "version": 1,
        "fields": {
            "centers": ("array", "f32", 1, "refuse"),
            "list_data": ("array", "f32", 1, "refuse"),
            "host_gids": ("array", "i32", 1, "refuse"),
            "list_sizes": ("array", "i32", 1, "refuse"),
            "replica_store": ("array", "f32", 1, "derive"),
            "replica_gids": ("array", "i32", 1, "derive"),
            "replica_sizes": ("array", "i32", 1, "derive"),
            # written only when the index carries a correction-table
            # mirror (the shared _replica_arrays helper); registered for
            # every mnmg kind so the shared writer has one contract
            "replica_aux": ("array", "f32", 1, "derive"),
            "kind": ("meta", "str", 1, "refuse"),
            "version": ("meta", "int", 1, "default"),
            "n": ("meta", "int", 1, "refuse"),
            "n_ranks": ("meta", "int", 1, "refuse"),
            "metric": ("meta", "int", 1, "refuse"),
            "n_lists": ("meta", "int", 1, "refuse"),
            "bridged": ("meta", "bool", 1, "default"),
            "replication": ("meta", "int", 1, "default"),
        },
    },
    "mnmg_ivf_pq": {
        "version": 1,
        "fields": {
            "rotation": ("array", "f32", 1, "refuse"),
            "centers": ("array", "f32", 1, "refuse"),
            "pq_centers": ("array", "f32", 1, "refuse"),
            "codes": ("array", "i32", 1, "refuse"),
            "host_gids": ("array", "i32", 1, "refuse"),
            "list_sizes": ("array", "i32", 1, "refuse"),
            "replica_store": ("array", "i32", 1, "derive"),
            "replica_gids": ("array", "i32", 1, "derive"),
            "replica_sizes": ("array", "i32", 1, "derive"),
            "replica_aux": ("array", "f32", 1, "derive"),  # see mnmg_ivf_flat
            "kind": ("meta", "str", 1, "refuse"),
            "version": ("meta", "int", 1, "default"),
            "n": ("meta", "int", 1, "refuse"),
            "n_ranks": ("meta", "int", 1, "refuse"),
            "metric": ("meta", "int", 1, "refuse"),
            "n_lists": ("meta", "int", 1, "refuse"),
            "pq_dim": ("meta", "int", 1, "refuse"),
            "pq_bits": ("meta", "int", 1, "refuse"),
            "per_cluster": ("meta", "bool", 1, "default"),
            "extended": ("meta", "bool", 1, "default"),
            "bridged": ("meta", "bool", 1, "default"),
            "replication": ("meta", "int", 1, "default"),
        },
    },
    "mnmg_ivf_rabitq": {
        "version": 1,
        "fields": {
            "rotation": ("array", "f32", 1, "refuse"),
            "centers": ("array", "f32", 1, "refuse"),
            "codes": ("array", "u32", 1, "refuse"),
            "aux": ("array", "f32", 1, "refuse"),
            "host_gids": ("array", "i32", 1, "refuse"),
            "list_sizes": ("array", "i32", 1, "refuse"),
            "replica_store": ("array", "u32", 1, "derive"),
            "replica_gids": ("array", "i32", 1, "derive"),
            "replica_sizes": ("array", "i32", 1, "derive"),
            "replica_aux": ("array", "f32", 1, "derive"),
            "kind": ("meta", "str", 1, "refuse"),
            "version": ("meta", "int", 1, "default"),
            "n": ("meta", "int", 1, "refuse"),
            "n_ranks": ("meta", "int", 1, "refuse"),
            "metric": ("meta", "int", 1, "refuse"),
            "n_lists": ("meta", "int", 1, "refuse"),
            "bridged": ("meta", "bool", 1, "default"),
            "replication": ("meta", "int", 1, "default"),
        },
    },
    "mnmg_ivf_flat_sharded": {
        "version": 1,
        "fields": {
            "centers": ("array", "f32", 1, "refuse"),
            "kind": ("meta", "str", 1, "refuse"),
            "version": ("meta", "int", 1, "default"),
            "n": ("meta", "int", 1, "refuse"),
            "n_ranks": ("meta", "int", 1, "refuse"),
            "n_parts": ("meta", "int", 1, "derive"),
            "parts": ("meta", "json", 1, "refuse"),
            "metric": ("meta", "int", 1, "refuse"),
            "n_lists": ("meta", "int", 1, "refuse"),
            "replication": ("meta", "int", 1, "default"),
        },
    },
    "mnmg_ivf_pq_sharded": {
        "version": 1,
        "fields": {
            "rotation": ("array", "f32", 1, "refuse"),
            "centers": ("array", "f32", 1, "refuse"),
            "pq_centers": ("array", "f32", 1, "refuse"),
            "kind": ("meta", "str", 1, "refuse"),
            "version": ("meta", "int", 1, "default"),
            "n": ("meta", "int", 1, "refuse"),
            "n_ranks": ("meta", "int", 1, "refuse"),
            "n_parts": ("meta", "int", 1, "derive"),
            "parts": ("meta", "json", 1, "refuse"),
            "metric": ("meta", "int", 1, "refuse"),
            "n_lists": ("meta", "int", 1, "refuse"),
            "pq_dim": ("meta", "int", 1, "refuse"),
            "pq_bits": ("meta", "int", 1, "refuse"),
            "per_cluster": ("meta", "bool", 1, "default"),
            "extended": ("meta", "bool", 1, "default"),
            "replication": ("meta", "int", 1, "default"),
        },
    },
    # one shared schema for every `{kind}_part` per-process part file;
    # reads are the shared `_load_local_tables` assembly
    # (comms/mnmg_ckpt), not per-kind load code
    "mnmg_sharded_part": {
        "version": 1,
        "fields": {
            "store": ("array", "f32", 1, "refuse"),
            "gids": ("array", "i32", 1, "refuse"),
            "sizes": ("array", "i32", 1, "derive"),
            "mirror_store": ("array", "f32", 1, "derive"),
            "mirror_gids": ("array", "i32", 1, "derive"),
            "kind": ("meta", "str", 1, "refuse"),
            "ranks": ("meta", "json", 1, "refuse"),
        },
    },
    # one mutation batch's payload container (neighbors/mutation), written
    # before its log line is appended
    "mutation_batch": {
        "version": 1,
        "fields": {
            "ids": ("array", "i32", 1, "refuse"),
            # deletes and rebalances carry no vectors
            "vectors": ("array", "f32", 1, "default"),
            "kind": ("meta", "str", 1, "refuse"),
            "version": ("meta", "int", 1, "default"),
            "op": ("meta", "str", 1, "refuse"),
            "seq": ("meta", "int", 1, "refuse"),
        },
    },
}


class SerializationError(ValueError):
    """A container could not be decoded: truncated or empty file, bad
    magic, torn header, a missing required field, a newer version."""


class ChecksumError(SerializationError):
    """One or more field buffers failed CRC-32C verification. `path` names
    the container, `fields` the corrupt field names."""

    def __init__(self, path: str, fields: List[str]):
        super().__init__(f"checksum mismatch in {path!r}: corrupt fields {fields}")
        self.path = path
        self.fields = list(fields)


def _align(n: int) -> int:
    return (n + _ALIGN - 1) // _ALIGN * _ALIGN


def _data_start(hlen: int) -> int:
    """Byte offset of the data region: magic (8) + version and length
    fields (12) + JSON header, aligned."""
    return _align(8 + 12 + hlen)


# -- CRC-32C (Castagnoli) ----------------------------------------------
#
# numpy and tables. CRC is linear over GF(2), so each _BLOCK-byte block's
# zero-init CRC is the XOR of one table entry per byte (`_POS_TBLS[p, b]`:
# byte b at position p), computed for many blocks at once in threads
# (numpy's gathers release the GIL). The blocks then fold left to right
# with the "append _BLOCK zero bytes" shift: a 32x32 bit matrix stored as
# 4x256 byte-lookup tables (`_shift_tables(j)` shifts 2^j bytes), folded
# as a tree; the initial register rides the same shifts. The tail past the
# last whole block runs bytewise.

_CRC_POLY = np.uint32(0x82F63B78)
_BLOCK_BITS = 10
_BLOCK = 1 << _BLOCK_BITS
#: blocks one thread's gather takes at a time
_CHUNK_BLOCKS = 4096


def _crc_table() -> np.ndarray:
    idx = np.arange(256, dtype=np.uint32)
    crc = idx
    for _ in range(8):
        crc = np.where(crc & 1, (crc >> 1) ^ _CRC_POLY, crc >> 1)
    return crc.astype(np.uint32)


_TBL = _crc_table()
_POS_TBLS: Optional[np.ndarray] = None  # (_BLOCK, 256) lazy
_SHIFT_TBLS: List[np.ndarray] = []  # level j: (4, 256), shifts 2^j bytes
_POOL = None
#: the pool's threads
_THREADS = max(1, min(8, os.cpu_count() or 1))


def _zero_steps(reg: np.ndarray, n: int) -> np.ndarray:
    """Advance CRC registers by n zero bytes (vectorized over registers)."""
    for _ in range(n):
        reg = _TBL[reg & 0xFF] ^ (reg >> np.uint32(8))
    return reg


def _pos_tables() -> np.ndarray:
    """(_BLOCK, 256): the zero-init CRC of a block holding byte b at
    position p and zeros elsewhere."""
    global _POS_TBLS
    if _POS_TBLS is None:
        tbls = np.empty((_BLOCK, 256), np.uint32)
        reg = _TBL.copy()  # the byte at the last position
        for p in range(_BLOCK - 1, -1, -1):
            tbls[p] = reg
            reg = _zero_steps(reg, 1)
        _POS_TBLS = tbls
    return _POS_TBLS


def _tables_of(basis: np.ndarray) -> np.ndarray:
    """4x256 byte lookups of the linear map with these 32 bit images:
    x -> T0[x&FF] ^ T1[(x>>8)&FF] ^ T2[(x>>16)&FF] ^ T3[x>>24]."""
    tbls = np.zeros((4, 256), np.uint32)
    bytes_ = np.arange(256, dtype=np.uint32)
    for k in range(4):
        acc = np.zeros(256, np.uint32)
        for bit in range(8):
            acc ^= np.where(bytes_ & (1 << bit), basis[8 * k + bit], np.uint32(0))
        tbls[k] = acc
    return tbls


def _apply(t: np.ndarray, x: np.ndarray) -> np.ndarray:
    return (t[0][x & 0xFF] ^ t[1][(x >> np.uint32(8)) & 0xFF]
            ^ t[2][(x >> np.uint32(16)) & 0xFF] ^ t[3][x >> np.uint32(24)])


def _shift_tables(j: int) -> np.ndarray:
    """The lookup tables of "append 2^j zero bytes" (lazy; level j + 1
    squares level j)."""
    bits = np.uint32(1) << np.arange(32, dtype=np.uint32)
    while len(_SHIFT_TBLS) <= j:
        if not _SHIFT_TBLS:
            basis = _zero_steps(bits, 1)
        else:
            prev = _SHIFT_TBLS[-1]
            basis = _apply(prev, _apply(prev, bits))
        _SHIFT_TBLS.append(_tables_of(basis))
    return _SHIFT_TBLS[j]


def _advance(regs: np.ndarray, nbytes) -> np.ndarray:
    """Advance CRC registers by zero bytes: one count for all, or one a
    register (a table lookup per set bit of the count)."""
    reg = np.array(regs, np.uint32).reshape(-1)
    n = np.broadcast_to(np.asarray(nbytes, np.int64), reg.shape)
    j = 0
    while (n >> j).any():
        sel = ((n >> j) & 1).astype(bool)
        if sel.all():
            reg = _apply(_shift_tables(j), reg)
        else:
            reg[sel] = _apply(_shift_tables(j), reg[sel])
        j += 1
    return reg


def _fold_rows(regs: np.ndarray) -> np.ndarray:
    """Left-to-right fold running = shift(running) ^ regs[:, i] from 0 of
    each row of (rows, m) block registers, as a tree: leading zero
    registers pad the count to a power of two (a shift of 0 is 0)."""
    size = 1
    while size < regs.shape[1]:
        size *= 2
    r = np.zeros((regs.shape[0], size), np.uint32)
    r[:, size - regs.shape[1]:] = regs
    j = _BLOCK_BITS
    while r.shape[1] > 1:
        r = _apply(_shift_tables(j), r[:, 0::2]) ^ r[:, 1::2]
        j += 1
    return r[:, 0]


def _block_crcs(blocks: np.ndarray) -> np.ndarray:
    """(..., _BLOCK) uint8 -> (...) zero-init CRC registers."""
    vals = _pos_tables()[np.arange(_BLOCK), blocks]
    return np.bitwise_xor.reduce(vals, axis=-1)


def _pool():
    global _POOL
    if _POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _POOL = ThreadPoolExecutor(_THREADS)
    return _POOL


def crc32c_rows(rows: np.ndarray, crc=0) -> np.ndarray:
    """(n,) uint32: the CRC-32C of each row of a C-contiguous (n, ...)
    array's bytes, `crc32c(rows[i], crc)` for every i (`crc`: one seed or
    one a row). The rows' blocks are hashed in the thread pool in tiles of
    whole rows, or of parts of one row where the rows are few, so that one
    long buffer or a handful of long rows (a scrub slice) still keeps
    every thread busy."""
    a = np.ascontiguousarray(rows)
    n = a.shape[0]
    buf = a.reshape(n, -1).view(np.uint8)
    row_bytes = buf.shape[1]
    n_blocks = row_bytes // _BLOCK
    reg = ~np.broadcast_to(np.asarray(crc, np.uint32), (n,))
    if n and n_blocks:
        full = np.lib.stride_tricks.as_strided(
            buf, (n, n_blocks, _BLOCK), (buf.strides[0], _BLOCK, 1), writeable=False)
        per = max(1, min(_CHUNK_BLOCKS, -(-n * n_blocks // _THREADS)))  # blocks a task
        if per >= n_blocks:
            step = per // n_blocks
            tiles = [(slice(s, s + step), slice(None)) for s in range(0, n, step)]
        else:
            tiles = [(r, slice(b, b + per)) for r in range(n) for b in range(0, n_blocks, per)]
        crcs = np.empty((n, n_blocks), np.uint32)

        def tile(t):
            crcs[t] = _block_crcs(full[t])

        if len(tiles) == 1:
            tile(tiles[0])
        else:
            for f in [_pool().submit(tile, t) for t in tiles]:
                f.result()
        reg = _advance(reg, n_blocks * _BLOCK) ^ _fold_rows(crcs)
    for j in range(n_blocks * _BLOCK, row_bytes):
        reg = _TBL[(reg ^ buf[:, j]) & 0xFF] ^ (reg >> np.uint32(8))
    return ~reg


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C (Castagnoli) of a bytes-like / numpy buffer. `crc` chains a
    previous call's result. Matches the RFC 3720 reference
    (crc32c(b"123456789") == 0xE3069283) and the JAX package's `crc32c`."""
    buf = np.frombuffer(memoryview(data).cast("B"), np.uint8)
    return int(crc32c_rows(buf[None], crc)[0])


def crc32c_extend(crcs: np.ndarray, data) -> np.ndarray:
    """`crc32c(data, crc=c)` for each c of a uint32 array: the checksums
    of byte strings extended by the same `data`. CRC is affine, so this
    is crc32c(data) XOR c advanced over len(data) zero bytes."""
    n = len(memoryview(data).cast("B"))
    return _advance(crcs, n) ^ np.uint32(crc32c(data))


def crc32c_patch(crcs: np.ndarray, diff: np.ndarray, tail_bytes) -> np.ndarray:
    """The checksums of byte strings of unchanged lengths after each
    changed inside one range, without reading the bytes around it: row i
    of the C-contiguous `diff` holds old XOR new over string i's changed
    range, right-aligned (zeros before it; rows a multiple of 1024 bytes
    long skip a bytewise tail), and `tail_bytes[i]` counts the bytes
    after the range. For equal lengths, crc(a) ^ crc(b) is the
    zero-init CRC of a ^ b with no final inversion, which leading zero
    bytes leave unchanged and trailing ones advance."""
    lin = ~crc32c_rows(diff, crc=0xFFFFFFFF)  # zero-init register, no final inversion
    return np.asarray(crcs, np.uint32) ^ _advance(lin, tail_bytes)


# -- atomic path writes ------------------------------------------------

@contextlib.contextmanager
def atomic_write(path: Union[str, os.PathLike]):
    """Write-to-temp-then-rename: yields the temporary path to write, then
    `os.replace`s it over `path` on success and unlinks it on failure, so
    a crash mid-write leaves the previous file whole."""
    path = os.fspath(path)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        yield tmp
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _host_array(arr) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(arr))


def serialize_arrays(
    f: Union[str, os.PathLike, io.IOBase],
    arrays: Mapping[str, Any],
    meta: Dict[str, Any] | None = None,
) -> None:
    """Write named arrays (tensors on any device, or numpy) and JSON-able
    metadata to a file or stream. Path writes are atomic and every field
    carries a CRC-32C checksum that the read path verifies."""
    bufs = []
    fields = []
    offset = 0
    for name, arr in arrays.items():
        a = _host_array(arr)
        if a.dtype.byteorder == ">":
            a = a.astype(a.dtype.newbyteorder("<"))
        offset = _align(offset)
        fields.append({
            "name": name,
            "dtype": a.dtype.str,
            "shape": list(a.shape),
            "offset": offset,
            "nbytes": int(a.nbytes),
            "crc32c": crc32c(a.reshape(-1).view(np.uint8)) if a.nbytes else 0,
        })
        bufs.append((offset, a))
        offset += a.nbytes
    header = json.dumps({"meta": meta or {}, "fields": fields}).encode()
    if isinstance(f, (str, os.PathLike)):
        with atomic_write(f) as tmp:
            with open(tmp, "wb") as fh:
                _write_stream(fh, header, bufs)
        return
    _write_stream(f, header, bufs)


def _write_stream(fh, header: bytes, bufs) -> None:
    fh.write(MAGIC)
    fh.write(struct.pack("<IQ", CONTAINER_VERSION, len(header)))
    fh.write(header)
    data_start = _align(fh.tell())
    fh.write(b"\x00" * (data_start - fh.tell()))
    pos = 0
    for off, a in bufs:
        if off > pos:
            fh.write(b"\x00" * (off - pos))
            pos = off
        fh.write(a.reshape(-1).view(np.uint8).data)
        pos += a.nbytes


def _describe(f) -> str:
    if isinstance(f, (str, os.PathLike)):
        return os.fspath(f)
    return getattr(f, "name", "<stream>")


def _read_header(fh, name: str) -> Tuple[int, dict]:
    """Magic + version + JSON header; raises `SerializationError` naming
    the file on any truncated or torn read."""
    magic = fh.read(8)
    if len(magic) < 8:
        raise SerializationError(
            f"truncated container {name!r}: {len(magic)} bytes, expected at "
            f"least the 8-byte magic {MAGIC!r}")
    if magic != MAGIC:
        raise SerializationError(
            f"not a raft_tpu serialized container (bad magic) in {name!r}: "
            f"got {magic!r}, expected {MAGIC!r}")
    lenbytes = fh.read(12)
    if len(lenbytes) < 12:
        raise SerializationError(
            f"truncated container {name!r}: header length fields missing "
            f"(got {8 + len(lenbytes)} bytes)")
    version, hlen = struct.unpack("<IQ", lenbytes)
    if version > CONTAINER_VERSION:
        raise SerializationError(
            f"container version {version} newer than supported {CONTAINER_VERSION}")
    raw = fh.read(hlen)
    if len(raw) < hlen:
        raise SerializationError(
            f"truncated container {name!r}: header says {hlen} bytes, file holds {len(raw)}")
    try:
        header = json.loads(raw.decode())
    except (json.JSONDecodeError, UnicodeDecodeError) as e:
        raise SerializationError(f"torn container header in {name!r}: {e}") from e
    if not isinstance(header, dict) or "meta" not in header:
        raise SerializationError(f"container header in {name!r} lacks the 'meta' section")
    return hlen, header


@contextlib.contextmanager
def _opened(f):
    own = isinstance(f, (str, os.PathLike))
    fh = open(f, "rb") if own else f
    try:
        yield fh
    finally:
        if own:
            fh.close()


def peek_meta(f: Union[str, os.PathLike, io.IOBase]) -> Dict[str, Any]:
    """Only a container's meta dict (magic + header; the data is never
    read): the cheap probe of which loader a checkpoint needs."""
    with _opened(f) as fh:
        return _read_header(fh, _describe(f))[1]["meta"]


def container_data_start(f: Union[str, os.PathLike, io.IOBase]) -> int:
    """Byte offset where a container's data region begins."""
    with _opened(f) as fh:
        hlen, _ = _read_header(fh, _describe(f))
        return _data_start(hlen)


def field_byte_range(f: Union[str, os.PathLike, io.IOBase], name: str) -> Tuple[int, int]:
    """Absolute (start, end) byte range of one named field's buffer."""
    with _opened(f) as fh:
        hlen, header = _read_header(fh, _describe(f))
        data_start = _data_start(hlen)
        for field in header.get("fields", ()):
            if field["name"] == name:
                start = data_start + int(field["offset"])
                return start, start + int(field["nbytes"])
        raise SerializationError(f"container {_describe(f)!r} has no field {name!r}")


def as_device_tensor(a, device, dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """A loaded array (numpy or tensor) as a tensor of `dtype` on `device`
    (a resolved device). uint32 words keep their bits as int32 (the port's
    packed-word convention, core/bitset)."""
    if not isinstance(a, torch.Tensor):
        a = np.array(a)
        if a.dtype == np.uint32 and dtype == torch.int32:
            a = a.view(np.int32)
        a = torch.from_numpy(a)
    return a.to(device=device, dtype=dtype)


def deserialize_arrays_checked(
    f: Union[str, os.PathLike, io.IOBase],
    to_device: bool = True,
    verify: bool = True,
    device=None,
) -> Tuple[Dict[str, Any], Dict[str, Any], List[str]]:
    """Like `deserialize_arrays`, but returns (arrays, meta, bad_fields)
    instead of raising on a checksum mismatch (corrupt fields still
    decode, as garbage)."""
    dev = resolve_device(device) if to_device else None
    name = _describe(f)
    with _opened(f) as fh:
        hlen, header = _read_header(fh, name)
        if "fields" not in header:
            raise SerializationError(f"container header in {name!r} lacks the 'fields' section")
        fh.seek(_data_start(hlen))
        blob = memoryview(fh.read())
    arrays: Dict[str, Any] = {}
    bad: List[str] = []
    for field in header["fields"]:
        off, nb = field["offset"], field["nbytes"]
        raw = blob[off: off + nb]
        if len(raw) < nb:
            raise SerializationError(
                f"truncated container {name!r}: field {field['name']!r} wants {nb} bytes at "
                f"offset {off}, file holds {len(raw)}")
        if verify and nb and field.get("crc32c") is not None:
            if crc32c(raw) != int(field["crc32c"]):
                bad.append(field["name"])
        a = np.frombuffer(raw, dtype=np.dtype(field["dtype"])).reshape(field["shape"])
        arrays[field["name"]] = as_device_tensor(a, dev) if to_device else a
    return arrays, header["meta"], bad


def deserialize_arrays(
    f: Union[str, os.PathLike, io.IOBase],
    to_device: bool = True,
    verify: bool = True,
    device=None,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Read a container; returns (arrays, meta). Arrays are tensors on
    `resolve_device(device)` (the card unless `device="cpu"`) when
    `to_device`, else numpy arrays. With `verify` (default) every field's
    CRC-32C is checked and a mismatch raises `ChecksumError` naming the
    corrupt fields."""
    arrays, meta, bad = deserialize_arrays_checked(f, to_device=to_device, verify=verify,
                                                   device=device)
    if bad:
        raise ChecksumError(_describe(f), bad)
    return arrays, meta


def check_ckpt_version(meta: Dict[str, Any], path: str = "<container>") -> None:
    """Refuse, typed, a checkpoint of a registered kind whose declared
    version is newer than this library writes. Unregistered kinds pass."""
    kind = meta.get("kind")
    spec = CKPT_SCHEMA.get(kind)
    if spec is None:
        return
    version = int(meta.get("version", 1))
    if version > int(spec["version"]):
        raise SerializationError(
            f"checkpoint {path!r} declares {kind!r} version {version}, newer than the "
            f"library's supported version {spec['version']} — refusing to load fields whose "
            f"semantics this build cannot know (upgrade raft_tpu)")


def read_ckpt(
    f: Union[str, os.PathLike, io.IOBase],
    kind: str,
    to_device: bool = True,
    device=None,
) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Schema-checked checkpoint read. Returns (arrays, meta) after, in
    order: the declared kind matches `kind`; the version gate
    (`check_ckpt_version`); every required ("refuse") field of the file's
    version is present; a corrupt (CRC-failed) optional ("default" /
    "derive") field is dropped, as if the writer had never emitted it,
    while a corrupt required field raises `ChecksumError` naming it."""
    spec = CKPT_SCHEMA.get(kind)
    if spec is None:
        raise SerializationError(f"no CKPT_SCHEMA entry for kind {kind!r}")
    name = _describe(f)
    arrays, meta, bad = deserialize_arrays_checked(f, to_device=to_device, device=device)
    got = meta.get("kind")
    if got != kind:
        raise SerializationError(f"not a {kind} container: {name!r} declares kind {got!r}")
    check_ckpt_version(meta, name)
    version = int(meta.get("version", 1))
    fields = spec["fields"]
    missing = [
        fname for fname, (cat, _dt, since, absent) in sorted(fields.items())
        if absent == "refuse" and since <= version
        and fname not in (arrays if cat == "array" else meta if cat == "meta" else (fname,))
    ]
    if missing:
        raise SerializationError(
            f"checkpoint {name!r} ({kind} v{version}) is missing required field(s) {missing} "
            f"— torn or foreign writer")
    if bad:
        required_bad = []
        for fname in bad:
            cat_spec = fields.get(fname)
            if cat_spec is not None and cat_spec[3] in ("default", "derive"):
                arrays.pop(fname, None)
                from raft_tpu_torch import obs

                obs.event("ckpt.degrade", file=name, field=fname, action="dropped",
                          absent=cat_spec[3])
            else:
                required_bad.append(fname)
        if required_bad:
            raise ChecksumError(name, required_bad)
    return arrays, meta
