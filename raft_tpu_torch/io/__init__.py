"""File-backed dataset streaming for builds larger than the card's memory
(counterpart of raft_tpu/io; the host-IO role of `batch_load_iterator`,
spatial/knn/detail/ann_utils.cuh:388).

Two layers:
- format probing: `.npy` and the big-ann-benchmarks binary family
  (`.fbin` f32 / `.u8bin` uint8 / `.i8bin` int8 / `.ibin` int32: a u32
  (n_rows, dim) header, then row-major data);
- `FileBatchLoader`: iterates (batch ndarray, valid_rows) with a uniform
  padded batch shape. When the port's ring-reader library loads
  (`native.loader_lib()`, built from `csrc/loader_host.cc`), a C++ reader
  thread pread()s batches into a ring of buffers AHEAD of the consumer;
  otherwise a numpy memmap twin reads synchronously (`native=None`), or
  `native=True` raises `NativeLoaderUnavailable`.

Buffer lifetime contract (native path, copy=False): a yielded batch is a
zero-copy view of a ring slot. It stays valid while the CURRENT and the
next `depth - 2` batches are being consumed, and EVERY view dies when
iteration finishes (the ring is freed on close). A copy to the card must
therefore have finished before the slot is released: `extend_from_file`
uploads each batch within its own iteration, and a non-blocking copy
from the view would need its stream synchronised first (copy into pinned
memory, or synchronise, before the next iteration step). `copy=True`
(the default) hands out owned arrays.

`extend_from_file_local` is the multi-process ingestion: every process
streams its own partition through the collective `*_extend_local`.
"""

from __future__ import annotations

import ctypes
import os
from typing import Iterator, Optional, Tuple

import numpy as np

__all__ = [
    "probe_file",
    "FileBatchLoader",
    "NativeLoaderUnavailable",
    "extend_from_file",
    "extend_from_file_local",
]


class NativeLoaderUnavailable(RuntimeError):
    """``native=True`` was requested but the C++ runtime is not built/
    loadable on this host. Typed so callers that *require* the prefetch
    ring can catch precisely this and fall back (or fail loudly) without
    swallowing unrelated RuntimeErrors."""

_BIN_DTYPES = {
    ".fbin": np.float32,
    ".u8bin": np.uint8,
    ".i8bin": np.int8,
    ".ibin": np.int32,
}


def probe_file(path: str) -> Tuple[int, Tuple[int, ...], np.dtype]:
    """Return (data_offset_bytes, shape, dtype) for a supported file.

    Supports numpy `.npy` (row-major, no pickling) and the big-ann binary
    family (u32 n_rows, u32 dim header). Raises ValueError on anything
    else — format sniffing a 100 GB file must fail loudly, not guess.
    """
    ext = os.path.splitext(path)[1].lower()
    if ext == ".npy":
        with open(path, "rb") as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, fortran, dtype = np.lib.format.read_array_header_1_0(f)
            elif version in ((2, 0), (3, 0)):
                shape, fortran, dtype = np.lib.format.read_array_header_2_0(f)
            else:
                raise ValueError(f"{path}: unsupported .npy version {version}")
            if fortran:
                raise ValueError(f"{path}: Fortran-order .npy is not streamable row-major")
            if dtype.hasobject:
                raise ValueError(f"{path}: object dtypes are not supported")
            return f.tell(), tuple(int(s) for s in shape), dtype
    if ext in _BIN_DTYPES:
        dtype = np.dtype(_BIN_DTYPES[ext])
        with open(path, "rb") as f:
            hdr = f.read(8)
        if len(hdr) != 8:
            raise ValueError(f"{path}: truncated big-ann header")
        n, dim = np.frombuffer(hdr, np.uint32)
        expect = 8 + int(n) * int(dim) * dtype.itemsize
        actual = os.path.getsize(path)
        if actual < expect:
            raise ValueError(
                f"{path}: file holds {actual} bytes, header promises {expect}"
            )
        return 8, (int(n), int(dim)), dtype
    raise ValueError(f"unsupported dataset file extension {ext!r} ({path})")


class FileBatchLoader:
    """Iterate a row-major on-disk array in uniform (padded) batches.

    Yields (batch, valid_rows) where batch is (batch_rows, *row_shape) of
    the file's dtype; the final partial batch is zero-padded and `valid`
    gives its true row count (one batch shape, the BatchLoadIterator
    convention). Usable as a context manager; iterating
    twice re-opens the underlying stream.
    """

    def __init__(
        self,
        path: str,
        batch_rows: int,
        depth: int = 3,
        copy: bool = True,
        native: Optional[bool] = None,
        start_batch: int = 0,
    ):
        if batch_rows <= 0:
            raise ValueError("batch_rows must be positive")
        self.path = path
        self.data_off, self.shape, self.dtype = probe_file(path)
        if len(self.shape) == 0:
            raise ValueError(f"{path}: scalar arrays are not streamable")
        self.n_rows = self.shape[0]
        self.row_shape = self.shape[1:]
        self.row_bytes = int(np.prod(self.row_shape, dtype=np.int64)) * self.dtype.itemsize
        if self.row_bytes <= 0:
            raise ValueError(f"{path}: zero-byte rows are not streamable")
        self.batch_rows = int(batch_rows)
        self.depth = max(2, int(depth))
        self.copy = copy
        self.n_batches = -(-self.n_rows // self.batch_rows) if self.n_rows else 0
        # start_batch: resume a killed streaming build mid-file: batches
        # [start_batch, n_batches) yield with IDENTICAL contents/padding
        # to the same positions of a from-zero iteration (batch geometry
        # is anchored to the file start, so a cursor-driven resume is
        # bit-identical)
        if not (0 <= int(start_batch) <= self.n_batches):
            raise ValueError(
                f"start_batch={start_batch} outside [0, {self.n_batches}]")
        self.start_batch = int(start_batch)
        if native is None:
            from raft_tpu_torch import native as native_mod

            self._lib = native_mod.loader_lib()
        elif native:
            from raft_tpu_torch import native as native_mod

            self._lib = native_mod.loader_lib()
            if self._lib is None:
                raise NativeLoaderUnavailable(
                    "native loader requested but library unavailable: "
                    f"{native_mod.loader_error()}")
        else:
            self._lib = None

    def __len__(self) -> int:
        return self.n_batches

    # -- native path ------------------------------------------------------
    def _iter_native(self) -> Iterator[Tuple[np.ndarray, int]]:
        lib = self._lib
        # resume: shift the data window to the first resumed batch — the
        # batch grid is anchored to the file start and start_batch lands
        # on a grid line, so the remaining batches (incl. the padded
        # tail) are bit-identical to a from-zero iteration's tail
        skip_rows = self.start_batch * self.batch_rows
        handle = lib.rt_loader_open(
            self.path.encode(),
            self.data_off + skip_rows * self.row_bytes, self.row_bytes,
            self.n_rows - skip_rows, self.batch_rows, self.depth,
        )
        if not handle:
            raise OSError(f"rt_loader_open failed for {self.path}")
        outstanding = 0
        try:
            while True:
                ptr = ctypes.POINTER(ctypes.c_uint8)()
                rows = lib.rt_loader_acquire(handle, ctypes.byref(ptr))
                if rows == 0:
                    break
                if rows < 0:
                    raise OSError(f"loader IO error {rows} reading {self.path}")
                outstanding += 1
                buf = np.ctypeslib.as_array(ptr, shape=(self.batch_rows * self.row_bytes,))
                batch = np.frombuffer(buf, dtype=self.dtype).reshape(
                    (self.batch_rows,) + self.row_shape
                )
                rows = int(rows)
                if rows < self.batch_rows:
                    # pad the tail batch; the ring slot itself must not be
                    # mutated (the reader owns its contents), so pad a copy
                    pad = np.zeros_like(batch)
                    pad[:rows] = batch[:rows]
                    batch = pad
                elif self.copy:
                    batch = batch.copy()
                yield batch, rows
                # hold `depth - 1` slots (current + depth-2 previous) so a
                # yielded view's documented lifetime scales with depth; the
                # one remaining slot keeps the reader prefetching ahead
                if outstanding > self.depth - 1:
                    lib.rt_loader_release(handle)
                    outstanding -= 1
        finally:
            lib.rt_loader_close(handle)

    # -- memmap fallback --------------------------------------------------
    def _iter_fallback(self) -> Iterator[Tuple[np.ndarray, int]]:
        mm = np.memmap(
            self.path, dtype=self.dtype, mode="r", offset=self.data_off,
            shape=(self.n_rows,) + self.row_shape,
        )
        for b in range(self.start_batch, self.n_batches):
            lo = b * self.batch_rows
            hi = min(lo + self.batch_rows, self.n_rows)
            # materialize now: np.asarray of a memmap slice is a lazy view
            # that would defer page-in to first touch, breaking the "batch
            # is resident when yielded" contract the native path provides
            block = np.array(mm[lo:hi])
            if hi - lo < self.batch_rows:
                pad = np.zeros(
                    (self.batch_rows,) + self.row_shape, self.dtype
                )
                pad[: hi - lo] = block
                block = pad
            yield block, hi - lo

    def __iter__(self) -> Iterator[Tuple[np.ndarray, int]]:
        if self.start_batch >= self.n_batches:
            return iter(())  # fully-consumed resume: nothing left
        if self._lib is not None:
            return self._iter_native()
        return self._iter_fallback()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        # iteration owns the native handle; nothing held between iterations
        return False


def extend_from_file(extend_fn, index, path: str, batch_rows: int,
                     start_id: int = 0, depth: int = 3):
    """Stream an on-disk dataset into an ANN index via repeated
    `extend_fn` (ivf_flat.extend / ivf_pq.extend), the file-backed variant
    of `neighbors.batch_loader.extend_batched`. The ring reader prefetches
    batch b+1 from disk while the device encodes batch b. Each zero-copy
    batch is handed to `extend_fn`, which copies it to the card (a
    synchronous copy) before the next iteration releases its slot."""
    loader = FileBatchLoader(path, batch_rows, depth=depth, copy=False)
    offset = start_id
    for batch, valid in loader:
        ids = np.arange(offset, offset + valid, dtype=np.int32)
        index = extend_fn(index, batch[:valid], ids)
        offset += valid
    return index


def extend_from_file_local(extend_local_fn, index, path: str, batch_rows: int, depth: int = 3):
    """Collective file-backed ingestion of the multi-process API: every
    process streams its own on-disk partition through repeated
    `extend_local_fn` (comms.mnmg.ivf_flat_extend_local /
    ivf_pq_extend_local). Files may hold different row counts, but every
    process must make the same number of `extend_local` calls (they are
    collective): the batch count is agreed first (one allreduce of
    ceil(rows / batch_rows)), and a process whose file runs out early goes
    on with empty batches. The collective extend assigns the ids (the
    process-order continuation of the id space)."""
    loader = FileBatchLoader(path, batch_rows, depth=depth, copy=False)
    total_batches = loader.n_batches
    comms = getattr(index, "comms", None)
    if comms is not None and comms.spans_processes():
        import torch
        import torch.distributed as dist

        t = torch.tensor([total_batches], dtype=torch.int64, device=comms.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        total_batches = int(t.item())
    empty = np.zeros((0,) + tuple(loader.shape[1:]), loader.dtype)
    it = iter(loader)
    for _ in range(total_batches):
        try:
            batch, valid = next(it)
            rows = batch[:valid]
        except StopIteration:
            rows = empty
        index = extend_local_fn(index, rows)
    return index
