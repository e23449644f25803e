"""Host-to-device batch streaming for datasets larger than the card's
memory (counterpart of raft_tpu/neighbors/batch_loader.py;
spatial/knn/detail/ann_utils.cuh:388 `batch_load_iterator`).

`BatchLoadIterator` yields device tensors of one uniform (padded) batch
shape and each batch's count of real rows. With `prefetch`, the next
batch's host-to-device copy is queued before the current batch is
yielded: on CUDA the block is staged in pinned host memory and copied
with `non_blocking=True` on the current stream, so the copy overlaps the
caller's work on the batch before it (PyTorch's pinned-memory allocator
keeps the staging buffer until the copy has run).

The fault site `batch_loader.load` (`core.faults`) sits in every block
fetch: `fault_point` (slow reads, flaky reads) and `corrupt_host` (NaNs in
a streamed block), scoped to this process's rank
(`torch.distributed.get_rank()` when a process group is initialised,
else 0).
"""

from __future__ import annotations

from typing import Iterator, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import faults
from raft_tpu_torch.core.config import resolve_device


def _rank() -> int:
    dist = torch.distributed
    if dist.is_available() and dist.is_initialized():
        return int(dist.get_rank())
    return 0


class BatchLoadIterator:
    """Iterate a host array (numpy, memmap or CPU tensor) in device
    batches. Every yielded block has the SAME shape (batch_size, ...): the
    final partial batch is zero-padded, and `valid` gives its true row
    count. `dtype` (numpy) converts each block on the host."""

    def __init__(self, host_array, batch_size: int, device=None, prefetch: bool = True,
                 dtype=None):
        self.host = host_array
        self.n = int(host_array.shape[0])
        self.batch_size = int(batch_size)
        if self.batch_size <= 0:
            raise ValueError("batch_size must be positive")
        self.device = resolve_device(device)
        self.prefetch = prefetch
        self.dtype = dtype
        self.n_batches = -(-self.n // self.batch_size) if self.n else 0

    def __len__(self) -> int:
        return self.n_batches

    def _load(self, b: int) -> Tuple[torch.Tensor, int]:
        # chaos site: slow/flaky host reads and poisoned blocks; no-op
        # without a plan
        faults.fault_point("batch_loader.load", rank=_rank())
        lo = b * self.batch_size
        hi = min(lo + self.batch_size, self.n)
        block = np.asarray(self.host[lo:hi])
        block = faults.corrupt_host("batch_loader.load", block, rank=_rank())
        if self.dtype is not None:
            block = block.astype(self.dtype, copy=False)
        valid = hi - lo
        if valid < self.batch_size:
            pad = np.zeros((self.batch_size - valid,) + block.shape[1:], block.dtype)
            block = np.concatenate([block, pad], axis=0)
        elif not block.flags.writeable or not block.flags.c_contiguous:
            block = np.ascontiguousarray(block).copy()
        t = torch.from_numpy(block)
        if self.device.type == "cuda":
            t = t.pin_memory().to(self.device, non_blocking=True)
        else:
            t = t.to(self.device, copy=True)  # never a view of the host array
        return t, valid

    def __iter__(self) -> Iterator[Tuple[torch.Tensor, int]]:
        """Yields (device_block, valid_rows)."""
        if self.n_batches == 0:
            return
        if not self.prefetch:
            for b in range(self.n_batches):
                yield self._load(b)
            return
        # the next batch's copy is queued before the current one is handed
        # to the caller
        nxt = self._load(0)
        for b in range(1, self.n_batches):
            cur, nxt = nxt, None
            nxt = self._load(b)
            yield cur
        yield nxt


def extend_batched(extend_fn, index, host_array, batch_size: int, start_id: int = 0):
    """Stream `host_array` into an ANN index via repeated `extend_fn`
    (ivf_flat.extend / ivf_pq.extend), the reference's big-build loop:
    each batch is sliced from the host array and uploaded once by
    `extend`, with int32 ids from `start_id` on."""
    n = int(host_array.shape[0])
    offset = start_id
    for lo in range(0, n, batch_size):
        hi = min(lo + batch_size, n)
        ids = np.arange(offset, offset + (hi - lo), dtype=np.int32)
        index = extend_fn(index, np.asarray(host_array[lo:hi]), ids)
        offset += hi - lo
    return index
