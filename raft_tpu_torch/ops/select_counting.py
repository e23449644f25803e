"""Exact k smallest per row by counting select (counterpart of
raft_tpu/ops/select_counting.py).

`counting_select_min` is the wrapper over the hand-written CUDA kernel
`csrc/select_counting.cu`; `counting_select_min_plain` is the plain
PyTorch version of the same function beside it. The wrapper takes the
plain version only for tensors on the CPU; for a CUDA tensor it launches
the kernel or raises, and adds one to `launch_counts()
["counting_select_min"]` (`ops._launch`) where it launches.

Contract (the JAX kernel's): for each row of a (B, L) f32 matrix, exactly
the k smallest values under the total order of the f32 bits (-0.0 before
+0.0, -NaN first, +NaN last), ties to the smaller index; returned
UNSORTED as (B, k) f32 values and int32 row-local ids. Values come back
as the JAX kernel extracts them, by a masked sum (the element plus +0.0):
a selected -0.0 returns as +0.0 (select_k's final best-first sort then
orders such zeros by position, as the JAX one does). The order is the JAX
kernel's position order: with T the k-th smallest key,
every element below T in index order, then the first k - count(< T)
elements equal to T in index order. The caller pads rows to a multiple of
128 with +inf, so a real +inf precedes the pad columns and wins by index.

`fits_counting` is the port's own envelope, not the JAX one (`k <= 256`,
16 L bytes within 10 MB: a TPU VMEM budget). The Hopper kernel takes any
L and any k <= L. Its launcher picks one of two variants by k (the
switch is `SMALL_K_MAX`, csrc/select_counting.cu's kSmallK): up to it, one
warp a row keeps the running k smallest in registers over one pass from
device memory; past it (or for a row not 16-byte aligned), a radix select
whose four histogram passes re-read rows that do not fit in shared
memory. Both return the same bits. A tuned promotion (matrix/select_k
`_counting_promoted`) sends only the one-pass variant's shapes here.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.ops._launch import (_I, _P, _check, _count_launch, _kernel_fn,
                                         _raise_on, _tensor_arg)

_LANES = 128
#: the largest k of the CUDA kernel's one-pass variant (kSmallK)
SMALL_K_MAX = 128


def fits_counting(B: int, L: int, k: int) -> bool:
    """The shapes a tuned promotion sends to the kernel: rows of a
    multiple of 128 (the caller pads), 0 < k <= min(L, SMALL_K_MAX) (the
    one-pass variant), and B and L within the launcher's int arguments."""
    return (0 < int(k) <= min(int(L), SMALL_K_MAX) and int(L) % _LANES == 0
            and 0 < int(B) < 2**31 and int(L) < 2**31)


def _monotone_u32(x: torch.Tensor) -> torch.Tensor:
    """The order-preserving image of f32 bits as uint32, held in int64:
    ascending under the total order (the JAX `_monotone_u32` map: negative
    values flip every bit, the others set the sign bit)."""
    i = x.float().contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, ~i & 0xFFFFFFFF, i | 0x80000000)


def _exclusive_rank(mask: torch.Tensor) -> torch.Tensor:
    m = mask.to(torch.int64)
    return torch.cumsum(m, dim=1) - m


def counting_select_min_plain(vals: torch.Tensor, k: int):
    """Plain PyTorch version of the kernel: the k-th smallest key T of
    each row; every element below T at its rank among them, then the
    first k - count(< T) elements equal to T after them."""
    B, L = vals.shape
    key = _monotone_u32(vals)
    t = torch.kthvalue(key, int(k), dim=1, keepdim=True).values
    lt, eq = key < t, key == t
    n_lt = lt.sum(1, keepdim=True)
    pos = torch.where(lt, _exclusive_rank(lt), n_lt + _exclusive_rank(eq))
    pos = torch.where((lt | eq) & (pos < int(k)), pos, int(k))  # the rest to a spare column
    idx = torch.zeros((B, int(k) + 1), dtype=torch.int64, device=vals.device)
    idx.scatter_(1, pos, torch.arange(L, device=vals.device).expand(B, L))
    idx = idx[:, :int(k)]
    v = torch.gather(vals, 1, idx)
    return torch.where(v == 0, 0.0, v), idx.to(torch.int32)


def counting_select_min(vals: torch.Tensor, k: int):
    """Exact k smallest per row of contiguous (B, L) f32 `vals`, L a
    multiple of 128 (pad with +inf), 0 < k <= L. Returns ((B, k) f32
    values, (B, k) int32 row-local ids), unsorted, in the position order
    of the module docstring."""
    _check(isinstance(vals, torch.Tensor), "vals must be a tensor")
    dev = vals.device
    _tensor_arg("vals", vals, (torch.float32,), 2, dev)
    B, L = vals.shape
    _check(L % _LANES == 0, f"row length {L} must be a multiple of {_LANES}")
    _check(0 < int(k) <= L, f"k={k} out of range for row length {L}")
    if dev.type == "cpu":
        return counting_select_min_plain(vals, int(k))
    _check(dev.type == "cuda", f"counting_select_min runs on cpu or cuda, got {dev}")
    out_v = torch.empty((B, int(k)), dtype=torch.float32, device=dev)
    out_i = torch.empty((B, int(k)), dtype=torch.int32, device=dev)
    fn = _kernel_fn("select_counting.cu", "counting_select_min_launch",
                    [_P, _P, _P, _I, _I, _I, _P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(vals.data_ptr(), out_v.data_ptr(), out_i.data_ptr(), B, L, int(k), stream)
    _raise_on(err, "counting_select_min")
    _count_launch("counting_select_min")
    return out_v, out_i
