"""Launch plumbing shared by every kernel wrapper under `raft_tpu_torch.ops`.

  `_check`, `_tensor_arg`  argument checks a wrapper makes before it picks
                           the plain version (CPU) or the kernel (CUDA);
  `_kernel_fn`             the ctypes function of a kernel's launcher,
                           building its library on first use (`_build`);
  `_raise_on`              a launcher's `cudaError_t`, as an exception;
  `_launches`              one launch count per kernel. A wrapper adds one
                           to its kernel's entry where it launches the
                           kernel, and nowhere else (`_count_launch`,
                           under a lock: the ranks of an in-process comms
                           world launch from several threads at once);
                           `launch_counts()` and `reset_launch_counts()`
                           read and clear all of them (`fused_scan`
                           re-exports both).
"""

from __future__ import annotations

import ctypes
import threading

import torch

_P = ctypes.c_void_p
_I = ctypes.c_int

#: launches per kernel since the last reset
_launches = {"fused_topk": 0, "fused_list_topk": 0, "fused_list_topk_int8": 0,
             "pq_list_scan": 0, "pairwise_tiled": 0, "fused_l2_argmin": 0,
             "counting_select_min": 0, "fused_bitplane_topk": 0}
_launches_lock = threading.Lock()
_fns: dict = {}


def _check(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


def _tensor_arg(name, t, dtypes, ndim, device):
    _check(isinstance(t, torch.Tensor), f"{name} must be a tensor")
    _check(t.dtype in dtypes, f"{name}: dtype {t.dtype} not in {dtypes}")
    _check(t.ndim == ndim, f"{name}: expected {ndim}-d, got {t.ndim}-d")
    _check(t.is_contiguous(), f"{name} must be contiguous")
    _check(t.device == device, f"{name} is on {t.device}, expected {device}")


def _kernel_fn(source: str, name: str, argtypes):
    key = (source, name)
    fn = _fns.get(key)
    if fn is None:
        from raft_tpu_torch.ops import _build

        fn = getattr(_build.load(source), name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[key] = fn
    return fn


def _raise_on(err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")


def _count_launch(name: str) -> None:
    """Add one launch of kernel `name` (a read-modify-write, so locked)."""
    with _launches_lock:
        _launches[name] += 1


def reset_launch_counts() -> None:
    with _launches_lock:
        for name in _launches:
            _launches[name] = 0


def launch_counts() -> dict:
    """{kernel name: launches since the last reset}, all eight kernels."""
    with _launches_lock:
        return dict(_launches)
