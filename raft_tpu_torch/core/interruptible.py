"""Cooperative cancellation of device synchronization (counterpart of
raft_tpu/core/interruptible.py; `raft::interruptible`
core/interruptible.hpp:66-100, pylibraft's `synchronize` / `cancel`).

`synchronize` waits for CUDA work by polling `torch.cuda.Event.query()`
between short sleeps, with a per-thread cancellation flag, so another
thread can interrupt the wait (`cancel(thread_id)`): the waiting thread
raises `InterruptedException`; the device work itself runs on, as in the
reference (the stream is not destroyed). Waitables: CUDA tensors (an
event recorded on their device's current stream), `torch.cuda.Event`s
and `torch.cuda.Stream`s, or any object with a `query()` method; CPU
tensors are ready.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import Dict

import torch


class InterruptedException(RuntimeError):
    """Raised inside `synchronize` when another thread calls `cancel`."""


class TimeoutException(RuntimeError):
    """Raised by `synchronize(..., timeout_s=)` when the work misses the
    deadline. The device work is NOT cancelled (cooperative semantics, as
    `cancel`); the waiting thread just stops waiting."""


_flags: Dict[int, threading.Event] = {}
_flags_lock = threading.Lock()


def _token(tid=None) -> threading.Event:
    tid = threading.get_ident() if tid is None else tid
    with _flags_lock:
        ev = _flags.get(tid)
        if ev is None:
            ev = _flags[tid] = threading.Event()
        return ev


def cancel(thread_id: int) -> None:
    """Signal the given thread's next or ongoing `synchronize` to abort."""
    _token(thread_id).set()


def _waitable(obj):
    """Something with `query()`, or None when `obj` is ready."""
    if isinstance(obj, torch.Tensor):
        if obj.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(obj.device))
        return ev
    if hasattr(obj, "query"):
        return obj
    return None


def synchronize(*arrays, poll_interval_s: float = 0.001, timeout_s=None) -> None:
    """Wait for the work behind `arrays`, honoring cancellation from other
    threads. With `timeout_s`, raise `TimeoutException` once the deadline
    (over the whole call) passes while any of it is pending."""
    ev = _token()
    if ev.is_set():
        ev.clear()
        raise InterruptedException("interrupted before synchronize")
    deadline = None if timeout_s is None else time.monotonic() + timeout_s
    pending = [w for w in (_waitable(a) for a in arrays) if w is not None]
    for w in pending:
        while True:
            if ev.is_set():
                ev.clear()
                raise InterruptedException("synchronize interrupted")
            if w.query():
                break
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutException(f"synchronize exceeded timeout_s={timeout_s}")
            time.sleep(poll_interval_s)


@contextlib.contextmanager
def interruptible():
    """Scope marker (parity with `cuda_interruptible`); clears stale flags."""
    ev = _token()
    ev.clear()
    try:
        yield
    finally:
        ev.clear()
