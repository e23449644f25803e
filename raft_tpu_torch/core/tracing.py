"""Tracing / profiling annotations (counterpart of raft_tpu/core/tracing.py;
the reference's NVTX ranges, core/nvtx.hpp:25-76).

`trace_range` opens a `torch.profiler.record_function` scope (a named
span on the profiler's host timeline, with the device work launched
inside it under that name) and, when CUDA is initialised, an NVTX range
(`torch.cuda.nvtx`), which Nsight tools show. `annotate` is its
decorator form; `enable(False)` turns both into no-ops.
"""

from __future__ import annotations

import contextlib
import functools

import torch

_ENABLED = True


def enable(flag: bool = True) -> None:
    global _ENABLED
    _ENABLED = flag


@contextlib.contextmanager
def trace_range(name: str, **kwargs):
    """RAII-style scope, `common::nvtx::range fun_scope("fn")`:

        with trace_range("raft_tpu_torch.distance.pairwise"):
            ...

    `**kwargs` are shown as the span's arguments (record_function's
    `args` string); the disabled path takes the same signature."""
    if not _ENABLED:
        yield
        return
    args = ", ".join(f"{k}={v}" for k, v in sorted(kwargs.items())) or None
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    with torch.profiler.record_function(name, args):
        if nvtx:
            torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            if nvtx:
                torch.cuda.nvtx.range_pop()


def annotate(name: str, **kwargs):
    """Decorator form of trace_range; `**kwargs` forward to it."""
    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **fn_kwargs):
            with trace_range(name, **kwargs):
                return f(*args, **fn_kwargs)

        return wrapper

    return deco
