"""raft_tpu_torch.obs: library-wide observability (counterpart of
raft_tpu/obs).

A thread-safe metric registry (counters / gauges / histograms),
structured nested spans, and an ordered event bus that the neighbors
entry points, adaptive probing, live mutation, the integrity layer,
`core.faults` injections and `core.logger` feed (the collectives and the
serving engine join with their layers). Exporters render the joined
state as a JSON snapshot, Prometheus exposition text, or a
`torch.profiler` trace session; `python -m raft_tpu_torch.obs.report`
turns a snapshot into a human-readable run report.

Gating: everything is off by default. Enable with `RAFT_TPU_OBS=1` in
the environment or `obs.enable()` at run time. Disabled, every hook is
one module-attribute read and a branch, and nothing reads the device:
the entry points' results are the same either way (the hooks only
observe).

Spans measure host wall time; CUDA work runs asynchronously, so a span
covers device time only where it fences (`span.fence(value)`
synchronizes the devices of the value's tensors). Spans and events count
per call.

Public surface:

    obs.enable() / obs.disable() / obs.enabled()
    obs.registry() -> Registry       obs.counter/gauge/histogram(name)
    obs.bus() -> EventBus            obs.event(kind, **fields)
    obs.span(name, **attrs)          obs.capture_spans()
    obs.span_cost(flops=, bytes=)    (analytic-cost hook; obs.perf formulas)
    obs.trace_range / obs.annotate   (re-exported from core.tracing)
    obs.collective(op, x, axis=..., world=...)  (comms hook)
    obs.snapshot() / obs.save_snapshot(path)
    obs.render_prometheus(...) / obs.render_registry_prometheus()
    obs.trace_session(logdir)
    obs.reset()
"""

from __future__ import annotations

import os

from raft_tpu_torch.core.tracing import annotate, trace_range  # noqa: F401
from raft_tpu_torch.obs import bus as _bus_mod
from raft_tpu_torch.obs import registry as _reg_mod
from raft_tpu_torch.obs.export import (  # noqa: F401
    prom_name,
    render_prometheus,
    render_registry_prometheus,
    save_snapshot,
    snapshot,
    trace_session,
)
from raft_tpu_torch.obs import flight, ledger, perf, slo, trace  # noqa: F401
from raft_tpu_torch.obs.registry import Counter, Gauge, Histogram, Registry  # noqa: F401
from raft_tpu_torch.obs.spans import (  # noqa: F401
    NULL_SPAN,
    SpanCapture,
    capture_spans,
    current_span,
    open_spans,
    span_impl,
)
from raft_tpu_torch.obs.trace import TraceCtx, to_chrome_trace  # noqa: F401

ENV_FLAG = "RAFT_TPU_OBS"

_ENABLED = False
_LOG_HANDLER = None


def enabled() -> bool:
    return _ENABLED


def enable(flag: bool = True) -> None:
    """Turn observability on (or off with `flag=False`). Enabling also
    bridges `core.logger` records onto the event bus (and arms the flight
    recorder when `RAFT_TPU_FLIGHT_DIR` is set); disabling removes the
    bridge. Idempotent."""
    global _ENABLED
    _ENABLED = bool(flag)
    _bridge_logger(_ENABLED)
    if _ENABLED:
        # RAFT_TPU_FLIGHT_DIR auto-arms the crash flight recorder
        flight.maybe_env_install()


def disable() -> None:
    enable(False)


def _bridge_logger(install: bool) -> None:
    """Install/remove the logging.Handler that routes raft_tpu_torch log
    records to the bus as kind="log" events. Lives here (not in
    core/logger) so the logger has no obs dependency and the disabled
    path pays nothing."""
    global _LOG_HANDLER
    import importlib
    import logging

    # not `import raft_tpu_torch.core.logger as m`: the core package
    # binds the attribute `logger` to the Logger object, shadowing the
    # module for every attribute-based import form
    _logger_mod = importlib.import_module("raft_tpu_torch.core.logger")

    if install:
        if _LOG_HANDLER is None:
            class _BusHandler(logging.Handler):
                def emit(self, record):
                    try:
                        event("log", level=record.levelname,
                              logger=record.name, msg=record.getMessage())
                    except Exception:
                        self.handleError(record)

            _LOG_HANDLER = _BusHandler()
        if _LOG_HANDLER not in _logger_mod.logger.handlers:
            _logger_mod.logger.addHandler(_LOG_HANDLER)
    elif _LOG_HANDLER is not None:
        _logger_mod.logger.removeHandler(_LOG_HANDLER)


def registry() -> Registry:
    return _reg_mod.GLOBAL


def bus() -> _bus_mod.EventBus:
    return _bus_mod.GLOBAL


def counter(name: str) -> Counter:
    return _reg_mod.GLOBAL.counter(name)


def gauge(name: str) -> Gauge:
    return _reg_mod.GLOBAL.gauge(name)


def histogram(name: str) -> Histogram:
    return _reg_mod.GLOBAL.histogram(name)


def event(kind: str, **fields):
    """Publish one event when enabled; returns its seq (None when
    disabled). The one hook every instrumented site calls."""
    if not _ENABLED:
        return None
    return _bus_mod.GLOBAL.publish(kind, **fields)


def span(name: str, **attrs):
    """Nested timed scope (see `obs.spans`). Disabled: yields an inert
    singleton without entering a generator frame."""
    if not _ENABLED:
        return _NULL_CTX
    return span_impl(name, **attrs)


class _ReusableNullCtx:
    """Allocation-free disabled-path context manager (a fresh
    generator per call would dominate the disabled cost)."""

    __slots__ = ()

    def __enter__(self):
        return NULL_SPAN

    def __exit__(self, *exc):
        return False


_NULL_CTX = _ReusableNullCtx()


def spanned(name: str, **attrs):
    """Decorator form of `span` (the obs counterpart of
    `tracing.annotate`): wraps entry points so every call lands one
    timed span. Disabled, the wrapper costs one attribute read and a
    branch before tail-calling the target."""
    import functools

    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            if not _ENABLED:
                return f(*args, **kwargs)
            with span_impl(name, **attrs):
                return f(*args, **kwargs)

        return wrapper

    return deco


def span_cost(flops=None, bytes=None, dtype=None, flops_by_dtype=None,
              **attrs):
    """Charge analytic cost (an `obs.perf` formula's kwargs) to the
    innermost open span on this thread; no-op when disabled or outside
    any span. Composite formulas pass their per-dtype flops split as
    `flops_by_dtype` so mixed-dtype spans (int8 scan + f32 coarse +
    uint32 popcount) weigh each component against its own peak. Returns
    the span (None when nothing was charged)."""
    if not _ENABLED:
        return None
    sp = current_span()
    if sp is not None:
        sp.cost(flops=flops, bytes=bytes, dtype=dtype,
                flops_by_dtype=flops_by_dtype, **attrs)
    return sp


def collective(op: str, x, axis: str = "", world=None, wire_bytes=None,
               wire_dtype=None) -> None:
    """Comms instrumentation hook: account one collective op of payload
    `x` (a tensor or array: only .shape/.dtype are touched, so nothing is
    read from the device). With `world`, the modeled per-rank wire
    traffic (obs.perf.collective_wire_bytes) is counted too, the byte
    history wire-savings claims are judged against.

    Quantized transports pass `wire_bytes`, the actual per-rank bytes
    moved (quantized payload + scale sidecars, summed over ring hops),
    overriding the `world` model, plus `wire_dtype` naming the wire
    representation; `x` stays the logical payload, so `comms.<op>.bytes`
    keeps counting what callers asked to move while
    `comms.<op>.wire_bytes` counts what the wire carried."""
    if not _ENABLED:
        return
    try:
        shape = getattr(x, "shape", ())
        dtype = getattr(x, "dtype", None)
        itemsize = getattr(dtype, "itemsize", None)
        if itemsize is None:
            import numpy as _np

            itemsize = _np.dtype(dtype if dtype is not None else _np.float32).itemsize
        nbytes = int(itemsize)
        for dim in shape:
            nbytes *= int(dim)
    except (TypeError, ValueError):
        nbytes = 0
    _reg_mod.GLOBAL.counter(f"comms.{op}.calls").inc()
    _reg_mod.GLOBAL.counter(f"comms.{op}.bytes").inc(nbytes)
    fields = {}
    if wire_bytes is not None:
        wire = int(wire_bytes)
        _reg_mod.GLOBAL.counter(f"comms.{op}.wire_bytes").inc(wire)
        fields["wire_bytes"] = wire
        if wire_dtype is not None:
            fields["wire_dtype"] = str(wire_dtype)
        if world is not None:
            fields["world"] = int(world)
    elif world is not None:
        wire = perf.collective_wire_bytes(op, nbytes, int(world))
        _reg_mod.GLOBAL.counter(f"comms.{op}.wire_bytes").inc(wire)
        fields["wire_bytes"] = wire
        fields["world"] = int(world)
    _bus_mod.GLOBAL.publish("collective", op=op, bytes=nbytes, axis=axis,
                            **fields)


def reset() -> None:
    """Zero every global metric, clear the event log, restart the
    trace-id mint, and clear the flight ring (test hygiene;
    enabled/disabled state is untouched). The mint reset is what makes
    a replayed drill re-mint the identical trace-id sequence."""
    _reg_mod.GLOBAL.reset()
    _bus_mod.GLOBAL.clear()
    trace.reset()
    flight.reset()


# the environment gate at import time: `RAFT_TPU_OBS=1 python -m ...`
# needs no code change to light the whole library up
if os.environ.get(ENV_FLAG, "").strip().lower() not in ("", "0", "false", "off"):
    enable()


__all__ = [
    "ENV_FLAG",
    "Counter",
    "Gauge",
    "Histogram",
    "Registry",
    "SpanCapture",
    "annotate",
    "bus",
    "capture_spans",
    "collective",
    "counter",
    "current_span",
    "disable",
    "flight",
    "enable",
    "enabled",
    "event",
    "gauge",
    "histogram",
    "ledger",
    "open_spans",
    "perf",
    "prom_name",
    "registry",
    "render_prometheus",
    "render_registry_prometheus",
    "reset",
    "save_snapshot",
    "slo",
    "snapshot",
    "span",
    "span_cost",
    "spanned",
    "to_chrome_trace",
    "trace",
    "trace_range",
    "trace_session",
    "TraceCtx",
]
