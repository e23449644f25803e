"""Structured spans: nested, timed scopes over the hot paths
(counterpart of raft_tpu/obs/spans.py).

`core/tracing.trace_range` names a scope on the profiler's timeline;
spans are its accounting counterpart: each times a named scope with the
monotonic clock, knows its parent (a per-thread stack), lands one "span"
event on the bus at close, and aggregates its duration into the
`span.<name>` histogram, so a run report says where wall-clock went
without a profiler session.

Timing (important on an asynchronous device): a span measures HOST wall
time of the scope. CUDA launches return before the card finishes, so a
span around `search(...)` alone measures the launches. To charge device
time to the span, fence the result inside the scope:

    with obs.span("ivf.search") as sp:
        vals, ids = ivf_flat.search(p, index, q, k)
        sp.fence((vals, ids))      # synchronizes the tensors' devices

`fence` returns its argument, so it composes inline; it synchronizes
every CUDA device a tensor of the (nested tuple, list or dict) value
lies on, the port's `jax.block_until_ready`. With observability disabled
`span()` yields an inert singleton and touches no clock, no stack, no
lock, but its `fence` still synchronizes: callers rely on that.
"""

from __future__ import annotations

import contextlib
import threading
import time

import torch

from raft_tpu_torch.obs import bus as _bus_mod
from raft_tpu_torch.obs import registry as _reg_mod

_TLS = threading.local()

# every thread's span stack, registered on first use so the flight
# recorder can enumerate what was OPEN at crash time across all threads
# (entries are tiny and live for the process; the lock is taken once
# per thread lifetime, never per span)
_STACKS_LOCK = threading.Lock()
_ALL_STACKS: dict = {}


class Span:
    """One open scope. `set(**attrs)` attaches fields to the close
    event; `cost()` charges analytic flops/bytes (obs.perf formulas);
    `fence(x)` blocks on device results inside the timer."""

    __slots__ = ("name", "depth", "parent", "attrs", "t0")

    def __init__(self, name: str, depth: int, parent, attrs: dict):
        self.name = name
        self.depth = depth
        self.parent = parent
        self.attrs = attrs
        self.t0 = time.monotonic()

    def set(self, **attrs) -> "Span":
        self.attrs.update(attrs)
        return self

    def cost(self, flops=None, bytes=None, dtype=None,
             flops_by_dtype=None, **attrs) -> "Span":
        """Charge analytic cost to this span (accumulating PER DTYPE —
        a span that charges a bf16 scan and then an f32 rerank keeps
        both sums, so mixed-precision MFU weighs each against its own
        peak). A composite `obs.perf` formula passes the authoritative
        per-dtype split as `flops_by_dtype` (one charge, several peaks
        — the integer fused engines' int8+popcount spans); `flops` then
        only cross-checks the total. On close the totals land in the
        span event (`cost_flops` total, `cost_flops_by_dtype`,
        `cost_bytes`, `cost_dtype` = last charged) and in the
        deterministic `perf.<name>.flops.<dtype>` / `perf.<name>.bytes`
        counters the report and Prometheus exporter read."""
        dt = str(dtype) if dtype is not None else "f32"
        if flops_by_dtype:
            by = self.attrs.setdefault("cost_flops_by_dtype", {})
            total = 0
            for sub_dt, fl in flops_by_dtype.items():
                if fl:
                    by[str(sub_dt)] = by.get(str(sub_dt), 0) + int(fl)
                    total += int(fl)
            self.attrs["cost_flops"] = (
                self.attrs.get("cost_flops", 0) + total)
        elif flops:
            by = self.attrs.setdefault("cost_flops_by_dtype", {})
            by[dt] = by.get(dt, 0) + int(flops)
            self.attrs["cost_flops"] = (
                self.attrs.get("cost_flops", 0) + int(flops))
        if bytes:
            self.attrs["cost_bytes"] = (
                self.attrs.get("cost_bytes", 0) + int(bytes))
        if dtype is not None:
            self.attrs["cost_dtype"] = dt
        self.attrs.update(attrs)
        return self

    def fence(self, value):
        """Synchronize the CUDA devices of `value`'s tensors so the span's
        duration covers device execution, not just the launches. Returns
        `value`."""
        return fence(value)


class _NullSpan:
    """Inert stand-in yielded when observability is disabled: same
    surface, zero work (fence still blocks — callers rely on the
    synchronization side effect, not just the timing)."""

    __slots__ = ()
    name = None
    depth = 0
    parent = None

    def set(self, **attrs):
        return self

    def cost(self, flops=None, bytes=None, dtype=None,
             flops_by_dtype=None, **attrs):
        return self

    def fence(self, value):
        return fence(value)


NULL_SPAN = _NullSpan()


def _cuda_devices(value, out: set) -> set:
    if isinstance(value, torch.Tensor):
        if value.is_cuda:
            out.add(value.device)
    elif isinstance(value, (tuple, list)):
        for v in value:
            _cuda_devices(v, out)
    elif isinstance(value, dict):
        for v in value.values():
            _cuda_devices(v, out)
    return out


def fence(value):
    """Wait until the work behind every tensor of `value` (a tensor, or a
    nested tuple, list or dict of them) is done: synchronize each CUDA
    device they lie on (CPU tensors are ready). Returns `value`."""
    for dev in sorted(_cuda_devices(value, set()), key=str):
        torch.cuda.synchronize(dev)
    return value


def _stack():
    st = getattr(_TLS, "stack", None)
    if st is None:
        st = _TLS.stack = []
        with _STACKS_LOCK:
            _ALL_STACKS[threading.get_ident()] = (
                threading.current_thread().name, st)
    return st


def open_spans() -> list:
    """Every currently-open span across all threads (the flight
    recorder's 'what was in progress' section): [{"thread", "name",
    "depth", "attrs"}], outermost first per thread, sorted by thread
    name for deterministic dumps."""
    with _STACKS_LOCK:
        stacks = [(name, list(st)) for name, st in _ALL_STACKS.values() if st]
    out = []
    for tname, spans in sorted(stacks, key=lambda x: x[0]):
        for sp in spans:
            out.append({"thread": tname, "name": sp.name, "depth": sp.depth,
                        "attrs": dict(sp.attrs)})
    return out


@contextlib.contextmanager
def span_impl(name: str, **attrs):
    """The enabled-path implementation behind `raft_tpu_torch.obs.span` (the
    public wrapper owns the enabled check so the disabled path never
    enters a generator frame)."""
    st = _stack()
    sp = Span(str(name), depth=len(st), parent=st[-1].name if st else None,
              attrs=attrs)
    st.append(sp)
    try:
        yield sp
    finally:
        st.pop()
        dur = time.monotonic() - sp.t0
        _reg_mod.GLOBAL.histogram(f"span.{sp.name}").observe(dur)
        # charged analytic cost lands in deterministic counters so the
        # report / Prometheus exporter never depend on the bounded event
        # ring keeping the spans around (one counter per charged dtype)
        for dt, fl in sorted((sp.attrs.get("cost_flops_by_dtype")
                              or {}).items()):
            if fl:
                _reg_mod.GLOBAL.counter(
                    f"perf.{sp.name}.flops.{dt}").inc(int(fl))
        by = sp.attrs.get("cost_bytes")
        if by:
            _reg_mod.GLOBAL.counter(f"perf.{sp.name}.bytes").inc(int(by))
        _bus_mod.GLOBAL.publish(
            "span", name=sp.name, depth=sp.depth, parent=sp.parent,
            dur_s=dur, thread=threading.current_thread().name, **sp.attrs,
        )


def current_span():
    """The innermost open span on this thread, or None."""
    st = getattr(_TLS, "stack", None)
    return st[-1] if st else None


class SpanCapture:
    """Subscribe-and-aggregate helper: collects span events while
    active and reduces them to per-name totals (per-phase attribution).

        with obs.capture_spans() as cap:
            run_workload()
        cap.totals()  # {"neighbors.ivf_flat.search": {"calls": 5,
                      #   "total_ms": 12.3, "max_ms": 3.1}, ...}
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._acc: dict = {}

    def _on_event(self, event: dict) -> None:
        if event.get("kind") != "span":
            return
        name = event["name"]
        dur_ms = float(event["dur_s"]) * 1e3
        with self._lock:
            row = self._acc.setdefault(
                name, {"calls": 0, "total_ms": 0.0, "max_ms": 0.0,
                       "flops": {}, "bytes": 0})
            row["calls"] += 1
            row["total_ms"] += dur_ms
            row["max_ms"] = max(row["max_ms"], dur_ms)
            for dt, fl in (event.get("cost_flops_by_dtype") or {}).items():
                row["flops"][dt] = row["flops"].get(dt, 0) + int(fl)
            row["bytes"] += int(event.get("cost_bytes", 0) or 0)

    def cost_totals(self) -> dict:
        """Charged cost summed across every captured span:
        {"flops", "by_dtype", "bytes"}. The caller owns the wall-clock
        window to divide by: a fenced timed loop gives the honest MFU
        (span windows are host time; see `totals`)."""
        with self._lock:
            by_dtype: dict = {}
            nbytes = 0
            for row in self._acc.values():
                for dt, fl in row["flops"].items():
                    by_dtype[dt] = by_dtype.get(dt, 0) + fl
                nbytes += row["bytes"]
        return {"flops": sum(by_dtype.values()), "by_dtype": by_dtype,
                "bytes": nbytes}

    def totals(self) -> dict:
        """Per-name aggregates. Names whose spans charged an analytic
        cost (obs.perf) additionally carry flops/bytes and the derived
        gflops_per_s / MFU vs the current platform's peak table —
        `mfu_nominal: true` marks a placeholder (CPU) peak.

        Caveat (same as the span timing contract above): a span's
        window is HOST wall time, so for spans that dispatch async
        device work without fencing, the derived rate is per unit of
        launch time, not device time. Spans that fence read true; a
        fenced timed loop gets the authoritative MFU from
        `cost_totals()`."""
        info = None
        with self._lock:
            acc = {name: dict(row, flops=dict(row["flops"]))
                   for name, row in self._acc.items()}
        out = {}
        for name, row in sorted(acc.items()):
            entry = {
                "calls": row["calls"],
                "total_ms": round(row["total_ms"], 3),
                "max_ms": round(row["max_ms"], 3),
            }
            flops = sum(row["flops"].values())
            if flops:
                entry["flops"] = flops
                if row["bytes"]:
                    entry["bytes"] = row["bytes"]
                secs = row["total_ms"] / 1e3
                if secs > 0:
                    entry["gflops_per_s"] = round(flops / secs / 1e9, 3)
                    try:
                        if info is None:
                            from raft_tpu_torch.obs import perf as _perf

                            info = _perf.platform_info()
                        m = _perf.mfu(row["flops"], secs, info)
                    except Exception:  # attribution must never kill a run
                        m = None
                    if m is not None:
                        entry["mfu"] = round(m, 6)
                        if info.get("nominal"):
                            entry["mfu_nominal"] = True
            out[name] = entry
        return out


@contextlib.contextmanager
def capture_spans():
    cap = SpanCapture()
    _bus_mod.GLOBAL.subscribe(cap._on_event)
    try:
        yield cap
    finally:
        _bus_mod.GLOBAL.unsubscribe(cap._on_event)
