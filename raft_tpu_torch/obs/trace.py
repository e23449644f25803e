"""Request-scope tracing (counterpart of raft_tpu/obs/trace.py).

Spans answer "where did this batch's wall-clock go"; a `TraceCtx`
answers "where did this request's 40 ms go". Minted when a request is
submitted, it rides the request through the serving path and stamps a
monotonic mark at each stage boundary:

    admitted    request validated and queued
    coalesced   popped off the queue into a micro-batch
    dispatched  batch chosen a bucket, entering the device call
    fenced      the device work of the batch is complete
    scattered   this request's reply sliced out and delivered

Consecutive-mark deltas aggregate into per-stage histograms
(`serve.stage.queue_wait_s`, `.linger_s`, `.device_s`, `.scatter_s`);
the deltas telescope, so their sum is the end-to-end latency. Each
completed request lands one "trace" event on the bus with its stage
attrs. The serving engine that stamps requests is a later layer of the
port; the ids, the context and the byte-stable export are here.

Determinism: trace ids are 64-bit values from a seeded counter run
through a splitmix64 finalizer (no wall-clock, no randomness), so a
replayed drill mints the identical id sequence. `obs.reset()` resets the
mint.

Chaos: every stamp passes through `faults.fault_point(STAMP_SITE)`; an
injected failure marks the ctx dead and the request degrades to
untraced. Tracing only observes a request, never steers it.

`to_chrome_trace()` renders trace and span events as Chrome/Perfetto
trace-event JSON: one track per worker thread with stage segments, one
per bucket with whole requests, one per span thread. The render is a
pure function of the event list with sorted keys and fixed separators,
so two renders of the same bus are byte-identical.
"""

from __future__ import annotations

import json
import threading
import time
from typing import List, Optional

from raft_tpu_torch.core import faults
from raft_tpu_torch.obs import bus as _bus_mod
from raft_tpu_torch.obs import registry as _reg_mod

#: fault-injection site guarding every stage stamp (chaos drills corrupt
#: it to prove a broken tracer degrades to untraced, bit-identical serving)
STAMP_SITE = "serve.trace.stamp"

#: stage marks in pipeline order; deltas between consecutive present
#: marks telescope to the end-to-end latency
STAGES = ("admitted", "coalesced", "dispatched", "fenced", "scattered")

#: histogram fed by each consecutive-stage delta
STAGE_HISTOGRAMS = {
    ("admitted", "coalesced"): "serve.stage.queue_wait_s",
    ("coalesced", "dispatched"): "serve.stage.linger_s",
    ("dispatched", "fenced"): "serve.stage.device_s",
    ("fenced", "scattered"): "serve.stage.scatter_s",
}

_MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    """Finalizer from splitmix64: bijective on 64-bit ints, so distinct
    (seed, n) pairs give distinct, well-scattered ids."""
    x = (x + 0x9E3779B97F4A7C15) & _MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _MASK64
    return x ^ (x >> 31)


def trace_id(seed: int, n: int) -> int:
    """The n-th (1-based) id minted under `seed` — a pure function, so
    tests can pin the exact ids a replayed run must produce."""
    return _splitmix64(((int(seed) & _MASK64) << 20) ^ int(n))


class _Mint:
    """Seeded, lock-serialized id source. No wall-clock, no randomness:
    the i-th id after a reset is always `trace_id(seed, i)`."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self._seed = int(seed)
        self._n = 0

    def mint(self) -> int:
        with self._lock:
            self._n += 1
            return trace_id(self._seed, self._n)

    def reset(self, seed: Optional[int] = None) -> None:
        with self._lock:
            if seed is not None:
                self._seed = int(seed)
            self._n = 0


_MINT = _Mint()


def reset(seed: Optional[int] = None) -> None:
    """Restart the id mint (wired into `obs.reset()` so a replayed
    drill re-mints the identical id sequence)."""
    _MINT.reset(seed)


class TraceCtx:
    """Per-request trace state riding the `_Request`. Mutated only from
    the single thread currently owning the request (submitter until
    queued, then the worker that popped it), so no lock is needed."""

    __slots__ = ("trace_id", "marks", "attrs", "dead")

    def __init__(self, tid: int):
        self.trace_id = int(tid)
        self.marks: List[tuple] = []  # [(stage, monotonic_t)] in stamp order
        self.attrs: dict = {}
        self.dead = False

    def stamp(self, stage: str, **attrs) -> None:
        """Record one stage mark. An injected fault at STAMP_SITE kills
        the ctx (marks discarded, later stamps no-ops): the request
        degrades to untraced but is otherwise untouched. Dead-check
        BEFORE the fault hook so a dead ctx stops consuming injection
        arms — drills stay deterministic per request, not per stamp."""
        if self.dead:
            return
        try:
            faults.fault_point(STAMP_SITE)
        except faults.FaultInjected:
            self.dead = True
            self.marks = []
            self.attrs = {}
            return
        self.marks.append((str(stage), time.monotonic()))
        if attrs:
            self.attrs.update(attrs)


def begin() -> Optional[TraceCtx]:
    """Mint a ctx for one request; None when obs is disabled (the
    untraced fast path costs this one call and a branch)."""
    from raft_tpu_torch import obs

    if not obs.enabled():
        return None
    return TraceCtx(_MINT.mint())


def complete(ctx: Optional[TraceCtx], outcome: str = "ok", **attrs) -> None:
    """Close a request's trace: observe every consecutive-stage delta
    into its histogram and publish one "trace" bus event. Timestamps
    live under the event's "marks" field so replay-identity tests can
    strip them the way they strip "t"/"dur_s"."""
    if ctx is None or ctx.dead:
        return
    if attrs:
        ctx.attrs.update(attrs)
    times = dict(ctx.marks)
    for pair, hist in STAGE_HISTOGRAMS.items():
        a, b = pair
        if a in times and b in times:
            _reg_mod.GLOBAL.histogram(hist).observe(times[b] - times[a])
    _bus_mod.GLOBAL.publish(
        "trace",
        trace_id=ctx.trace_id,
        outcome=str(outcome),
        stages=[s for s, _ in ctx.marks],
        marks={s: t for s, t in ctx.marks},
        worker=threading.current_thread().name,
        **ctx.attrs,
    )


# ---------------------------------------------------------------------------
# Chrome/Perfetto trace-event export


def _us(t: float, t0: float) -> float:
    """Microseconds relative to the window start, rounded so the float
    repr (hence the JSON bytes) is stable."""
    return round((t - t0) * 1e6, 3)


def to_chrome_trace(events: Optional[List[dict]] = None) -> str:
    """Render bus "trace" + "span" events as Chrome trace-event JSON.

    Tracks: pid 1 = serve worker threads (one tid per worker; each
    request's stage segments as complete "X" events), pid 2 = bucket
    ladder (one tid per bucket; one "X" event spanning the whole
    request), pid 3 = spans (one tid per thread nesting by depth).
    Pure function of `events` (defaults to the global bus window) —
    rendering the same window twice yields byte-identical output.
    """
    if events is None:
        events = _bus_mod.GLOBAL.events()
    traces = [e for e in events if e.get("kind") == "trace" and e.get("marks")]
    spans = [e for e in events
             if e.get("kind") == "span" and "dur_s" in e and "t" in e]

    t0 = None
    for e in traces:
        lo = min(e["marks"].values())
        t0 = lo if t0 is None else min(t0, lo)
    for e in spans:
        lo = float(e["t"]) - float(e["dur_s"])
        t0 = lo if t0 is None else min(t0, lo)
    if t0 is None:
        t0 = 0.0

    PID_WORKERS, PID_BUCKETS, PID_SPANS = 1, 2, 3
    workers = sorted({str(e.get("worker", "?")) for e in traces})
    worker_tid = {w: i + 1 for i, w in enumerate(workers)}
    buckets = sorted({int(e.get("bucket", 0)) for e in traces})
    bucket_tid = {b: i + 1 for i, b in enumerate(buckets)}
    span_threads = sorted({str(e.get("thread", e.get("worker", "?")))
                           for e in spans})
    span_tid = {n: i + 1 for i, n in enumerate(span_threads)}

    out: List[dict] = []

    def meta(pid, tid, what, name):
        out.append({"ph": "M", "pid": pid, "tid": tid, "name": what,
                    "args": {"name": name}})

    if traces:
        meta(PID_WORKERS, 0, "process_name", "serve workers")
        for w in workers:
            meta(PID_WORKERS, worker_tid[w], "thread_name", w)
        meta(PID_BUCKETS, 0, "process_name", "bucket ladder")
        for b in buckets:
            meta(PID_BUCKETS, bucket_tid[b], "thread_name", f"bucket={b}")
    if spans:
        meta(PID_SPANS, 0, "process_name", "spans")
        for n in span_threads:
            meta(PID_SPANS, span_tid[n], "thread_name", n)

    for e in traces:
        marks = e["marks"]
        tid = worker_tid[str(e.get("worker", "?"))]
        base_args = {k: v for k, v in sorted(e.items())
                     if k not in ("kind", "seq", "t", "marks", "stages",
                                  "worker")}
        base_args["trace_id"] = f"{int(e['trace_id']):016x}"
        present = [s for s in STAGES if s in marks]
        for a, b in zip(present, present[1:]):
            hist = STAGE_HISTOGRAMS.get((a, b))
            name = hist.rsplit(".", 1)[-1][:-2] if hist else f"{a}->{b}"
            out.append({
                "ph": "X", "pid": PID_WORKERS, "tid": tid, "name": name,
                "ts": _us(marks[a], t0),
                "dur": max(0.0, _us(marks[b], t0) - _us(marks[a], t0)),
                "cat": "serve.stage", "args": base_args,
            })
        if len(present) >= 2:
            out.append({
                "ph": "X", "pid": PID_BUCKETS,
                "tid": bucket_tid[int(e.get("bucket", 0))],
                "name": f"request {base_args['trace_id']}",
                "ts": _us(marks[present[0]], t0),
                "dur": max(0.0, _us(marks[present[-1]], t0)
                           - _us(marks[present[0]], t0)),
                "cat": "serve.request", "args": base_args,
            })

    for e in spans:
        tid = span_tid[str(e.get("thread", e.get("worker", "?")))]
        args = {k: v for k, v in sorted(e.items())
                if k not in ("kind", "seq", "t", "dur_s", "name", "thread")}
        out.append({
            "ph": "X", "pid": PID_SPANS, "tid": tid,
            "name": str(e.get("name", "span")),
            "ts": _us(float(e["t"]) - float(e["dur_s"]), t0),
            "dur": round(float(e["dur_s"]) * 1e6, 3),
            "cat": "span", "args": args,
        })

    payload = {"displayTimeUnit": "ms", "traceEvents": out}
    return json.dumps(payload, sort_keys=True, separators=(",", ":"),
                      default=repr)
