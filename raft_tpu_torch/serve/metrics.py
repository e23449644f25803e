"""Serving metrics (counterpart of raft_tpu/serve/metrics.py): QPS,
queue depth, batch occupancy, latency percentiles, degraded-coverage —
the observability half of the serving engine. Pure host code; the
exposition keeps the JAX metric names (`raft_tpu_serve_*`).

No reference analogue (RAFT ships kernels, not a server); the design
follows the usual online-serving metric set: monotone counters for
admission outcomes, gauges for instantaneous state, and a fixed-size
ring buffer of per-request latencies from which `snapshot()` derives
p50/p90/p99 (a ring keeps memory constant over unbounded runs and makes
the percentiles reflect RECENT traffic, not the all-time mix). QPS
comes from the same ring's completion timestamps, so it too is a
sliding-window rate.

Built on `raft_tpu_torch.obs`: the scalar counters and gauges are
`obs.registry.Counter`/`Gauge` instruments in a PER-INSTANCE
`obs.Registry` (two servers must never collide on "submitted"),
`render_text()` delegates to the shared Prometheus
formatter in `obs.export`, and — when library observability is enabled
— each instance registers a named collector on the global registry so
`obs.snapshot()` / the run report include serving state without a
second scrape path. The latency/occupancy rings stay here: percentile
windows are this module's job (obs histograms are deterministic
aggregates, not reservoirs).

Thread-safety: instruments carry their own locks; the rings and
derived-window math stay under this class's one lock, observations
remain O(1) appends, and percentile math is deferred to `snapshot()`.
"""

from __future__ import annotations

import itertools
import threading
import time
import weakref
from typing import Optional, Sequence

import numpy as np

from raft_tpu_torch import obs
from raft_tpu_torch.obs.export import render_prometheus
from raft_tpu_torch.obs.registry import Registry

_COUNTERS = ("submitted", "completed", "rejected", "expired", "failed",
             "batches")
_instance_ids = itertools.count(1)


class ServerMetrics:
    """Lock-safe registry for one `SearchServer`.

    Counters (monotone): `submitted`, `completed`, `rejected`,
    `expired`, `failed`, `batches` — readable as int attributes, backed
    by per-instance obs instruments.
    Gauges: `queue_depth` (rows waiting), `coverage_last`/`coverage_min`
    (degraded-mode shard coverage, 1.0 == every shard answered).
    Windows: per-request latency ring (`latency_window` entries) and its
    completion timestamps; per-batch occupancy ring (valid rows /
    dispatched bucket rows — the padding tax the bucket ladder pays for
    one warmed shape per bucket).
    """

    def __init__(self, latency_window: int = 4096,
                 registry: Optional[Registry] = None):
        if latency_window <= 0:
            raise ValueError("latency_window must be positive")
        self._window = int(latency_window)
        self._lock = threading.Lock()
        # optional obs.slo.Watchtower: fed per terminal request under
        # its own lock (the Watchtower is not thread-safe by itself)
        self._watchtower = None
        self._wt_lock = threading.Lock()
        self._reg = registry if registry is not None else Registry()
        for name in _COUNTERS:
            self._reg.counter(name)
        self.reset()
        if obs.enabled():
            # join the global snapshot under a stable per-instance name;
            # weakref so a dropped server doesn't pin its metrics alive,
            # and a finalizer so its section doesn't outlive it either
            ref = weakref.ref(self)
            name = f"serve#{next(_instance_ids)}"

            def _collect(ref=ref):
                inst = ref()
                return inst.snapshot() if inst is not None else {}

            obs.registry().add_collector(name, _collect)
            weakref.finalize(self, obs.registry().remove_collector, name)

    def reset(self) -> None:
        with self._lock:
            self._t0 = time.monotonic()
            # reset only the instruments this class OWNS — a caller may
            # have passed a shared registry, whose other instruments and
            # collectors are not ours to wipe
            for name in _COUNTERS:
                self._reg.counter(name).reset()
            self._rows_valid = 0
            self._rows_dispatched = 0
            self._lat_s = np.zeros(self._window, np.float64)
            self._done_t = np.zeros(self._window, np.float64)
            self._lat_i = 0
            self._lat_n = 0
            self._occ = np.zeros(min(self._window, 1024), np.float64)
            self._occ_i = 0
            self._occ_n = 0
            self._queue_depth = 0
            self._coverage_last = 1.0
            self._coverage_min = 1.0

    # -- counter attribute views (engine/tests read these as ints) ------

    @property
    def submitted(self) -> int:
        return self._reg.counter("submitted").value

    @property
    def completed(self) -> int:
        return self._reg.counter("completed").value

    @property
    def rejected(self) -> int:
        return self._reg.counter("rejected").value

    @property
    def expired(self) -> int:
        return self._reg.counter("expired").value

    @property
    def failed(self) -> int:
        return self._reg.counter("failed").value

    @property
    def batches(self) -> int:
        return self._reg.counter("batches").value

    # -- observations (called by batcher/engine) -----------------------

    def observe_submit(self) -> None:
        self._reg.counter("submitted").inc()

    def attach_watchtower(self, watchtower) -> None:
        """Attach an `obs.slo.Watchtower`: every terminal request
        outcome (ok/degraded/expired/rejected) and batch occupancy
        feeds its objective windows, and `evaluate()` runs after each
        feed so breach/recover transitions publish promptly. Detach
        with None. Zero cost when unattached or obs is disabled."""
        with self._wt_lock:
            self._watchtower = watchtower

    def _feed_watchtower(self, requests=(), occupancy=None) -> None:
        if not obs.enabled():
            return
        with self._wt_lock:
            wt = self._watchtower
            if wt is None:
                return
            for kw in requests:
                wt.observe_request(**kw)
            if occupancy is not None:
                wt.observe_batch(occupancy=occupancy)
            wt.evaluate()

    def observe_reject(self) -> None:
        self._reg.counter("rejected").inc()
        if obs.enabled():
            obs.counter("serve.outcome.rejected").inc()
            self._feed_watchtower(requests=({"outcome": "rejected"},))

    def observe_expired(self, n: int = 1,
                        wait_s: Optional[float] = None) -> None:
        """`wait_s` = queue wait until the drop (fed to the
        `serve.drop_wait_s` histogram) — the latency story of the
        requests admission killed, which the survivor percentiles by
        construction cannot show."""
        self._reg.counter("expired").inc(int(n))
        if obs.enabled():
            obs.counter("serve.outcome.expired").inc(int(n))
            if wait_s is not None:
                obs.histogram("serve.drop_wait_s").observe(float(wait_s))
            self._feed_watchtower(
                requests=({"outcome": "expired"},) * int(n))

    def observe_failed(self, n: int = 1) -> None:
        self._reg.counter("failed").inc(int(n))
        if obs.enabled():
            self._feed_watchtower(
                requests=({"outcome": "failed"},) * int(n))

    def set_queue_depth(self, rows: int) -> None:
        with self._lock:
            self._queue_depth = int(rows)

    def observe_batch(
        self,
        n_requests: int,
        valid_rows: int,
        bucket_rows: int,
        latencies_s: Sequence[float],
        coverage: Optional[float] = None,
    ) -> None:
        """One executed batch: `latencies_s` are the per-request
        submit->deliver wall seconds (one entry per merged request)."""
        now = time.monotonic()
        degraded = coverage is not None and float(coverage) < 1.0
        if obs.enabled():
            # the library-wide bucketed latency histogram: real
            # `_bucket{le=...}` series on the Prometheus surface, so a
            # scrape can chart latency quantiles over time (the
            # percentile *windows* stay in this instance's ring)
            hist = obs.histogram("serve.latency_s")
            for lat in latencies_s:
                hist.observe(float(lat))
            # terminal-outcome counters: with expired/rejected these
            # four account for every request that left the system
            obs.counter("serve.outcome.degraded" if degraded
                        else "serve.outcome.ok").inc(int(n_requests))
        with self._lock:
            # counters move under the ring lock so a concurrent
            # snapshot() never sees batches/completed ahead of the ring
            # entries they belong to (the pre-obs atomicity invariant)
            self._reg.counter("batches").inc()
            self._reg.counter("completed").inc(int(n_requests))
            self._rows_valid += int(valid_rows)
            self._rows_dispatched += int(bucket_rows)
            for lat in latencies_s:
                self._lat_s[self._lat_i] = float(lat)
                self._done_t[self._lat_i] = now
                self._lat_i = (self._lat_i + 1) % self._window
                self._lat_n = min(self._lat_n + 1, self._window)
            if bucket_rows > 0:
                self._occ[self._occ_i] = valid_rows / bucket_rows
                self._occ_i = (self._occ_i + 1) % self._occ.size
                self._occ_n = min(self._occ_n + 1, self._occ.size)
            if coverage is not None:
                self._coverage_last = float(coverage)
                self._coverage_min = min(self._coverage_min, float(coverage))
        if obs.enabled():
            outcome = "degraded" if degraded else "ok"
            self._feed_watchtower(
                requests=tuple({"latency_s": float(lat), "outcome": outcome,
                                "coverage": (float(coverage)
                                             if coverage is not None else None)}
                               for lat in latencies_s),
                occupancy=(valid_rows / bucket_rows if bucket_rows > 0
                           else None))

    # -- derived views --------------------------------------------------

    def snapshot(self) -> dict:
        """Point-in-time dict of every metric; percentiles/QPS derive
        from the ring windows (NaN when no request completed yet, so a
        dashboard can tell "no traffic" from "0 ms")."""
        with self._lock:
            counts = {name: self._reg.counter(name).value for name in _COUNTERS}
            lat = self._lat_s[: self._lat_n].copy()
            done = self._done_t[: self._lat_n].copy()
            occ = self._occ[: self._occ_n].copy()
            snap = {
                "uptime_s": time.monotonic() - self._t0,
                **counts,
                "queue_depth": self._queue_depth,
                "coverage_last": self._coverage_last,
                "coverage_min": self._coverage_min,
            }
        if lat.size:
            q = np.percentile(lat, [50.0, 90.0, 99.0]) * 1e3
            snap["latency_ms_p50"] = float(q[0])
            snap["latency_ms_p90"] = float(q[1])
            snap["latency_ms_p99"] = float(q[2])
            snap["latency_ms_mean"] = float(lat.mean() * 1e3)
            snap["latency_ms_max"] = float(lat.max() * 1e3)
            # sliding-window rate: completions in the ring over the span
            # from the oldest ringed completion to now (not t0 — the ring
            # must forget idle history the same way it forgets latencies)
            span = max(time.monotonic() - float(done.min()), 1e-9)
            snap["qps"] = float(lat.size / span)
        else:
            for key in ("latency_ms_p50", "latency_ms_p90", "latency_ms_p99",
                        "latency_ms_mean", "latency_ms_max", "qps"):
                snap[key] = float("nan")
        snap["batch_occupancy"] = float(occ.mean()) if occ.size else float("nan")
        snap["requests_per_batch"] = (
            snap["completed"] / snap["batches"] if snap["batches"] else float("nan")
        )
        return snap

    def render_text(self) -> str:
        """Prometheus exposition text of `snapshot()` (the shared
        `obs.export` formatter — one formatter for every scrape surface
        in the library)."""
        return render_prometheus(self.snapshot(), prefix="raft_tpu_serve_")
