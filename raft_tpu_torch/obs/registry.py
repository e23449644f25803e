"""Metric registry: thread-safe counters, gauges, histograms
(counterpart of raft_tpu/obs/registry.py).

The one place the port accounts time, bytes and counts: instruments are
named with dotted paths ("ivf.scanned_lists", "mutation.upserts"),
get-or-create is idempotent, and `snapshot()` returns a
deterministically ordered dict, so tests can assert on exact values and
the two packages' snapshots of one call sequence compare equal.

Design notes:
  - Every instrument carries its own lock; observation is O(1) and
    allocation-free, and nothing here touches a device.
  - Histograms keep running aggregates (count/total/min/max/last) and
    fixed `le` bucket counts, not reservoirs: deterministic under
    identical observation sequences.
  - `add_collector` lets component-local metric objects contribute a
    named section to the global snapshot without moving their state
    here.
"""

from __future__ import annotations

import bisect
import collections
import threading
from typing import Callable, Dict, List, Optional, Tuple


class Counter:
    """Monotone counter. `inc(n)` with n >= 0; `.value` reads atomically."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0

    def inc(self, n: int = 1) -> None:
        if n < 0:
            raise ValueError(f"counter {self.name!r} cannot decrease (n={n})")
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0


class Gauge:
    """Point-in-time value; `set`/`add` under the instrument lock."""

    __slots__ = ("name", "_lock", "_value")

    def __init__(self, name: str):
        self.name = name
        self._lock = threading.Lock()
        self._value = 0.0

    def set(self, v: float) -> None:
        with self._lock:
            self._value = float(v)

    def add(self, v: float) -> None:
        with self._lock:
            self._value += float(v)

    @property
    def value(self) -> float:
        with self._lock:
            return self._value

    def reset(self) -> None:
        with self._lock:
            self._value = 0.0


#: default `le` bounds (seconds-scaled — spans and latencies are the
#: dominant observers). Cumulative counts against these bounds are what
#: the Prometheus exporter renders as real `_bucket{le=...}` series.
DEFAULT_BUCKETS: Tuple[float, ...] = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0,
)


class Histogram:
    """Running aggregate of observations (count/total/min/max/last) plus
    fixed `le` bucket counts.

    The aggregate side stays deliberately reservoir-free: deterministic
    under identical observation sequences, O(1), and what the snapshot
    test contract pins. The bucket side (also deterministic — fixed
    bounds, integer counts) exists for Prometheus exposition: real
    cumulative `_bucket{le=...}`/`_sum`/`_count` series instead of
    aggregate-only gauges, so a scrape can compute quantiles over time.
    Latency *percentile windows* live with the serving layer's rings.
    """

    __slots__ = ("name", "_lock", "count", "total", "min", "max", "last",
                 "buckets", "_bucket_counts")

    def __init__(self, name: str, buckets: Tuple[float, ...] = DEFAULT_BUCKETS):
        self.name = name
        self._lock = threading.Lock()
        self.buckets = tuple(sorted(float(b) for b in buckets))
        self.reset()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self.last = v
            i = bisect.bisect_left(self.buckets, v)
            if i < len(self._bucket_counts):
                self._bucket_counts[i] += 1

    def observe_n(self, v: float, n: int) -> None:
        """`n` identical observations in one locked update — the bulk
        form batch instrumentation uses (the adaptive-probing budget
        histogram lands one value per QUERY; per-row observe() calls
        would put O(batch) lock round-trips on the serving hot path).
        Deterministic: equivalent to n consecutive observe(v) calls."""
        v = float(v)
        n = int(n)
        if n <= 0:
            return
        with self._lock:
            self.count += n
            self.total += v * n
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self.last = v
            i = bisect.bisect_left(self.buckets, v)
            if i < len(self._bucket_counts):
                self._bucket_counts[i] += n

    def aggregate(self) -> dict:
        return self.export_state()[0]

    def bucket_counts(self) -> List[Tuple[str, int]]:
        """Cumulative (le, count) pairs, Prometheus semantics: each entry
        counts observations <= its bound; the final "+Inf" entry equals
        `count`. Labels are formatted once here so every exposition
        surface renders identical `le` strings."""
        return self.export_state()[1]

    def export_state(self) -> Tuple[dict, List[Tuple[str, int]]]:
        """(aggregate, cumulative buckets) from ONE locked read — the
        exposition renderer uses this so a scrape's `_count`/`_sum` can
        never disagree with its `_bucket{+Inf}` (an observe landing
        between two separate reads would split the family)."""
        with self._lock:
            agg = {
                "count": self.count,
                "total": self.total,
                "min": self.min,
                "max": self.max,
                "mean": (self.total / self.count) if self.count else None,
                "last": self.last,
            }
            per = list(self._bucket_counts)
            total = self.count
        out: List[Tuple[str, int]] = []
        cum = 0
        for bound, n in zip(self.buckets, per):
            cum += n
            out.append((format(bound, "g"), cum))
        out.append(("+Inf", total))
        return agg, out

    def reset(self) -> None:
        with self._lock:
            self.count = 0
            self.total = 0.0
            self.min = None
            self.max = None
            self.last = None
            self._bucket_counts = [0] * len(self.buckets)


class Registry:
    """Get-or-create instrument store with deterministic snapshots.

    One global instance backs the library (`raft_tpu_torch.obs.registry()`);
    component-local registries use private instances so two components
    never collide on a name.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._collectors: Dict[str, Callable[[], dict]] = {}
        # names whose removal waits for the lock (see remove_collector)
        self._removed: collections.deque = collections.deque()

    def _get(self, table: dict, name: str, cls):
        with self._lock:
            inst = table.get(name)
            if inst is None:
                for other in (self._counters, self._gauges, self._histograms):
                    if other is not table and name in other:
                        raise ValueError(
                            f"metric name {name!r} already registered as a "
                            f"different instrument kind"
                        )
                inst = table[name] = cls(name)
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(self._counters, name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(self._gauges, name, Gauge)

    def histogram(self, name: str) -> Histogram:
        return self._get(self._histograms, name, Histogram)

    def histogram_items(self) -> List[Tuple[str, Histogram]]:
        """Sorted (name, Histogram) pairs — the exporter's path to the
        live bucket counts, which `snapshot()` (pure aggregates, the
        pinned test shape) deliberately does not carry."""
        with self._lock:
            return sorted(self._histograms.items())

    def add_collector(self, name: str, fn: Callable[[], dict]) -> None:
        """Register a callable contributing a named dict section to
        `snapshot()["collectors"]` (e.g. one per live server)."""
        with self._lock:
            self._drain_removed()
            self._collectors[str(name)] = fn

    def remove_collector(self, name: str) -> None:
        """Drop a collector. A finalizer calls this (a dropped server's
        section), and a garbage collection runs finalizers in whatever
        thread allocates, possibly one that holds this registry's lock:
        so the name is queued without the lock, and removed here if the
        lock is free, else by the next locked access (`add_collector`,
        `snapshot`), which drains the queue first."""
        self._removed.append(str(name))
        if self._lock.acquire(blocking=False):
            try:
                self._drain_removed()
            finally:
                self._lock.release()

    def _drain_removed(self) -> None:
        """Apply the queued removals (the caller holds the lock)."""
        while self._removed:
            self._collectors.pop(self._removed.popleft(), None)

    def snapshot(self) -> dict:
        """Deterministically ordered view: sorted names, plain scalars.
        Collector failures surface as an "error" entry, never an
        exception — a broken component must not take down the scrape."""
        with self._lock:
            self._drain_removed()
            counters = sorted(self._counters.items())
            gauges = sorted(self._gauges.items())
            hists = sorted(self._histograms.items())
            collectors = sorted(self._collectors.items())
        snap = {
            "counters": {n: c.value for n, c in counters},
            "gauges": {n: g.value for n, g in gauges},
            "histograms": {n: h.aggregate() for n, h in hists},
        }
        if collectors:
            out = {}
            for n, fn in collectors:
                try:
                    out[n] = fn()
                except Exception as e:  # pragma: no cover - defensive
                    out[n] = {"error": repr(e)}
            snap["collectors"] = out
        return snap

    def reset(self) -> None:
        """Zero every instrument and drop collectors (test hygiene)."""
        with self._lock:
            for table in (self._counters, self._gauges, self._histograms):
                for inst in table.values():
                    inst.reset()
            self._collectors.clear()

    def clear(self) -> None:
        """Drop every instrument definition (not just their values)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()
            self._collectors.clear()


# the library-wide registry; accessed via raft_tpu_torch.obs.registry()
GLOBAL = Registry()
