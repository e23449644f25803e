"""Event bus: the ordered record of what happened in a run (counterpart
of raft_tpu/obs/bus.py).

Spans, fault injections, mutations, integrity findings and log records
all publish here as small dicts with a global sequence number. Replay the
same seeded `FaultPlan` and the same event sequence comes back
(timestamps differ; everything else is equal).

Publishing is synchronous and lock-serialized: the global `seq` is the
ordering authority. Subscribers run inline under no lock (a slow
subscriber must not block publishers), and a failing subscriber is
skipped for that event only: observability never takes down the path it
observes.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, List, Optional


class EventBus:
    """Bounded, ordered event log with synchronous fan-out.

    Events are plain dicts: {"seq": int, "t": monotonic seconds,
    "kind": str, ...fields}. The ring keeps the last `maxlen` events so
    unbounded runs hold constant memory; exporters snapshot the window.
    """

    def __init__(self, maxlen: int = 8192):
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(maxlen=int(maxlen))
        self._subscribers: List[Callable[[dict], None]] = []
        self._seq = 0

    def publish(self, kind: str, **fields) -> int:
        """Append one event; returns its sequence number."""
        with self._lock:
            self._seq += 1
            event = {"seq": self._seq, "t": time.monotonic(), "kind": str(kind)}
            event.update(fields)
            self._events.append(event)
            subs = tuple(self._subscribers)
        for fn in subs:
            try:
                fn(event)
            except Exception:
                # a broken subscriber must not poison the publisher
                pass
        return event["seq"]

    def subscribe(self, fn: Callable[[dict], None]) -> Callable[[dict], None]:
        with self._lock:
            self._subscribers.append(fn)
        return fn

    def unsubscribe(self, fn: Callable[[dict], None]) -> None:
        with self._lock:
            if fn in self._subscribers:
                self._subscribers.remove(fn)

    def events(self, kind: Optional[str] = None) -> List[dict]:
        """Copy of the ringed window, oldest first; `kind` filters."""
        with self._lock:
            evs = [dict(e) for e in self._events]
        if kind is not None:
            evs = [e for e in evs if e["kind"] == kind]
        return evs

    def clear(self) -> None:
        """Drop ringed events and restart the sequence (test hygiene).
        Subscribers stay attached."""
        with self._lock:
            self._events.clear()
            self._seq = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._events)


# the library-wide bus; accessed via raft_tpu_torch.obs.bus()
GLOBAL = EventBus()
