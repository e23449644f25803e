"""Flight recorder: the last few seconds of timeline, crash-survivable
(counterpart of raft_tpu/obs/flight.py).

When a run dies (a watchdog SIGKILL of a stalled stage, an unhandled
exception in a worker, a `crash_point` drill, SIGTERM from a scheduler)
every in-memory metric dies with it. The recorder keeps a bounded ring
of the most recent bus events plus, at dump time, the open-span stack of
every live thread and the counter delta since arming. `dump()` writes
through `core.serialize.atomic_write`, so a crash mid-dump leaves the
previous dump whole, never a torn one.

Arming points (all call `maybe_dump`, which never raises: the recorder
must never take down the path it observes):

  * `core.faults.crash_point`: dump before the drill kills the process
  * SIGTERM, via `install_sigterm()` (automatic when
    `RAFT_TPU_FLIGHT_DIR` is set and obs is enabled on the main thread)
  * the job watchdog and the serving worker loop, when those layers
    come

`RAFT_TPU_FLIGHT_DIR=<dir>` auto-installs a recorder when obs is
enabled; dumps land there as `flight-<pid>-<n>.json` (a counter, not
wall-clock, so reruns overwrite rather than accumulate).
"""

from __future__ import annotations

import collections
import json
import os
import threading
from typing import List, Optional

from raft_tpu_torch.core import faults
from raft_tpu_torch.obs import bus as _bus_mod
from raft_tpu_torch.obs import registry as _reg_mod

#: fault-injection site guarding every dump (chaos drills make it flaky
#: to prove a failing dump never takes down the caller)
DUMP_SITE = "obs.flight.dump"

ENV_DIR = "RAFT_TPU_FLIGHT_DIR"

DEFAULT_RING = 512


class FlightRecorder:
    """Bounded ring of recent bus events + dump machinery. `install()`
    subscribes it to the global bus and snapshots the counter baseline
    the dump's `registry_delta` is computed against."""

    def __init__(self, maxlen: int = DEFAULT_RING):
        # the ring needs a real lock, not just the GIL: deque.append is
        # atomic, but `list(ring)` iterates, and an append landing from
        # another publisher mid-iteration raises "deque mutated during
        # iteration", which would lose the dump when the process is
        # busiest
        self._ring_lock = threading.Lock()
        self._ring: collections.deque = collections.deque(maxlen=int(maxlen))
        self._baseline: dict = {}
        self._installed = False

    # -- recording --------------------------------------------------------

    def _on_event(self, event: dict) -> None:
        with self._ring_lock:
            self._ring.append(event)

    def install(self) -> "FlightRecorder":
        if not self._installed:
            self._baseline = dict(
                _reg_mod.GLOBAL.snapshot().get("counters", {}))
            _bus_mod.GLOBAL.subscribe(self._on_event)
            self._installed = True
        return self

    def uninstall(self) -> None:
        if self._installed:
            _bus_mod.GLOBAL.unsubscribe(self._on_event)
            self._installed = False

    def clear(self) -> None:
        with self._ring_lock:
            self._ring.clear()
        self._baseline = dict(_reg_mod.GLOBAL.snapshot().get("counters", {}))

    def events(self) -> List[dict]:
        """Ring contents, oldest first."""
        with self._ring_lock:
            return list(self._ring)

    # -- dumping ----------------------------------------------------------

    def snapshot(self, reason: str, **fields) -> dict:
        snap = _reg_mod.GLOBAL.snapshot()
        counters = snap.get("counters", {})
        delta = {name: v - self._baseline.get(name, 0)
                 for name, v in sorted(counters.items())
                 if v != self._baseline.get(name, 0)}
        from raft_tpu_torch.obs.spans import open_spans

        return {
            "reason": str(reason),
            **fields,
            "pid": os.getpid(),
            "ring_maxlen": self._ring.maxlen,
            "events": self.events(),
            "open_spans": open_spans(),
            "registry_delta": delta,
            "registry": snap,
        }

    def dump(self, path: str, reason: str, **fields) -> dict:
        """Write the snapshot atomically; returns it. Passes through
        the DUMP_SITE fault hook first, so a drill-injected failure
        surfaces here (callers go through `maybe_dump`, which absorbs
        it)."""
        faults.fault_point(DUMP_SITE)
        snap = self.snapshot(reason, **fields)
        from raft_tpu_torch.core.serialize import atomic_write

        with atomic_write(path) as tmp:
            with open(tmp, "w") as f:
                json.dump(snap, f, indent=1, sort_keys=True, default=repr)
        _bus_mod.GLOBAL.publish("flight", action="dump", reason=str(reason),
                                path=os.path.basename(path),
                                events=len(snap["events"]))
        return snap


# ---------------------------------------------------------------------------
# module-level singleton + arming helpers

_LOCK = threading.Lock()
_RECORDER: Optional[FlightRecorder] = None
_DUMP_DIR: Optional[str] = None
_DUMP_N = 0
_PREV_SIGTERM = None


def install(maxlen: int = DEFAULT_RING,
            dump_dir: Optional[str] = None) -> FlightRecorder:
    """Arm the global recorder (idempotent; re-installing just updates
    the dump dir)."""
    global _RECORDER, _DUMP_DIR
    with _LOCK:
        if _RECORDER is None:
            _RECORDER = FlightRecorder(maxlen=maxlen)
        if dump_dir is not None:
            _DUMP_DIR = str(dump_dir)
    return _RECORDER.install()


def installed() -> Optional[FlightRecorder]:
    return _RECORDER if (_RECORDER is not None and _RECORDER._installed) \
        else None


def uninstall() -> None:
    global _RECORDER
    with _LOCK:
        rec, _RECORDER = _RECORDER, None
    if rec is not None:
        rec.uninstall()


def reset() -> None:
    """Clear the armed recorder's ring and rebaseline (test hygiene;
    wired into `obs.reset()`). No-op when nothing is armed."""
    rec = installed()
    if rec is not None:
        rec.clear()


def _next_path() -> str:
    global _DUMP_N
    with _LOCK:
        _DUMP_N += 1
        n = _DUMP_N
    d = _DUMP_DIR or os.environ.get(ENV_DIR) or "."
    return os.path.join(d, f"flight-{os.getpid()}-{n}.json")


def maybe_dump(reason: str, path: Optional[str] = None,
               **fields) -> Optional[str]:
    """Dump if a recorder is armed and obs is enabled; swallow every
    failure (a flaky dump must never take down the worker loop, the
    watchdog, or the crash path that called it). Returns the path
    written, or None."""
    from raft_tpu_torch import obs

    rec = installed()
    if rec is None or not obs.enabled():
        return None
    if path is None:
        path = _next_path()
    try:
        rec.dump(path, reason=reason, **fields)
        return path
    except Exception:
        try:
            _bus_mod.GLOBAL.publish("flight", action="dump_failed",
                                    reason=str(reason))
        except Exception:
            pass
        return None


def install_sigterm() -> bool:
    """Dump on SIGTERM, then chain to the previous handler (or re-raise
    the default). Only possible on the main thread; returns False
    elsewhere."""
    global _PREV_SIGTERM
    import signal

    def _on_sigterm(signum, frame):
        maybe_dump("sigterm")
        prev = _PREV_SIGTERM
        if callable(prev):
            prev(signum, frame)
        else:
            signal.signal(signal.SIGTERM, signal.SIG_DFL)
            os.kill(os.getpid(), signal.SIGTERM)

    try:
        _PREV_SIGTERM = signal.signal(signal.SIGTERM, _on_sigterm)
        return True
    except ValueError:  # not the main thread
        return False


def maybe_env_install() -> None:
    """Auto-arm from `RAFT_TPU_FLIGHT_DIR` (called by `obs.enable()`)."""
    d = os.environ.get(ENV_DIR, "").strip()
    if d and installed() is None:
        install(dump_dir=d)
        install_sigterm()
