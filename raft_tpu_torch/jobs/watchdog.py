"""Watchdog supervision for long-running job stages (counterpart of
raft_tpu/jobs/watchdog.py).

Long runs make stalls a normal failure mode: a transport dies under a
device wait, a child bench hangs in a cold kernel build, a loader
blocks on cold storage. The watchdog turns "hung forever" into a typed
`StageTimeout` the runner can retry: a stage keeps a `Heartbeat`
beating; a background monitor kills the stage when the heartbeat goes
stale past `stall_timeout_s` or the wall clock passes `deadline_s`.

Two kill models:

- **in-process stages** (`Watchdog.run(fn)`): the stage runs on a
  worker thread. Python cannot kill a thread, so the kill is
  cooperative on two fronts: `interruptible.cancel` breaks any device
  wait the stage is blocked in, and the next `Heartbeat.beat()` raises
  `StageCancelled`. A stage that neither beats nor syncs can outlive
  its supervisor (the abandoned daemon thread is documented behavior —
  same cooperative semantics as `core.interruptible`).
- **child processes** (`run_supervised(cmd)`): a real `SIGKILL`. Output
  lines are echoed through and double as heartbeats, so "produces no
  output for stall_timeout_s" is the hang definition — exactly the
  failure shape of a bench child whose transport died.

Chaos: `Heartbeat.beat` visits the registered site
``job.heartbeat.stall`` through `faults.stall_point` — an injected
slow_rank fault STALLS the first `count` beats (no beat is written),
which is how the drills prove a stall is killed, retried, and visible
in `obs.report`.
"""

from __future__ import annotations

import os
import subprocess
import sys
import threading
import time
from typing import Callable, List, Optional

from raft_tpu_torch import obs
from raft_tpu_torch.core import faults
from raft_tpu_torch.core.interruptible import cancel as _cancel_thread
from raft_tpu_torch.obs import flight as _flight

HEARTBEAT_SITE = "job.heartbeat.stall"


class StageTimeout(RuntimeError):
    """A supervised stage was killed by the watchdog: heartbeat stale
    past `stall_timeout_s`, or wall clock past `deadline_s`. Typed so
    the runner's retry policy can distinguish a stall-kill (retryable)
    from a genuine stage error (not)."""


class StageCancelled(RuntimeError):
    """Raised inside the stage (by `Heartbeat.beat`) after the watchdog
    killed it — unwinds the worker promptly once the stall clears."""


class Heartbeat:
    """Liveness signal a supervised stage must keep beating.

    `beat()` records a monotonic timestamp and touches the heartbeat
    FILE (when a path is given) so an external supervisor — or a human
    with `stat` — sees the same signal. The file write is best-effort;
    the in-memory timestamp is the watchdog's source of truth."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._lock = threading.Lock()
        self._last = time.monotonic()
        self._cancelled = threading.Event()
        self._owner: Optional[int] = None

    def adopt(self) -> None:
        """Bind the heartbeat to the CALLING thread — the current
        attempt's worker. From then on a beat from any OTHER thread
        raises `StageCancelled`: a killed-but-unjoinable previous
        attempt (blocked in plain IO, where the cooperative cancel
        can't reach) must never be revived by the next attempt's
        re-arm, or two attempts would run the stage concurrently
        against the same scratch state."""
        with self._lock:
            self._owner = threading.get_ident()
            self._last = time.monotonic()
        self._cancelled.clear()

    def beat(self) -> None:
        with self._lock:
            owner = self._owner
        if owner is not None and threading.get_ident() != owner:
            raise StageCancelled(
                "beat from a superseded attempt's thread — a newer "
                "attempt owns this stage")
        if faults.stall_point(HEARTBEAT_SITE, cancelled=self.cancelled):
            # the injected stall consumed the beat: it never lands, and
            # if the watchdog killed us meanwhile, unwind right here
            if self.cancelled():
                raise StageCancelled("stage killed by watchdog mid-stall")
            return
        if self.cancelled():
            raise StageCancelled("stage killed by watchdog")
        with self._lock:
            self._last = time.monotonic()
        if self.path is not None:
            try:
                with open(self.path, "a"):
                    os.utime(self.path)
            except OSError:
                pass  # a full/readonly disk must not kill a live stage

    def beat_raw(self) -> None:
        """Beat without chaos hooks, cancellation, or file IO — for
        supervisor-internal liveness pumps (child-output readers)."""
        with self._lock:
            self._last = time.monotonic()

    def age_s(self) -> float:
        with self._lock:
            return time.monotonic() - self._last

    def rearm(self) -> None:
        """Re-stamp liveness WITHOUT clearing cancellation — the
        supervisor calls this before starting a new attempt's worker so
        the monitor doesn't insta-kill on a stale age; only the new
        worker's own `adopt()` clears the cancel flag (a zombie stays
        cancelled throughout)."""
        with self._lock:
            self._last = time.monotonic()

    def reset(self) -> None:
        with self._lock:
            self._last = time.monotonic()
            self._owner = None
        self._cancelled.clear()

    def cancelled(self) -> bool:
        return self._cancelled.is_set()

    def _kill(self) -> None:
        self._cancelled.set()


class Watchdog:
    """Supervise an in-process stage callable (see module docstring).

    `stall_timeout_s` bounds heartbeat age, `deadline_s` the whole
    attempt; either alone is fine, neither means `run` degrades to a
    plain call. On kill: a kind="fault" event (action="watchdog_kill")
    lands on the obs bus — stall-kills belong in the same fault/health
    timeline `obs.report` renders for chaos drills."""

    def __init__(self, heartbeat: Optional[Heartbeat] = None,
                 stall_timeout_s: Optional[float] = None,
                 deadline_s: Optional[float] = None,
                 poll_s: float = 0.02):
        self.heartbeat = heartbeat if heartbeat is not None else Heartbeat()
        self.stall_timeout_s = stall_timeout_s
        self.deadline_s = deadline_s
        self.poll_s = float(poll_s)

    def _verdict(self, t0: float) -> Optional[str]:
        if (self.stall_timeout_s is not None
                and self.heartbeat.age_s() > self.stall_timeout_s):
            return (f"heartbeat stale {self.heartbeat.age_s():.2f}s "
                    f"(> stall_timeout_s={self.stall_timeout_s})")
        if (self.deadline_s is not None
                and time.monotonic() - t0 > self.deadline_s):
            return f"wall clock past deadline_s={self.deadline_s}"
        return None

    def run(self, fn: Callable[[], object], describe: str = "stage"):
        """Run `fn()` under supervision; returns its result, re-raises
        its exception, or raises `StageTimeout` after a kill."""
        if self.stall_timeout_s is None and self.deadline_s is None:
            return fn()
        self.heartbeat.rearm()
        result: list = []
        error: list = []
        tid: list = []

        def worker():
            tid.append(threading.get_ident())
            # take ownership FIRST: beats from a previous attempt's
            # zombie thread raise from here on (see Heartbeat.adopt)
            self.heartbeat.adopt()
            try:
                result.append(fn())
            except BaseException as e:  # noqa: BLE001 — relayed below
                error.append(e)

        th = threading.Thread(target=worker, daemon=True,
                              name=f"jobs-stage-{describe}")
        t0 = time.monotonic()
        th.start()
        while True:
            th.join(self.poll_s)
            if not th.is_alive():
                break
            why = self._verdict(t0)
            if why is None:
                continue
            self.heartbeat._kill()
            if tid:
                _cancel_thread(tid[0])  # break any device wait
            obs.event("fault", action="watchdog_kill", stage=describe,
                      reason=why,
                      elapsed_s=round(time.monotonic() - t0, 3))
            # flight-record the kill's preceding timeline BEFORE the
            # stage is abandoned — the dump is the stall's post-mortem
            _flight.maybe_dump("watchdog_kill", stage=describe, why=why)
            th.join(max(1.0, 10 * self.poll_s))
            raise StageTimeout(f"watchdog killed {describe!r}: {why}")
        if error:
            if isinstance(error[0], StageCancelled):
                # the worker noticed the kill after we already raised on
                # a previous attempt's supervisor — surface as timeout
                raise StageTimeout(
                    f"{describe!r} unwound after watchdog kill"
                ) from error[0]
            raise error[0]
        return result[0] if result else None


def run_supervised(
    cmd: List[str],
    describe: Optional[str] = None,
    stall_timeout_s: Optional[float] = None,
    deadline_s: Optional[float] = None,
    echo: bool = True,
    env: Optional[dict] = None,
    cwd: Optional[str] = None,
) -> int:
    """Run a child process under watchdog supervision; returns its exit
    code, or raises `StageTimeout` after killing a hung child.

    Each line the child writes (stdout+stderr merged) is echoed through
    to our stdout AND beats the heartbeat — a bench that streams JSON
    rows stays alive indefinitely; one that goes silent for
    `stall_timeout_s` is declared hung and SIGKILLed. This is the
    supervision `bench/run_all.py` wraps every suite in, so one hung
    bench no longer takes the whole session down."""
    if describe is None:
        # name the child by its script, not cmd[-1]: with CLI args the
        # last element is a flag, and a kill would surface as
        # StageTimeout("... child '--apply' ...")
        describe = next(
            (os.path.basename(c) for c in cmd
             if c.endswith((".py", ".sh")) and not c.startswith("-")),
            os.path.basename(cmd[0]) if cmd else "child")
    hb = Heartbeat()
    # the child leads its own process group so a kill reaches its WHOLE
    # tree: a hung bench whose grandchild holds the single-client chip
    # lease must not leave that grandchild alive to wedge every later
    # suite in the sweep
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        env=env, cwd=cwd, start_new_session=True)

    def pump():
        assert proc.stdout is not None
        for raw in proc.stdout:
            hb.beat_raw()
            if echo:
                sys.stdout.buffer.write(raw)
                sys.stdout.buffer.flush()
        proc.stdout.close()

    reader = threading.Thread(target=pump, daemon=True,
                              name=f"jobs-pump-{describe}")
    t0 = time.monotonic()
    reader.start()
    dog = Watchdog(hb, stall_timeout_s=stall_timeout_s,
                   deadline_s=deadline_s)
    try:
        while True:
            try:
                rc = proc.wait(timeout=dog.poll_s)
                reader.join(5.0)
                return rc
            except subprocess.TimeoutExpired:
                pass
            why = dog._verdict(t0)
            if why is None:
                continue
            # event first, then the flight dump (so the dump's ring
            # CONTAINS the watchdog_kill event), then the SIGKILL — a
            # crash-time recorder that dumps after the kill records a
            # timeline missing its own cause
            obs.event("fault", action="watchdog_kill", stage=describe,
                      reason=why, elapsed_s=round(time.monotonic() - t0, 3))
            _flight.maybe_dump("watchdog_kill", stage=describe, why=why)
            _kill_tree(proc)
            reader.join(5.0)
            raise StageTimeout(f"watchdog killed child {describe!r}: {why}")
    except BaseException:
        # KeyboardInterrupt / preemption in the supervisor must not
        # orphan the (session-detached) child tree
        if proc.poll() is None:
            _kill_tree(proc)
        raise


def _kill_tree(proc) -> None:
    """SIGKILL the supervised child's process group (it leads its own
    session); fall back to the direct child if the group is gone."""
    import signal as _signal

    try:
        os.killpg(proc.pid, _signal.SIGKILL)
    except (ProcessLookupError, PermissionError, OSError):
        proc.kill()
    proc.wait()
