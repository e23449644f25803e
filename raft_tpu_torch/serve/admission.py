"""Admission control for the serving engine (counterpart of
raft_tpu/serve/admission.py): bounded queueing with backpressure,
per-request deadlines, and graceful degradation under overload. Pure
host code, line for line the JAX module.

The queue is bounded in ROWS (queries), not requests — device cost is
per-row, so a thousand 1-row callers and one 1000-row caller should hit
the same wall. Two full-queue policies:

  "block"   the submitting thread waits (bounded by `block_timeout_s`)
            until the worker drains room — backpressure propagates to
            callers, total memory stays bounded (the classic
            producer/consumer stance).
  "reject"  `submit` raises `RejectedError` immediately — the
            load-shedding stance: callers own their retry/fallback
            policy and the serving path never blocks.

Deadlines: a request may carry an absolute budget (`deadline_s` from
submit time, or `default_deadline_s`). The batcher drops expired
requests AT POP TIME, before any device work — a request that waited
out its budget in the queue wastes zero device cycles and fails with
`DeadlineExceeded` (RAFT has no analogue; this is standard
earliest-deadline load shedding).

Degradation: under overload, approximate-search quality is the cheapest
currency — `probe_scale()` maps queue fill to a multiplier the engine
applies to `n_probes` (floor `min_probe_scale`), trading recall for
latency exactly the way the degraded MNMG path trades coverage
(`comms.resilience`). Scale-ups are capped at 1.0: overload never
*raises* work.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional


class RejectedError(RuntimeError):
    """Admission refused the request (full queue under policy="reject",
    or a blocked submit that timed out)."""


class DeadlineExceeded(RuntimeError):
    """The request's deadline passed before results were delivered; if
    it expired in the queue, it was dropped without executing."""


class ServerClosed(RuntimeError):
    """The server was stopped; queued/new requests cannot complete."""


@dataclasses.dataclass(frozen=True)
class AdmissionConfig:
    """Knobs for `AdmissionController`.

    max_pending_rows   row bound on the queue (backpressure threshold)
    policy             "block" | "reject" (see module docstring)
    block_timeout_s    max wall seconds a blocked submit waits for room
    default_deadline_s deadline applied when submit passes none
                       (None = no deadline)
    degrade_at         queue-fill fraction where probe shrinking starts
    min_probe_scale    floor of the n_probes multiplier at 100% fill
    """

    max_pending_rows: int = 4096
    policy: str = "block"
    block_timeout_s: float = 30.0
    default_deadline_s: Optional[float] = None
    degrade_at: float = 0.75
    min_probe_scale: float = 0.25

    def __post_init__(self):
        if self.policy not in ("block", "reject"):
            raise ValueError(f"unknown admission policy {self.policy!r}")
        if self.max_pending_rows <= 0:
            raise ValueError("max_pending_rows must be positive")
        if not (0.0 < self.degrade_at <= 1.0):
            raise ValueError("degrade_at must be in (0, 1]")
        if not (0.0 < self.min_probe_scale <= 1.0):
            raise ValueError("min_probe_scale must be in (0, 1]")


class AdmissionController:
    """Pure policy object: the batcher owns the lock/condition and the
    row counter; this class answers "may this request enter?", "when
    does it expire?", and "how degraded is the engine right now?"."""

    def __init__(self, config: AdmissionConfig):
        self.config = config

    # -- admission -----------------------------------------------------

    def has_room(self, pending_rows: int, n_rows: int) -> bool:
        return pending_rows + n_rows <= self.config.max_pending_rows

    def admit(self, n_rows: int, pending_rows_fn, cond,
              closed_fn) -> None:
        """Gate one submit. Caller MUST hold `cond`'s lock. Blocks (on
        `cond`) or raises `RejectedError` per policy; oversized requests
        that could never fit are rejected under either policy."""
        cfg = self.config
        if n_rows > cfg.max_pending_rows:
            raise RejectedError(
                f"request of {n_rows} rows exceeds max_pending_rows="
                f"{cfg.max_pending_rows}; split it (see batch_loader)"
            )
        if self.has_room(pending_rows_fn(), n_rows):
            return
        if cfg.policy == "reject":
            raise RejectedError(
                f"queue full ({pending_rows_fn()}/{cfg.max_pending_rows} "
                "rows) under policy='reject'"
            )
        deadline = time.monotonic() + cfg.block_timeout_s
        while not self.has_room(pending_rows_fn(), n_rows):
            if closed_fn():
                raise ServerClosed("server stopped while submit was blocked")
            remaining = deadline - time.monotonic()
            if remaining <= 0 or not cond.wait(timeout=remaining):
                raise RejectedError(
                    f"blocked submit timed out after {cfg.block_timeout_s}s "
                    f"({pending_rows_fn()}/{cfg.max_pending_rows} rows queued)"
                )

    # -- deadlines -----------------------------------------------------

    def deadline_for(self, deadline_s: Optional[float]) -> Optional[float]:
        """Relative budget -> absolute monotonic deadline (None = none)."""
        if deadline_s is None:
            deadline_s = self.config.default_deadline_s
        if deadline_s is None:
            return None
        return time.monotonic() + float(deadline_s)

    @staticmethod
    def expired(deadline: Optional[float], now: Optional[float] = None) -> bool:
        if deadline is None:
            return False
        return (time.monotonic() if now is None else now) >= deadline

    # -- degradation ---------------------------------------------------

    def probe_scale(self, pending_rows: int) -> float:
        """n_probes multiplier for the CURRENT queue fill: 1.0 below
        `degrade_at`, then linear down to `min_probe_scale` at a full
        queue. Continuous (no cliff), monotone in load.

        Composition with adaptive probing: the searcher applies this
        scale FIRST, as a floor-with-min-1 CAP on n_probes
        (engine._scaled_probes), and a request's `recall_target`
        budgets then adapt within that cap — overload can only shrink
        work, per-query adaptivity only redistributes it."""
        cfg = self.config
        fill = min(1.0, pending_rows / cfg.max_pending_rows)
        if fill <= cfg.degrade_at:
            return 1.0
        frac = (fill - cfg.degrade_at) / (1.0 - cfg.degrade_at)
        return 1.0 - frac * (1.0 - cfg.min_probe_scale)
