"""SLO watchtower: declarative objectives with multi-window burn rates
(counterpart of raft_tpu/obs/slo.py).

An `Objective` declares a service-level target ("99% of requests under
50 ms", "99.9% not expired/rejected", "coverage never below 1.0",
"occupancy at least 0.25") and the `Watchtower` evaluates a stream of
per-request / per-batch samples against it over two sliding windows, a
fast one (default 5 min) that reacts and a slow one (default 1 h) that
confirms, using burn rates:

    burn = bad_fraction / error_budget        (budget = 1 - target)

An objective **breaches** only when BOTH windows are at or above
`breach_burn`, and **recovers** only when both fall below
`recover_burn` < `breach_burn` (hysteresis, so a burn hovering at the
threshold cannot flap). Transitions publish `slo.breach` /
`slo.recover` bus events and bump matching counters; `obs.report`
renders them as the SLO section, and `judge_serve` turns a serving
metrics snapshot into flat `slo_*` verdict fields.

Determinism: the clock is injectable and every `observe`/`evaluate`
takes an explicit `t`, so tests drive the windows with synthetic time.
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

#: objective kinds and what makes one sample "bad"
#:   latency    latency_s  > threshold
#:   error      outcome not in ("ok", "degraded")
#:   coverage   coverage   < threshold
#:   occupancy  occupancy  < threshold
KINDS = ("latency", "error", "coverage", "occupancy")


@dataclasses.dataclass(frozen=True)
class Objective:
    """One declared service-level objective.

    `target` is the required good fraction (0.99 = "99% good"); the
    error budget is `1 - target`. `threshold` parameterizes the
    per-sample good/bad classification for the kinds that need one.
    """

    name: str
    kind: str
    target: float
    threshold: float = 0.0

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown objective kind {self.kind!r}; "
                             f"expected one of {KINDS}")
        if not (0.0 < self.target < 1.0):
            raise ValueError(f"target must be in (0, 1), got {self.target}")

    @property
    def budget(self) -> float:
        return 1.0 - self.target


def serve_objectives(p99_s: float = 0.25, error_target: float = 0.99,
                     coverage_floor: float = 1.0,
                     occupancy_floor: float = 0.05) -> List[Objective]:
    """The default serve-path objective set (tune per deployment)."""
    return [
        Objective("latency_p99", "latency", target=0.99, threshold=p99_s),
        Objective("error_rate", "error", target=error_target),
        Objective("coverage", "coverage", target=0.999,
                  threshold=coverage_floor),
        Objective("occupancy", "occupancy", target=0.95,
                  threshold=occupancy_floor),
    ]


class _Window:
    """Sliding (t, bad) sample window. Pruning amortizes O(1) per add."""

    __slots__ = ("horizon_s", "_dq", "_bad")

    def __init__(self, horizon_s: float):
        self.horizon_s = float(horizon_s)
        self._dq: collections.deque = collections.deque()
        self._bad = 0

    def add(self, t: float, bad: bool) -> None:
        self._dq.append((t, bad))
        if bad:
            self._bad += 1
        self._prune(t)

    def _prune(self, now: float) -> None:
        cutoff = now - self.horizon_s
        dq = self._dq
        while dq and dq[0][0] <= cutoff:
            _, b = dq.popleft()
            if b:
                self._bad -= 1

    def bad_fraction(self, now: float) -> float:
        self._prune(now)
        n = len(self._dq)
        return (self._bad / n) if n else 0.0


class Watchtower:
    """Evaluates objectives over fast+slow windows and publishes
    breach/recover transitions. Not thread-safe by itself: a caller
    feeding it from several threads holds one lock around it."""

    def __init__(self, objectives: Sequence[Objective],
                 fast_s: float = 300.0, slow_s: float = 3600.0,
                 breach_burn: float = 14.0, recover_burn: float = 1.0,
                 clock=time.monotonic):
        if recover_burn >= breach_burn:
            raise ValueError("recover_burn must be < breach_burn "
                             "(hysteresis)")
        self.objectives = {o.name: o for o in objectives}
        if len(self.objectives) != len(objectives):
            raise ValueError("duplicate objective names")
        self.breach_burn = float(breach_burn)
        self.recover_burn = float(recover_burn)
        self._clock = clock
        self._fast = {o.name: _Window(fast_s) for o in objectives}
        self._slow = {o.name: _Window(slow_s) for o in objectives}
        self._breached: Dict[str, bool] = {o.name: False for o in objectives}

    # -- sample intake ----------------------------------------------------

    def _add(self, name: str, bad: bool, t: float) -> None:
        self._fast[name].add(t, bad)
        self._slow[name].add(t, bad)

    def observe(self, name: str, bad: bool, t: Optional[float] = None) -> None:
        """Record one pre-classified sample for one objective."""
        if name not in self.objectives:
            raise KeyError(name)
        self._add(name, bool(bad), self._clock() if t is None else t)

    def observe_request(self, latency_s: Optional[float] = None,
                        outcome: str = "ok",
                        coverage: Optional[float] = None,
                        t: Optional[float] = None) -> None:
        """Route one request terminal record to every objective whose
        kind it parameterizes. Expired/rejected requests carry no
        latency or coverage — they feed only the error objective, which
        is exactly the truthfulness fix: the killed requests count."""
        if t is None:
            t = self._clock()
        for name, o in self.objectives.items():
            if o.kind == "latency" and latency_s is not None:
                self._add(name, latency_s > o.threshold, t)
            elif o.kind == "error":
                self._add(name, outcome not in ("ok", "degraded"), t)
            elif o.kind == "coverage" and coverage is not None:
                self._add(name, coverage < o.threshold, t)

    def observe_batch(self, occupancy: float,
                      t: Optional[float] = None) -> None:
        if t is None:
            t = self._clock()
        for name, o in self.objectives.items():
            if o.kind == "occupancy":
                self._add(name, occupancy < o.threshold, t)

    # -- evaluation -------------------------------------------------------

    def burns(self, name: str, t: Optional[float] = None) -> tuple:
        """(fast_burn, slow_burn) for one objective at time t."""
        if t is None:
            t = self._clock()
        o = self.objectives[name]
        return (self._fast[name].bad_fraction(t) / o.budget,
                self._slow[name].bad_fraction(t) / o.budget)

    def evaluate(self, t: Optional[float] = None) -> List[dict]:
        """Check every objective; publish and return the transitions
        ([{objective, transition, fast_burn, slow_burn}])."""
        from raft_tpu_torch import obs

        if t is None:
            t = self._clock()
        transitions = []
        for name in sorted(self.objectives):
            fast, slow = self.burns(name, t)
            breached = self._breached[name]
            if (not breached and fast >= self.breach_burn
                    and slow >= self.breach_burn):
                self._breached[name] = True
                transitions.append({"objective": name,
                                    "transition": "breach",
                                    "fast_burn": round(fast, 4),
                                    "slow_burn": round(slow, 4)})
            elif (breached and fast < self.recover_burn
                    and slow < self.recover_burn):
                self._breached[name] = False
                transitions.append({"objective": name,
                                    "transition": "recover",
                                    "fast_burn": round(fast, 4),
                                    "slow_burn": round(slow, 4)})
        for tr in transitions:
            kind = f"slo.{tr['transition']}"
            obs.counter(kind).inc()
            obs.event(kind, objective=tr["objective"],
                      fast_burn=tr["fast_burn"], slow_burn=tr["slow_burn"])
        return transitions

    def state(self, t: Optional[float] = None) -> dict:
        """Current status per objective (for reports/benches)."""
        if t is None:
            t = self._clock()
        out = {}
        for name in sorted(self.objectives):
            fast, slow = self.burns(name, t)
            out[name] = {"breached": self._breached[name],
                         "fast_burn": round(fast, 4),
                         "slow_burn": round(slow, 4)}
        return out


# ---------------------------------------------------------------------------
# snapshot judgment for bench rows


def judge_serve(metrics_snapshot: dict, p99_ms: float = 250.0,
                error_budget: float = 0.01, coverage_floor: float = 1.0,
                occupancy_floor: float = 0.0) -> dict:
    """Judge one serving metrics snapshot against serve objectives,
    returning flat `slo_*` fields for a bench ledger row. NaN stats
    (no traffic) judge as failing — an empty run can't claim its SLOs
    held."""
    def _ok(value, pred):
        try:
            v = float(value)
        except (TypeError, ValueError):
            return False
        return v == v and pred(v)

    snap = metrics_snapshot
    submitted = int(snap.get("submitted") or 0)
    killed = int(snap.get("expired") or 0) + int(snap.get("rejected") or 0) \
        + int(snap.get("failed") or 0)
    error_rate = (killed / submitted) if submitted else 1.0
    verdict = {
        "slo_p99_ms_budget": float(p99_ms),
        "slo_p99_ok": _ok(snap.get("latency_ms_p99"), lambda v: v <= p99_ms),
        "slo_error_rate": round(error_rate, 6),
        "slo_error_ok": submitted > 0 and error_rate <= error_budget,
        "slo_coverage_ok": _ok(snap.get("coverage_min", 1.0),
                               lambda v: v >= coverage_floor),
        "slo_occupancy_ok": _ok(snap.get("batch_occupancy"),
                                lambda v: v >= occupancy_floor),
    }
    verdict["slo_ok"] = all(v for k, v in verdict.items() if k.endswith("_ok"))
    return verdict
