"""Resilience layer for the comms stack (counterpart of
raft_tpu/comms/resilience.py): health-check barrier with a deadline,
per-rank liveness masks, bootstrap retry, and the degraded-mode plumbing
of the distributed searches.

The model: liveness is host knowledge, a `RankHealth` mask over the
ranks, fed by the health-check barrier and by fault drills
(`core.faults`), read by the distributed searches, which mask unhealthy
ranks' candidates out of the merge and report a `coverage` fraction
(served shards / total) beside their results. A masked rank's shard stops
contributing: recall degrades by at most its data share, and the query
never dies. With r-way replication (comms/replication.py) the brute-force
k-NN fails over to a surviving holder and the degradation never shows.

"Dead" is modeled as "masked": a crashed process still takes its
collectives down with it (the recovery unit is then the job). The mask
covers the larger class of soft failures (stragglers past a deadline,
poisoned shards, drained hosts) where a rank still answers collectives
but must not shape results.

`rehydrate` reloads a distributed index checkpoint onto the recovered
world (`mnmg_ckpt`), retrying flaky reads; `comms.recovery` falls back to
it when a lost shard has no surviving replica.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import faults
from raft_tpu_torch.core.interruptible import TimeoutException, synchronize
from raft_tpu_torch.core.logger import logger
from raft_tpu_torch.comms.comms import Comms, P, _process_index_count
from raft_tpu_torch.comms.mnmg_common import _cached_wrapper, wrapper_key


class HealthCheckTimeout(RuntimeError):
    """A barrier missed its deadline: at least one rank never arrived.
    Recovery is job-level (re-bootstrap / rehydrate), not mask-level."""


class DegradedSearchResult(NamedTuple):
    """A distributed search result under a liveness mask: `coverage` is
    served shards / total shards (1.0 == every shard answered, replica
    failover included); `repaired_ranks` lists unhealthy ranks whose
    shard a surviving replica holder served losslessly (they count as
    served)."""

    values: torch.Tensor
    ids: torch.Tensor
    coverage: float
    repaired_ranks: Tuple[int, ...] = ()


@dataclasses.dataclass
class RankHealth:
    """Per-rank liveness mask over a comms world (True = healthy)."""

    mask: np.ndarray

    @classmethod
    def all_healthy(cls, world: int) -> "RankHealth":
        return cls(np.ones(int(world), bool))

    @property
    def world(self) -> int:
        return int(self.mask.size)

    def mark_unhealthy(self, rank: int) -> "RankHealth":
        return self._mark(rank, False)

    def mark_healthy(self, rank: int) -> "RankHealth":
        return self._mark(rank, True)

    def _mark(self, rank: int, healthy: bool) -> "RankHealth":
        rank = int(rank)
        changed = bool(self.mask[rank]) != healthy
        self.mask[rank] = healthy
        if changed:
            # health transitions (not repeated marks) land on the obs bus,
            # so a chaos drill leaves an auditable rank timeline
            obs.event("health", rank=rank, healthy=healthy, coverage=self.coverage())
        return self

    def healthy_ranks(self) -> Tuple[int, ...]:
        return tuple(int(r) for r in np.flatnonzero(self.mask))

    @property
    def degraded(self) -> bool:
        return bool((~self.mask).any())

    def coverage(self) -> float:
        return float(self.mask.sum()) / float(self.mask.size)

    def live_f32(self) -> np.ndarray:
        """The (world,) float32 mask the search bodies read."""
        return self.mask.astype(np.float32)


class RetryExhausted(RuntimeError):
    """`retry_with_backoff` gave up (retry count or elapsed-time budget
    spent). Chains the final underlying failure as `__cause__`."""


def retry_with_backoff(
    fn: Callable,
    max_retries: int = 3,
    base_delay_s: float = 0.05,
    max_delay_s: float = 2.0,
    retry_on: tuple = (RuntimeError,),
    describe: str = "operation",
    jitter: float = 0.1,
    seed: Optional[int] = None,
    max_elapsed_s: Optional[float] = None,
):
    """Run `fn()` with exponential backoff: up to `max_retries` retries
    after the first failure, sleeping min(max_delay_s, base * 2^attempt)
    times a seeded jitter factor in [1, 1 + jitter) between attempts (the
    draws derive from (`seed` or $RAFT_TPU_FAULT_SEED, `describe`, this
    process's rank), so a replayed drill sleeps the same schedule and
    different ranks decorrelate). `max_elapsed_s` caps the whole retry
    window. Exhaustion raises `RetryExhausted` chaining the final failure;
    errors outside `retry_on` propagate at once. Every retry lands a
    kind="retry" event on the obs bus."""
    import zlib

    if seed is None:
        seed = int(os.environ.get(faults.ENV_SEED, "0"))
    rng = np.random.default_rng((int(seed), zlib.crc32(describe.encode()),
                                 _process_index_count()[0]))
    t0 = time.monotonic()
    attempt = 0
    while True:
        try:
            return fn()
        except retry_on as e:
            elapsed = time.monotonic() - t0
            delay = min(max_delay_s, base_delay_s * (2 ** attempt))
            delay *= 1.0 + max(0.0, float(jitter)) * float(rng.random())
            exhausted_budget = (max_elapsed_s is not None
                                and elapsed + delay > max_elapsed_s)
            if attempt >= max_retries or exhausted_budget:
                raise RetryExhausted(
                    f"{describe} failed after {attempt + 1} attempt(s) "
                    f"in {elapsed:.3f}s"
                    + (" (max_elapsed_s budget spent)" if exhausted_budget else "")
                    + f": {e}"
                ) from e
            obs.event("retry", describe=describe, attempt=attempt + 1,
                      max_retries=max_retries, delay_s=delay, error=repr(e))
            logger.warning("%s failed (%s); retry %d/%d in %.3fs",
                           describe, e, attempt + 1, max_retries, delay)
            time.sleep(delay)
            attempt += 1


def _barrier_fn(comms: Comms):
    """The world-wide barrier body (one scalar allreduce: collectives are
    ordered, so its completion fences every rank), cached per world."""

    def build():
        def body(ac, x):
            return ac.barrier(torch.sum(x))

        def run(x, timeout_s):
            return comms.run(body, x, in_specs=P(comms.axis), out_specs=P(),
                             timeout_s=timeout_s)

        return run

    return _cached_wrapper(wrapper_key("resilience_barrier", comms), build)


BARRIER_SITE = "resilience.barrier"


def health_barrier(comms: Comms, timeout_s: float = 30.0,
                   poll_interval_s: float = 0.001) -> float:
    """World-wide barrier with a host-side deadline: one scalar collective
    whose every wait carries the remaining budget, then its result awaited
    through `interruptible.synchronize` (cancellable from another thread;
    `TimeoutException` past the deadline surfaces as `HealthCheckTimeout`).
    Returns the elapsed wall seconds. Site "resilience.barrier" adds
    straggler latency under an installed `FaultPlan`; the deadline covers
    it."""
    t0 = time.monotonic()
    faults.fault_point(BARRIER_SITE)
    remaining = timeout_s - (time.monotonic() - t0)
    if remaining <= 0:
        raise HealthCheckTimeout(
            f"mesh barrier missed the {timeout_s}s deadline before dispatch")
    ones = np.ones(len(comms.local_ranks()), np.float32)
    token = _barrier_fn(comms)(comms.shard_from_local(ones), remaining)
    remaining = timeout_s - (time.monotonic() - t0)
    try:
        synchronize(token, poll_interval_s=poll_interval_s, timeout_s=max(remaining, 0.0))
    except TimeoutException as e:
        raise HealthCheckTimeout(f"mesh barrier missed the {timeout_s}s deadline: {e}") from e
    elapsed = time.monotonic() - t0
    if obs.enabled():
        # the one collective whose completion the host fences: its wall
        # latency is the world's observable health signal
        obs.histogram("comms.barrier.latency_s").observe(elapsed)
    return elapsed


def probe_health(comms: Comms, timeout_s: float = 30.0,
                 plan: Optional[faults.FaultPlan] = None) -> RankHealth:
    """The liveness mask of a world: ranks killed by the (installed or
    passed) fault plan are masked out, as are declared stragglers whose
    latency exceeds the deadline (they missed it by construction; nobody
    sleeps it out); then the real barrier runs with the remaining budget.
    A barrier timeout raises `HealthCheckTimeout`."""
    plan = plan if plan is not None else faults.active_plan()
    health = RankHealth.all_healthy(comms.get_size())
    if plan is not None:
        def scoped(rank: int):
            # rank=-1 faults scope to every rank
            return range(health.world) if rank < 0 else (
                [rank] if rank < health.world else [])

        for f in plan.matching(BARRIER_SITE, "kill_rank"):
            for r in scoped(f.rank):
                health.mark_unhealthy(r)
        over_deadline = False
        for f in plan.matching(BARRIER_SITE, "slow_rank"):
            if f.latency_s > timeout_s:
                over_deadline = True
                for r in scoped(f.rank):
                    health.mark_unhealthy(r)
        if over_deadline:
            return health
    if plan is not None and faults.active_plan() is not plan:
        # a passed plan drives the barrier's site too, as an installed one
        with plan.install():
            health_barrier(comms, timeout_s=timeout_s)
    else:
        health_barrier(comms, timeout_s=timeout_s)
    return health


REHYDRATE_SITE = "mnmg_ckpt.load"


def rehydrate(comms: Comms, filename: str, max_retries: int = 3):
    """Checkpoint-based rank re-hydration: load a distributed index
    checkpoint (`ivf_flat_save[_local]` / `ivf_pq_save[_local]` /
    `ivf_rabitq_save`) onto the recovered world and return `(index,
    RankHealth.all_healthy)`; the serving loop swaps the degraded index for
    the fresh one and resumes at full coverage. Flaky reads (injected
    faults, transient I/O errors, a header torn by a concurrent writer:
    `SerializationError`, raw struct / JSON decode failures) retry with
    backoff and surface as `RetryExhausted` (chaining the last cause) once
    the window is spent; a well-formed checkpoint of another kind raises
    ValueError at once."""
    import json
    import struct

    from raft_tpu_torch.comms import mnmg_ckpt
    from raft_tpu_torch.core.serialize import SerializationError, peek_meta

    def load_once():
        # the kind probe reads the header only, and sits inside the retry
        # so a transient failure of the probe itself gets the backoff too
        kind = str(peek_meta(filename).get("kind", ""))
        if kind.startswith("mnmg_ivf_flat"):
            return mnmg_ckpt.ivf_flat_load(comms, filename)
        if kind.startswith("mnmg_ivf_pq"):
            return mnmg_ckpt.ivf_pq_load(comms, filename)
        if kind.startswith("mnmg_ivf_rabitq"):
            return mnmg_ckpt.ivf_rabitq_load(comms, filename)
        raise ValueError(f"not a distributed index checkpoint: kind={kind!r}")

    index = retry_with_backoff(
        load_once, max_retries=max_retries,
        retry_on=(faults.FaultInjected, OSError, SerializationError, struct.error,
                  json.JSONDecodeError),
        describe=f"rehydrate({filename!r})")
    return index, RankHealth.all_healthy(comms.get_size())
