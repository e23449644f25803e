"""Deterministic, seedable fault injection (counterpart of
raft_tpu/core/faults.py).

A `FaultPlan` says which faults fire at which named injection sites, and
the port's modules consult it at those sites. No plan installed means
every hook returns its input unchanged: the same tensor object, with no
copy and no device sync.

Fault kinds (the JAX package's vocabulary):

  kill_rank       a rank declared dead; at a `crash_point` the count-th
                  visit SIGKILLs this process.
  slow_rank       host-side latency at a site (`time.sleep`); at a
                  `stall_point`, a missed beat.
  corrupt_shard   a seeded fraction of a float payload replaced with NaN
                  (`corrupt_in_trace` on tensors, `corrupt_host` on host
                  blocks), or a seeded run of a file's bytes flipped
                  (`corrupt_file`).
  drop_collective a contribution replaced with the reduction identity
                  (`drop_contribution`).
  flaky_bootstrap the first `count` visits of a `fault_point` raise
                  `FaultInjected`.

`FAULT_SITES` holds the sites that have a live hook in this package,
each with the JAX package's description word for word: all 31 of the
JAX registry.

Determinism: every host draw is a numpy generator seeded from
(`site_seed`, fault position, draw count), so masks, byte offsets and
victims equal the JAX package's bit for bit for the same plan.
`corrupt_in_trace` draws with a `torch.Generator` on the tensor's device
seeded from `site_seed` and the fault's position: the positions differ
from `jax.random`'s by construction, their count and fraction do not.
`RAFT_TPU_FAULT_SEED` seeds plans that do not pass a seed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import fnmatch
import os
import threading
import time
import zlib
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

KINDS = (
    "kill_rank",
    "slow_rank",
    "corrupt_shard",
    "drop_collective",
    "flaky_bootstrap",
)

ENV_SEED = "RAFT_TPU_FAULT_SEED"

# the site registry: every entry has a live hook in this package (the
# descriptions are the JAX package's, one line each; the module
# docstring renders from this dict)
FAULT_SITES = {
    "batch_loader.load": (
        "host loader block fetch (slow_rank latency, flaky reads, "
        "corrupt_host NaNs in a streamed block)"),
    "ckpt.corrupt_file": (
        "post-commit checkpoint sector rot: corrupt_shard flips seeded "
        "bytes of a just-written file's data region (CRC loads heal from "
        "peer mirror slices, comms/mnmg_ckpt)"),
    "comms.allgather": (
        "traced allgather contribution (corrupt_shard NaNs / "
        "drop_collective identity on the faulted rank)"),
    "comms.allreduce": (
        "traced allreduce contribution (corrupt_shard NaNs / "
        "drop_collective identity on the faulted rank)"),
    "comms.bootstrap": (
        "multihost init entry (flaky_bootstrap exercises "
        "retry_with_backoff; slow_rank models a straggling controller)"),
    "comms.quant.decode": (
        "quantized-collective scale sidecar AFTER transport, before "
        "decode (corrupt_shard NaNs the faulted rank's received scales "
        "— its decoded contributions degrade visibly, never a crash; "
        "comms/quantized)"),
    "comms.quant.encode": (
        "quantized-collective scale sidecar AFTER encode, before "
        "transport (corrupt_shard NaNs the faulted rank's outgoing "
        "scales — downstream decodes degrade visibly, never a crash; "
        "comms/quantized)"),
    "fused.scan.scores": (
        "fused scan+select-k kernel's candidate buffer (corrupt_shard "
        "NaNs the selected candidate values in-trace, before callers "
        "merge/finalize — every fused engine flows through it; "
        "ops/fused_scan)"),
    "integrity.scrub.crash": (
        "online-scrub cursor boundary AFTER the scrub-cursor JSON "
        "commits (kill_rank SIGKILLs this process on its count-th visit "
        "— the mid-scrub kill-and-resume drill: the resumed walk "
        "continues from the cursor instead of restarting; "
        "raft_tpu/jobs/streaming resumable_scrub)"),
    "integrity.table.rot": (
        "seeded in-memory rot of a live index table — the HBM/host "
        "analogue of ckpt.corrupt_file (corrupt_shard low-byte-flips a "
        "seeded fraction of a seeded payload list's elements, or a rank "
        "shard under MNMG; detection/containment/repair is "
        "raft_tpu/integrity's whole job)"),
    "ivf.probe_budget": (
        "per-query adaptive probe budgets inside the traced plan "
        "(corrupt_shard NaNs a seeded fraction of the budget vector; "
        "the plan clamps corrupted entries down to min_probes — "
        "SHRUNKEN budgets, visible as recall loss, never a crash; "
        "neighbors/probe_budget)"),
    "ivf_rabitq.build.encode": (
        "host-side RaBitQ encode stage of build/extend (slow_rank "
        "models a slow encode pass — latency only, results untouched; "
        "flaky_bootstrap a transient dispatch failure)"),
    "job.heartbeat.stall": (
        "watchdog heartbeat write inside a supervised stage (slow_rank "
        "here STALLS the first `count` beats for latency_s without "
        "beating — the stall the watchdog must kill + retry; "
        "raft_tpu/jobs/watchdog)"),
    "job.preempt": (
        "job-runner preemption check between stages and at streaming "
        "batch boundaries (flaky_bootstrap simulates a SIGTERM-style "
        "preempt: the runner checkpoints then suspends as JobPreempted; "
        "raft_tpu/jobs/runner)"),
    "job.stage.crash": (
        "streaming-build batch boundary AFTER the checkpoint commits "
        "(kill_rank SIGKILLs this process on its count-th visit — the "
        "kill-and-resume bit-identity drill; flaky_bootstrap a "
        "transient stage failure retried by the supervised runner; "
        "raft_tpu/jobs/streaming)"),
    "mnmg.ivf_flat.scores": (
        "per-rank IVF-Flat candidate scores inside the traced search "
        "(corrupt_shard poisons a shard's contribution pre-merge)"),
    "mnmg.ivf_pq.scores": (
        "per-rank IVF-PQ candidate scores inside the traced search "
        "(corrupt_shard poisons a shard's contribution pre-merge)"),
    "mnmg.ivf_rabitq.scores": (
        "per-rank IVF-RaBitQ estimator scores inside the traced search "
        "(corrupt_shard poisons a shard's contribution pre-merge)"),
    "mnmg.kmeans.partials": (
        "per-rank partial EM sums inside the traced k-means step "
        "(corrupt_shard poisons a shard's contribution before the "
        "allreduce)"),
    "mnmg.kmeans.step": (
        "host-side per-iteration k-means driver step (slow_rank models "
        "a straggling rank between collectives)"),
    "mnmg.knn.scores": (
        "per-rank brute-force scores inside the traced distributed knn "
        "(corrupt_shard poisons a shard's contribution pre-merge)"),
    "mnmg_ckpt.load": (
        "host checkpoint load entry (flaky_bootstrap torn reads retried "
        "by resilience.rehydrate; slow_rank models cold storage)"),
    "mutation.log.commit": (
        "mutation-log batch boundary, visited AFTER each log append and "
        "AFTER each checkpoint commit (kill_rank SIGKILLs this process "
        "on its count-th visit — odd/even counts land in the "
        "log-ahead-of-checkpoint vs just-committed windows of the "
        "kill-and-resume bit-identity drill; neighbors/mutation)"),
    "mutation.rebalance": (
        "tombstone-compaction entry (flaky_bootstrap a transient "
        "rebalance failure retried by the supervised runner; slow_rank "
        "models a long repack; neighbors/mutation)"),
    "mutation.tombstone": (
        "delete/upsert tombstoning entry (flaky_bootstrap a transient "
        "mutation failure surfaced BEFORE any state changes — the index "
        "and log are untouched when it raises; neighbors/mutation)"),
    "obs.flight.dump": (
        "flight-recorder dump entry (flaky_bootstrap a failing dump — "
        "maybe_dump swallows it, so a broken recorder never takes down "
        "the worker loop / watchdog / crash path it observes; slow_rank "
        "models slow crash-time IO; raft_tpu/obs/flight)"),
    "replica.stale": (
        "kill_rank here declares a rank's HOSTED replica copies "
        "unusable without killing the rank — failover elections skip "
        "stale holders (comms/replication)"),
    "resilience.barrier": (
        "health-barrier entry (slow_rank past the deadline marks the "
        "rank unhealthy instead of sleeping it out)"),
    "serve.batch": (
        "serving batch dispatch (slow_rank models slow device work — "
        "the serving analogue of a straggling rank)"),
    "serve.submit": (
        "serving ingress (slow_rank/flaky_bootstrap model slow or flaky "
        "request admission)"),
    "serve.trace.stamp": (
        "request-trace stage stamp (flaky_bootstrap corrupts the stamp: "
        "the TraceCtx goes dead and the request degrades to UNTRACED — "
        "served results stay bit-identical, tracing only observes; "
        "raft_tpu/obs/trace)"),
}


def known_sites() -> Tuple[str, ...]:
    """Sorted tuple of every registered injection site name."""
    return tuple(sorted(FAULT_SITES))


class FaultInjected(RuntimeError):
    """Raised by `fault_point` for an armed flaky fault (distinguishable
    from genuine failures, so retry loops can count chaos apart)."""


@dataclasses.dataclass(frozen=True)
class Fault:
    """One fault: `kind` at sites matching the `site` glob, scoped to
    `rank` (-1 = every rank). `latency_s` drives slow_rank, `fraction`
    the corrupted share of a payload, `count` how many times a flaky
    site fails before succeeding (at a `crash_point`: which visit dies)."""

    kind: str
    site: str = "*"
    rank: int = -1
    latency_s: float = 0.0
    fraction: float = 1.0
    count: int = 1

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"unknown fault kind {self.kind!r}; one of {KINDS}")
        if not (0.0 <= self.fraction <= 1.0):
            raise ValueError(f"fraction must be in [0, 1], got {self.fraction}")

    def key(self) -> tuple:
        return (self.kind, self.site, self.rank, float(self.latency_s),
                float(self.fraction), int(self.count))


class FaultPlan:
    """A deterministic, replayable set of faults.

    Install with `with plan.install(): ...` (re-entrant; inner plans
    shadow outer ones). `reset()` clears the fired counters so the same
    plan object replays identically; `trace_key()` is its fingerprint."""

    def __init__(self, faults: Sequence[Fault] = (), seed: Optional[int] = None):
        if seed is None:
            seed = int(os.environ.get(ENV_SEED, "0"))
        self.seed = int(seed)
        self.faults: Tuple[Fault, ...] = tuple(faults)
        self._fired: dict = {}
        self._lock = threading.Lock()

    def matching(self, site: str, kind: str) -> Tuple[Fault, ...]:
        return tuple(f for f in self.faults
                     if f.kind == kind and fnmatch.fnmatchcase(site, f.site))

    def killed_ranks(self, site: str = "*") -> Tuple[int, ...]:
        """Ranks declared dead by kill_rank faults whose glob matches `site`."""
        return tuple(sorted({f.rank for f in self.matching(site, "kill_rank") if f.rank >= 0}))

    def site_seed(self, site: str) -> int:
        """Deterministic per-site seed, stable across processes (crc32,
        not hash(): PYTHONHASHSEED must not matter)."""
        return (self.seed * 0x9E3779B1 + zlib.crc32(site.encode())) & 0x7FFFFFFF

    def trace_key(self) -> tuple:
        return (self.seed,) + tuple(f.key() for f in self.faults)

    def reset(self) -> None:
        with self._lock:
            self._fired.clear()

    def fire_count(self, site: str, fault: Fault) -> int:
        with self._lock:
            return self._fired.get((site, fault.key()), 0)

    def _next_draw(self, site: str) -> int:
        """Per-site monotone draw counter: successive host corruptions at
        one site sample different positions, while `reset()` (or a fresh
        plan) replays the identical sequence."""
        with self._lock:
            n = self._fired.get(("draw", site), 0)
            self._fired[("draw", site)] = n + 1
            return n

    def _arm(self, site: str, fault: Fault) -> bool:
        """Count one visit of a flaky site; True while the fault still has
        failures left to inject."""
        with self._lock:
            k = (site, fault.key())
            fired = self._fired.get(k, 0)
            if fired >= fault.count:
                return False
            self._fired[k] = fired + 1
            return True

    @contextlib.contextmanager
    def install(self):
        _STACK.append(self)
        try:
            yield self
        finally:
            _STACK.remove(self)


_STACK: list = []  # innermost-active-last plan stack


def _obs_event(**fields) -> None:
    """One kind="fault" event on the obs bus (a no-op while obs is
    disabled), so a chaos run leaves its timeline. Imported on the fired
    paths only: the no-plan path never touches obs."""
    from raft_tpu_torch import obs

    obs.event("fault", **fields)


def active_plan() -> Optional[FaultPlan]:
    return _STACK[-1] if _STACK else None


def trace_key() -> Optional[tuple]:
    """Fingerprint of the active plan (None when chaos is off)."""
    plan = active_plan()
    return None if plan is None else plan.trace_key()


def active_for(site: str) -> bool:
    """True when the active plan has a tensor-level fault (corrupt_shard
    or drop_collective) for `site`."""
    plan = active_plan()
    if plan is None:
        return False
    return bool(plan.matching(site, "corrupt_shard") or plan.matching(site, "drop_collective"))


# -- host-side hooks ---------------------------------------------------

def _host_rank_matches(fault: Fault, rank: Optional[int]) -> bool:
    """`rank` None means the site has no per-rank identity: the fault
    fires regardless."""
    return fault.rank < 0 or rank is None or fault.rank == rank


def fault_point(site: str, rank: Optional[int] = None) -> None:
    """Host-side site: sleeps for matching slow_rank faults, raises
    `FaultInjected` while a matching flaky fault has failures left."""
    plan = active_plan()
    if plan is None:
        return
    for f in plan.matching(site, "slow_rank"):
        if f.latency_s > 0 and _host_rank_matches(f, rank):
            _obs_event(site=site, action="slow", rank=f.rank, latency_s=f.latency_s)
            time.sleep(f.latency_s)
    for f in plan.matching(site, "flaky_bootstrap"):
        if _host_rank_matches(f, rank) and plan._arm(site, f):
            _obs_event(site=site, action="flaky", rank=f.rank,
                       fired=plan.fire_count(site, f), count=f.count)
            raise FaultInjected(f"injected flaky failure at {site!r} "
                                f"({plan.fire_count(site, f)}/{f.count})")


def crash_point(site: str, rank: Optional[int] = None) -> None:
    """Host-side hard-crash site: for each matching kill_rank fault, the
    `count`-th visit SIGKILLs this process (no handlers, no flushing).
    Called right after a commit, so a kill-and-resume drill proves the
    artifact on disk carries the resume. An armed flight recorder
    (obs/flight) dumps the timeline before the kill."""
    plan = active_plan()
    if plan is None:
        return
    import signal

    for f in plan.matching(site, "kill_rank"):
        if not _host_rank_matches(f, rank):
            continue
        with plan._lock:
            k = ("crash", site, f.key())
            n = plan._fired.get(k, 0) + 1
            plan._fired[k] = n
        if n == max(1, f.count):
            _obs_event(site=site, action="crash", rank=f.rank, visit=n)
            try:
                from raft_tpu_torch.obs import flight

                flight.maybe_dump("crash_point", site=site, visit=n)
            except Exception:
                pass  # the crash must not depend on the recorder's health
            os.kill(os.getpid(), signal.SIGKILL)


def stall_point(site: str, cancelled=None, poll_s: float = 0.01,
                rank: Optional[int] = None) -> bool:
    """Host-side stall site: for each matching slow_rank fault, the first
    `count` visits wait `latency_s` without doing the caller's work,
    polling `cancelled()` when given. Returns True when a stall fired."""
    plan = active_plan()
    if plan is None:
        return False
    stalled = False
    for f in plan.matching(site, "slow_rank"):
        if f.latency_s <= 0 or not _host_rank_matches(f, rank):
            continue
        if not plan._arm(site, f):
            continue
        _obs_event(site=site, action="stall", rank=f.rank, latency_s=f.latency_s)
        stalled = True
        deadline = time.monotonic() + f.latency_s
        while time.monotonic() < deadline:
            if cancelled is not None and cancelled():
                return True
            time.sleep(min(poll_s, max(0.0, deadline - time.monotonic())))
    return stalled


def corrupt_host(site: str, block: np.ndarray, rank: Optional[int] = None) -> np.ndarray:
    """Host-side payload corruption: NaN a seeded fraction of a float
    block (non-float blocks pass through). Each call draws a fresh mask
    (`_next_draw`), replayed identically after `reset()`."""
    plan = active_plan()
    if plan is None or not np.issubdtype(np.asarray(block).dtype, np.floating):
        return block
    out = block
    for i, f in enumerate(plan.matching(site, "corrupt_shard")):
        if not _host_rank_matches(f, rank):
            continue
        rng = np.random.default_rng((plan.site_seed(site), i, plan._next_draw(site)))
        mask = rng.random(out.shape) < f.fraction
        if mask.any():
            out = np.array(out, copy=True)
            out[mask] = np.nan
            _obs_event(site=site, action="corrupt_host", rank=f.rank, cells=int(mask.sum()))
    return out


def corrupt_file(site: str, path: str, start: int = 0, rank: Optional[int] = None,
                 end: Optional[int] = None) -> bool:
    """Host-side file corruption: for each matching corrupt_shard fault,
    XOR-flip one seeded contiguous run of bytes of `path` at an offset in
    [start, end) (default end: the file's end); the run is `fraction` of
    that span (at least one byte). Returns True when a byte flipped."""
    plan = active_plan()
    if plan is None:
        return False
    flipped = False
    for i, f in enumerate(plan.matching(site, "corrupt_shard")):
        if not _host_rank_matches(f, rank):
            continue
        size = os.path.getsize(path)
        if end is not None:
            size = min(size, int(end))
        span = size - int(start)
        if span <= 0:
            continue
        rng = np.random.default_rng((plan.site_seed(site), i, plan._next_draw(site)))
        run = max(1, int(span * min(f.fraction, 1.0)))
        off = int(start) + int(rng.integers(0, max(1, span - run + 1)))
        with open(path, "r+b") as fh:
            fh.seek(off)
            blk = fh.read(run)
            fh.seek(off)
            fh.write(bytes(b ^ 0xFF for b in blk))
        flipped = True
        _obs_event(site=site, action="corrupt_file", rank=f.rank,
                   path=os.path.basename(path), offset=off, bytes=run)
    return flipped


# -- tensor hooks ------------------------------------------------------

def corrupt_in_trace(site: str, x, rank):
    """NaN a seeded fraction of a float tensor on the fault's rank (`rank`
    is the caller's rank, an int or a tensor). Returns `x` itself when no
    matching fault is installed or `x` is not floating."""
    plan = active_plan()
    if plan is None:
        return x
    faults_ = plan.matching(site, "corrupt_shard")
    if not faults_ or not torch.is_floating_point(x):
        return x
    for i, f in enumerate(faults_):
        _obs_event(site=site, action="corrupt_trace", rank=f.rank, fraction=f.fraction)
        gen = torch.Generator(device=x.device)
        gen.manual_seed(plan.site_seed(site) * 1024 + i)
        hit = torch.rand(x.shape, generator=gen, device=x.device) < f.fraction
        if f.rank >= 0:
            hit = hit & torch.as_tensor(rank == f.rank, device=x.device)
        x = torch.where(hit, torch.tensor(float("nan"), dtype=x.dtype, device=x.device), x)
    return x


def drop_contribution(site: str, x, rank, identity):
    """Replace the fault's rank's contribution with the reduction
    identity (the contribution never arrives)."""
    plan = active_plan()
    if plan is None:
        return x
    for f in plan.matching(site, "drop_collective"):
        _obs_event(site=site, action="drop", rank=f.rank)
        dead = torch.as_tensor(True if f.rank < 0 else rank == f.rank, device=x.device)
        x = torch.where(dead, torch.full_like(x, identity), x)
    return x


def _render_sites_doc() -> str:
    """The docstring's site catalog, rendered from FAULT_SITES."""
    import textwrap

    out = []
    for site in known_sites():
        body = textwrap.fill(FAULT_SITES[site], width=70, initial_indent="      ",
                             subsequent_indent="      ")
        out.append(f"  {site}\n{body}")
    return "\n".join(out)


__doc__ = (__doc__ or "") + (
    "\nRegistered injection sites (rendered from FAULT_SITES):\n\n"
    + _render_sites_doc() + "\n"
)
