"""The durable, resumable job runner: a `Job` is a named DAG of stages
(counterpart of raft_tpu/jobs/runner.py).

Each stage runs once, commits its artifacts + a manifest line into the
job's `JobDir`, and is SKIPPED by every future run whose fingerprint
(stage name + declared inputs + upstream fingerprints) still matches —
so rerunning a killed job resumes at the first incomplete stage instead
of row zero. Intra-stage resume (streaming builds checkpointing at
batch boundaries) lives in `jobs.streaming`; the runner provides the
scratch dir and clears it whenever a stage starts over with a CHANGED
fingerprint (a stale cursor must never resume into new inputs).

Supervision: every stage runs under a `Watchdog` (heartbeat +
wall-clock deadline); a stall-kill surfaces as a typed `StageTimeout`
and is retried through the seeded `resilience.retry_with_backoff`
(`FaultInjected` transients retry the same way). Preemption is a
first-class outcome, not a failure: SIGTERM (or an injected
``job.preempt`` fault) sets a flag the runner checks between stages and
streaming loops check between batches; the in-flight checkpoint state
is already durable, so the job raises `JobPreempted` — a graceful
suspend — and the next run resumes.

Observability: every stage transition lands a kind="job" event
(start/skip/resume/commit/failed/preempt) and runs inside an obs span
``job.<job>.<stage>``, so `python -m raft_tpu_torch.obs.report` renders a job
timeline for any instrumented run.
"""

from __future__ import annotations

import dataclasses
import os
import signal
import threading
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from raft_tpu_torch import obs
from raft_tpu_torch.core import faults
from raft_tpu_torch.core.logger import logger
from raft_tpu_torch.comms.resilience import retry_with_backoff
from raft_tpu_torch.jobs.jobdir import JobDir, fingerprint_of
from raft_tpu_torch.jobs.watchdog import Heartbeat, StageTimeout, Watchdog

PREEMPT_SITE = "job.preempt"


class JobPreempted(RuntimeError):
    """The job suspended gracefully (SIGTERM or injected preempt): every
    completed stage is committed, the interrupted stage's intra-stage
    checkpoints are durable, and re-running the same job resumes. Not a
    failure — callers typically exit with a distinct code and let the
    scheduler restart them."""


class StageFailed(RuntimeError):
    """A stage exhausted its retry budget (or raised a non-retryable
    error). Chains the underlying cause as `__cause__`."""


@dataclasses.dataclass
class StageSpec:
    """One node of the DAG. `fn(ctx)` does the work; `inputs` is the
    JSON-able parameter dict that joins the fingerprint (geometry,
    seeds, source paths — anything whose change must re-run the
    stage)."""

    name: str
    fn: Callable[["StageContext"], Optional[dict]]
    deps: Tuple[str, ...] = ()
    inputs: Optional[dict] = None
    retries: int = 0
    stall_timeout_s: Optional[float] = None
    deadline_s: Optional[float] = None


class StageContext:
    """What a stage fn sees: its JobDir paths, liveness + preempt hooks,
    and upstream results."""

    def __init__(self, job: "Job", spec: StageSpec, fingerprint: str,
                 heartbeat: Heartbeat):
        self.job = job
        self.jobdir = job.jobdir
        self.stage = spec.name
        self.fingerprint = fingerprint
        self._heartbeat = heartbeat

    def heartbeat(self) -> None:
        """Beat the watchdog; call at least once per `stall_timeout_s`
        of work (streaming helpers take this as their `heartbeat=`)."""
        self._heartbeat.beat()

    def preempt_point(self) -> None:
        """Honor a pending preemption at a safe point (durable state
        just committed). Streaming helpers call this at batch
        boundaries; raises `JobPreempted` when one is pending."""
        self.job.check_preempt()

    def scratch(self) -> str:
        return self.jobdir.scratch(self.stage)

    def artifact_path(self, name: str = "artifact") -> str:
        return self.jobdir.artifact_path(self.stage, name)

    def dep_meta(self, stage: str) -> dict:
        """The committed `meta` dict of a dependency stage."""
        return dict(self.job.results.get(stage) or {})

    def dep_artifact(self, stage: str, name: str = "artifact") -> str:
        """Absolute path of a dependency's committed artifact."""
        return self.jobdir.artifact_path(stage, name)


def _git_sha(repo_dir: Optional[str] = None) -> str:
    from raft_tpu_torch.obs.ledger import git_sha

    return git_sha(repo_dir)


class Job:
    """A named DAG of stages over one `JobDir`; see module docstring.

    Build with `add_stage` (or the `stage` decorator), then `run()`.
    `results` maps stage name -> committed meta dict after a run,
    whether the stage ran or was skipped."""

    def __init__(self, name: str, jobdir, repo_dir: Optional[str] = None):
        self.name = str(name)
        self.jobdir = jobdir if isinstance(jobdir, JobDir) else JobDir(jobdir)
        self.repo_dir = repo_dir
        self._stages: Dict[str, StageSpec] = {}
        self._order: List[str] = []
        self.results: Dict[str, dict] = {}
        self.statuses: Dict[str, str] = {}
        self._preempt = threading.Event()

    # -- building ------------------------------------------------------
    def add_stage(self, name: str,
                  fn: Callable[[StageContext], Optional[dict]],
                  deps: Sequence[str] = (), inputs: Optional[dict] = None,
                  retries: int = 0, stall_timeout_s: Optional[float] = None,
                  deadline_s: Optional[float] = None) -> StageSpec:
        if name in self._stages:
            raise ValueError(f"duplicate stage {name!r}")
        for d in deps:
            if d not in self._stages:
                raise ValueError(
                    f"stage {name!r} depends on unknown stage {d!r} — "
                    f"declare stages in dependency order")
        spec = StageSpec(name, fn, tuple(deps), inputs, int(retries),
                         stall_timeout_s, deadline_s)
        self._stages[name] = spec
        self._order.append(name)
        return spec

    def stage(self, name: str, **kwargs):
        """Decorator form of `add_stage`."""

        def deco(fn):
            self.add_stage(name, fn, **kwargs)
            return fn

        return deco

    # -- fingerprints --------------------------------------------------
    def fingerprint(self, name: str) -> str:
        spec = self._stages[name]
        return fingerprint_of({
            "stage": spec.name,
            "inputs": spec.inputs or {},
            "deps": {d: self.fingerprint(d) for d in spec.deps},
        })

    def _provenance(self) -> dict:
        import time as _time

        plan = faults.active_plan()
        return {
            "job": self.name,
            "git_sha": _git_sha(self.repo_dir),
            "fault_plan": (fingerprint_of(repr(plan.trace_key()))
                           if plan is not None and plan.faults else None),
            "utc": _time.strftime("%Y-%m-%dT%H:%M:%SZ", _time.gmtime()),
        }

    # -- preemption ----------------------------------------------------
    def request_preempt(self) -> None:
        """Ask the job to suspend at the next safe point (the SIGTERM
        handler's body; safe from any thread/signal context)."""
        self._preempt.set()

    def check_preempt(self) -> None:
        """Raise `JobPreempted` when a preemption is pending — called
        between stages and (via `StageContext.preempt_point`) at
        streaming batch boundaries. Also the injected-chaos hook: a
        flaky fault at ``job.preempt`` simulates the SIGTERM."""
        if not self._preempt.is_set():
            try:
                faults.fault_point(PREEMPT_SITE)
            except faults.FaultInjected:
                self._preempt.set()
        self._raise_pending()

    def _raise_pending(self) -> None:
        if self._preempt.is_set():
            obs.event("job", job=self.name, action="preempt")
            raise JobPreempted(
                f"job {self.name!r} preempted — durable state committed, "
                f"re-run to resume")

    # -- running -------------------------------------------------------
    def run(self, resume: bool = True,
            continue_on_error: bool = False) -> Dict[str, str]:
        """Run the DAG in declaration (= dependency) order. Returns
        {stage: status}, statuses in {"skipped", "ran", "failed",
        "blocked", "preempted"}. A failed stage raises `StageFailed`
        immediately unless `continue_on_error` (the independent-suites
        queue mode): then the failure is recorded, its dependents go
        "blocked", the sweep continues, and callers inspect the
        returned statuses. `JobPreempted` always propagates — a suspend
        must reach the caller's exit path."""
        self.statuses = {}
        old_handler = None
        handler_installed = False
        if threading.current_thread() is threading.main_thread():
            try:
                old_handler = signal.signal(
                    signal.SIGTERM,
                    lambda signum, frame: self.request_preempt())
                handler_installed = True
            except ValueError:
                pass  # non-main interpreter contexts
        try:
            for name in self._order:
                self.check_preempt()
                spec = self._stages[name]
                if any(self.statuses.get(d) in ("failed", "blocked")
                       for d in spec.deps):
                    self.statuses[name] = "blocked"
                    obs.event("job", job=self.name, stage=name,
                              action="blocked")
                    continue
                fp = self.fingerprint(name)
                entry = (self.jobdir.is_complete(name, fp)
                         if resume else None)
                if entry is not None:
                    self.results[name] = entry.get("meta") or {}
                    self.statuses[name] = "skipped"
                    obs.event("job", job=self.name, stage=name,
                              action="skip", fingerprint=fp)
                    logger.info("job %s: stage %s complete — skipping",
                                self.name, name)
                    continue
                try:
                    self._run_stage(spec, fp)
                    self.statuses[name] = "ran"
                except JobPreempted:
                    self.statuses[name] = "preempted"
                    raise
                except Exception as e:
                    self.statuses[name] = "failed"
                    obs.event("job", job=self.name, stage=name,
                              action="failed", error=repr(e)[:200])
                    if not continue_on_error:
                        raise StageFailed(
                            f"job {self.name!r} stage {name!r} failed: {e}"
                        ) from e
                    logger.warning("job %s: stage %s failed (%s); "
                                   "continuing", self.name, name, e)
            # a preempt requested DURING the final stage (SIGTERM, or a
            # bench's --stop-after on the last stage) has no next-stage
            # check to land on — honor it here so the caller still exits
            # through its suspend path. No fault_point: an injected
            # preempt after all stages committed would prove nothing.
            self._raise_pending()
            return dict(self.statuses)
        finally:
            if handler_installed:
                signal.signal(signal.SIGTERM, old_handler)  # raftlint: disable=thread-root-unknown  -- restores the handler captured at install; not a new thread entry point

    def _run_stage(self, spec: StageSpec, fp: str) -> None:
        jd = self.jobdir
        prior = jd.committed(spec.name)
        if prior is not None and prior.get("fingerprint") != fp:
            # starting OVER, not resuming: a stale intra-stage cursor
            # from different inputs must never carry into this attempt —
            # and neither may a stale artifact, which auto-discovery
            # would re-commit under the new fingerprint
            jd.clear_scratch(spec.name)
            jd.clear_artifacts(spec.name)
            obs.event("job", job=self.name, stage=spec.name,
                      action="invalidate", was=prior.get("fingerprint"),
                      now=fp)
        resumable = os.path.isdir(
            os.path.join(jd.root, "scratch", spec.name)) and bool(
            os.listdir(jd.scratch(spec.name)))
        obs.event("job", job=self.name, stage=spec.name,
                  action=("resume" if resumable else "start"),
                  fingerprint=fp)
        hb = Heartbeat(jd.heartbeat_path)
        ctx = StageContext(self, spec, fp, hb)
        dog = Watchdog(hb, stall_timeout_s=spec.stall_timeout_s,
                       deadline_s=spec.deadline_s)

        def attempt():
            with obs.span(f"job.{self.name}.{spec.name}"):
                return dog.run(lambda: spec.fn(ctx),
                               describe=f"{self.name}.{spec.name}")

        if spec.retries > 0:
            meta = retry_with_backoff(
                attempt, max_retries=spec.retries,
                retry_on=(StageTimeout, faults.FaultInjected),
                describe=f"job.{self.name}.{spec.name}",
            )
        else:
            meta = attempt()
        meta = meta if isinstance(meta, dict) else {}
        arts = meta.pop("_artifacts", None)
        if arts is None:
            default = jd.artifact_path(spec.name)
            arts = ({"artifact": default} if os.path.exists(default)
                    else {})
        jd.commit(spec.name, fp, artifacts=arts, meta=meta,
                  provenance=self._provenance())
        # intra-stage cursors/checkpoints are superseded by the commit —
        # a committed stage never re-enters them, and at 100M scale the
        # final streaming checkpoint is a full second copy of the index
        jd.clear_scratch(spec.name)
        self.results[spec.name] = meta
        obs.event("job", job=self.name, stage=spec.name, action="commit",
                  fingerprint=fp)
