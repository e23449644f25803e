"""raft_tpu_torch.jobs — durable, resumable job running for long work
(counterpart of raft_tpu/jobs).

Long streaming builds and bench sessions must survive SIGTERM, SIGKILL,
hung children and stalled device waits. This subpackage turns the
fault-injection and replication/recovery machinery into survivable
long-running work:

- `JobDir` (jobs.jobdir): one job's durable directory — CRC-32C-
  verified artifacts, an append-only stage manifest with input
  fingerprints + provenance, per-stage scratch for intra-stage
  checkpoints. Its files are byte-compatible with the JAX package's.
- `Job` (jobs.runner): a named DAG of stages; re-running skips
  completed stages and resumes the first incomplete one. SIGTERM (or
  an injected ``job.preempt`` fault) is a graceful suspend
  (`JobPreempted`), not a failure.
- `Watchdog` / `run_supervised` (jobs.watchdog): heartbeat + wall-clock
  supervision; a stalled stage or silent child is killed as a typed
  `StageTimeout` and retried through the seeded
  `resilience.retry_with_backoff`.
- streaming helpers (jobs.streaming): batch-boundary checkpoints for
  `FileBatchLoader`-driven IVF-Flat/PQ/RaBitQ builds (SIGKILL
  mid-stream resumes to a bit-identical index), chunked resumable
  dataset synthesis, `mnmg_ckpt`-backed distributed build stages
  resuming through the `rehydrate` path, crash-atomic online mutation
  stages (`resumable_mutate`) and cursor-checkpointed integrity sweeps
  (`resumable_scrub`).

Quickstart::

    from raft_tpu_torch import jobs

    job = jobs.Job("my_build", "/data/jobs/my_build")

    @job.stage("make_data", inputs={"rows": N})
    def make_data(ctx): ...

    @job.stage("train", deps=("make_data",), retries=2,
               stall_timeout_s=600)
    def train(ctx): ...

    job.run()   # killed? run it again — completed stages skip
"""

from raft_tpu_torch.jobs.jobdir import JobDir, fingerprint_of
from raft_tpu_torch.jobs.runner import (
    Job,
    JobPreempted,
    StageContext,
    StageFailed,
    StageSpec,
)
from raft_tpu_torch.jobs.streaming import (
    STREAM_KINDS,
    checkpointed_mnmg_build,
    resumable_extend_from_file,
    resumable_extend_local_from_file,
    resumable_mutate,
    resumable_scrub,
    resumable_write_npy,
)
from raft_tpu_torch.jobs.watchdog import (
    Heartbeat,
    StageCancelled,
    StageTimeout,
    Watchdog,
    run_supervised,
)

__all__ = [
    "Heartbeat",
    "Job",
    "JobDir",
    "JobPreempted",
    "STREAM_KINDS",
    "StageCancelled",
    "StageContext",
    "StageFailed",
    "StageSpec",
    "StageTimeout",
    "Watchdog",
    "checkpointed_mnmg_build",
    "fingerprint_of",
    "resumable_extend_from_file",
    "resumable_extend_local_from_file",
    "resumable_mutate",
    "resumable_scrub",
    "resumable_write_npy",
    "run_supervised",
]
