"""THREAD_ROOTS: the machine-readable registry of every thread entry
point in the port (counterpart of raft_tpu/core/threads.py) — the
concurrency counterpart of ``core/faults.FAULT_SITES``.

A *thread root* is a function handed to another execution context:
``threading.Thread(target=...)`` spawns, tasks submitted to a thread
pool executor, event-bus fan-out callbacks (which run inline on
whatever thread published), Prometheus collector callbacks (run on the
scraping thread), ``weakref.finalize`` callbacks (the GC/finalizer
context), and installed signal handlers (re-entrant on the main thread
at arbitrary bytecode boundaries — a concurrency context for data-race
purposes even without a second OS thread).

Keys are scope qnames — ``<repo-relative path>::<qualified name>`` with
nested defs dot-joined (``Watchdog.run.worker`` is the ``worker`` def
inside ``Watchdog.run``). The JAX package's roots each have their
counterpart here under the port's path. The port adds two pools the
JAX package does not have: the in-process comms world runs each rank on
a thread of its session's pool (``Comms._run_ranks.rank_main``), and the
CRC-32C row hasher spreads its tiles over a module pool
(``crc32c_rows.tile``). The JAX registry's
``bench/bench_serve.py::main.client`` (the serving benchmark's client
threads) has no counterpart until the port has a benchmark.

The contract holds both ways (tests/test_torch_threads.py walks the
package's syntax trees): every spawn / registration site resolves to a
registered root, and every registered root is still found at a site.

Runtime code may import :data:`THREAD_ROOTS` freely (it is plain data),
e.g. to label crash dumps, but nothing requires it.
"""

from __future__ import annotations

from typing import Dict

#: registered thread entry points: scope qname -> one-line description
THREAD_ROOTS: Dict[str, str] = {
    "raft_tpu_torch/serve/engine.py::SearchServer._run":
        "serve worker loop: collect/execute batches, between-batch "
        "mutation drain + healing + integrity scrub",
    "raft_tpu_torch/jobs/watchdog.py::Watchdog.run.worker":
        "watchdog stage thread: runs one supervised stage body while "
        "the calling thread monitors heartbeats",
    "raft_tpu_torch/jobs/watchdog.py::run_supervised.pump":
        "supervisor stdout pump: drains the child process pipe so the "
        "child never blocks on a full buffer",
    "raft_tpu_torch/jobs/runner.py::Job.request_preempt":
        "SIGTERM handler (via lambda trampoline): flips the preempt "
        "event re-entrantly on the main thread",
    "raft_tpu_torch/obs/flight.py::FlightRecorder._on_event":
        "event-bus fan-out: appends to the flight ring on whatever "
        "thread published the event",
    "raft_tpu_torch/obs/flight.py::install_sigterm._on_sigterm":
        "SIGTERM handler: dumps the flight recorder before chaining to "
        "the previous handler",
    "raft_tpu_torch/obs/spans.py::SpanCapture._on_event":
        "event-bus fan-out: aggregates span events on the publishing "
        "thread",
    "raft_tpu_torch/serve/metrics.py::ServerMetrics.__init__._collect":
        "Prometheus collector callback: snapshots server metrics on "
        "the scraping thread",
    "raft_tpu_torch/obs/registry.py::Registry.remove_collector":
        "weakref.finalize callback: detaches a dead collector on the "
        "GC/finalizer context",
    "raft_tpu_torch/comms/comms.py::Comms._run_ranks.rank_main":
        "in-process comms rank: one rank's SPMD body on a thread of the "
        "session's rank pool (sets its CUDA device first)",
    "raft_tpu_torch/core/serialize.py::crc32c_rows.tile":
        "CRC-32C tile task: hashes one tile of rows on a thread of the "
        "module's hashing pool",
}
