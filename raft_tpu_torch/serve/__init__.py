"""Online vector-search serving (counterpart of raft_tpu/serve):
dynamic micro-batching, admission control, and latency/QPS metrics over
any built raft_tpu_torch index, on the index's own device.

The subsystem between the kernels and real traffic (no RAFT analogue —
the reference stops at library calls): `SearchServer` coalesces
per-caller `submit(queries, k)` futures into shape-bucketed device
batches (`batcher`), sheds and degrades load before it wastes device
time (`admission`), and accounts for every request (`metrics`).

    from raft_tpu_torch import serve

    with serve.SearchServer(index, serve.ServerConfig(warmup_k=10)) as s:
        reply = s.submit(queries, k=10).result(timeout=1.0)
"""

from raft_tpu_torch.serve.admission import (
    AdmissionConfig,
    AdmissionController,
    DeadlineExceeded,
    RejectedError,
    ServerClosed,
)
from raft_tpu_torch.serve.batcher import (
    MicroBatcher,
    PendingResult,
    SearchReply,
    bucket_for,
)
from raft_tpu_torch.serve.engine import (
    BruteForceSearcher,
    IvfFlatSearcher,
    IvfPqSearcher,
    IvfRabitqSearcher,
    MnmgSearcher,
    Searcher,
    SearchServer,
    ServerConfig,
    as_searcher,
)
from raft_tpu_torch.serve.metrics import ServerMetrics

__all__ = [
    "AdmissionConfig",
    "AdmissionController",
    "BruteForceSearcher",
    "DeadlineExceeded",
    "IvfFlatSearcher",
    "IvfPqSearcher",
    "IvfRabitqSearcher",
    "MicroBatcher",
    "MnmgSearcher",
    "PendingResult",
    "RejectedError",
    "SearchReply",
    "Searcher",
    "SearchServer",
    "ServerClosed",
    "ServerConfig",
    "ServerMetrics",
    "as_searcher",
    "bucket_for",
]
