"""Distributed comms and the MNMG algorithms (counterpart of
raft_tpu/comms; `cpp/include/raft/comms/` + `python/raft-dask/`, SURVEY
§2.8, §2.15, §3.5, §5.8): the names of the JAX package's `__all__`, in
its order."""

from raft_tpu_torch.comms.comms import (
    Comms,
    AxisComms,
    op_t,
    datatype_t,
    init_comms,
    local_handle,
    bootstrap_multihost,
)
from raft_tpu_torch.comms import quantized
from raft_tpu_torch.comms import resilience
from raft_tpu_torch.comms.resilience import (
    DegradedSearchResult,
    HealthCheckTimeout,
    RankHealth,
    RetryExhausted,
    health_barrier,
    probe_health,
    rehydrate,
    retry_with_backoff,
)
from raft_tpu_torch.comms import mnmg
from raft_tpu_torch.comms import replication
from raft_tpu_torch.comms import recovery
from raft_tpu_torch.comms.replication import ReplicaPlacement, replicate_index
from raft_tpu_torch.comms.recovery import RecoveryError, heal, rank_rejoin, repair

__all__ = [
    "Comms",
    "AxisComms",
    "op_t",
    "datatype_t",
    "init_comms",
    "local_handle",
    "bootstrap_multihost",
    "quantized",
    "mnmg",
    "resilience",
    "replication",
    "recovery",
    "DegradedSearchResult",
    "HealthCheckTimeout",
    "RankHealth",
    "RecoveryError",
    "ReplicaPlacement",
    "RetryExhausted",
    "health_barrier",
    "heal",
    "probe_health",
    "rank_rejoin",
    "rehydrate",
    "repair",
    "replicate_index",
    "retry_with_backoff",
]
