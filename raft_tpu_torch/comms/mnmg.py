"""Multi-node multi-device (MNMG) algorithms over the comms layer
(counterpart of raft_tpu/comms/mnmg.py).

Reference parity: RAFT's MNMG story (SURVEY §2.15 / §3.4 / §5.7-5.8):
algorithms written against `handle.get_comms()`; the dataset sharded over
the workers; k-means wraps each iteration in an allreduce of partial
sums; search does a shard-local top-k, then merges (knn_merge_parts).
Every function takes a `Comms` session; host arrays or tensors are
sharded row-wise (equal shards, padded) across the ranks.

This module is the stable public surface re-exporting the entry points
of the modules split by concern, in the JAX package's order:

  mnmg_common      sharding layouts, prefilter bits, the body cache
  mnmg_merge       top-k merge schedules + query-mode resolution
  mnmg_kmeans      distributed k-means (driver-sharded + *_local)
  mnmg_knn         distributed brute-force kNN
  mnmg_ivf_build   the distributed IVF index types, builds, extends, bridge
  mnmg_ckpt        sharded and single-file checkpoints
  mnmg_rabitq      the distributed IVF-RaBitQ driver
  mnmg_ivf_search  the distributed searches (engines, refine, prefilters)
  replication      ring placement of shard replicas, mirrors, failover
  recovery         repair, rejoin and heal
"""

from raft_tpu_torch.comms.mnmg_common import (  # noqa: F401
    _cached_wrapper,
    _distributed_id_bound,
    _knn_prefilter_words,
    _local_layout,
    _metric_name,
    _pack_local,
    _pad_queries,
    _ranks_by_proc,
    _replicated_filter_bits,
    _shard_filtered,
    _shard_rows,
)
from raft_tpu_torch.comms.mnmg_merge import (  # noqa: F401
    _merge_local_topk,
    _merge_local_topk_allgather,
    _merge_local_topk_scatter,
    _merge_local_topk_tournament,
    _pack_vi,
    _replicated_merge_schedule,
    _resolve_query_mode,
)
from raft_tpu_torch.comms.mnmg_kmeans import (  # noqa: F401
    _kmeans_fit_sharded,
    _spmd_predict,
    kmeans_fit,
    kmeans_fit_local,
    kmeans_predict,
    kmeans_predict_local,
)
from raft_tpu_torch.comms.mnmg_knn import (  # noqa: F401
    _knn_sharded,
    knn,
    knn_local,
)
from raft_tpu_torch.comms.mnmg_ivf_build import (  # noqa: F401
    DistributedIvfFlat,
    DistributedIvfPq,
    _place_rank_major,
    _spmd_label_encode,
    distribute_index,
    ivf_flat_build,
    ivf_flat_build_local,
    ivf_flat_extend,
    ivf_flat_extend_local,
    ivf_pq_build,
    ivf_pq_build_local,
    ivf_pq_extend,
    ivf_pq_extend_local,
)
from raft_tpu_torch.comms.mnmg_ckpt import (  # noqa: F401
    ivf_flat_load,
    ivf_flat_save,
    ivf_flat_save_local,
    ivf_pq_load,
    ivf_pq_save,
    ivf_pq_save_local,
    ivf_rabitq_load,
    ivf_rabitq_save,
)
from raft_tpu_torch.comms.mnmg_rabitq import (  # noqa: F401
    DistributedIvfRabitq,
    ivf_rabitq_build,
    ivf_rabitq_search,
)
from raft_tpu_torch.comms.mnmg_ivf_search import (  # noqa: F401
    _build_distributed_recon,
    _refine_layout,
    ivf_flat_search,
    ivf_pq_search,
)
from raft_tpu_torch.comms.replication import (  # noqa: F401
    ReplicaPlacement,
    ShardReplicas,
    failover_view,
    replicate_index,
)
from raft_tpu_torch.comms.recovery import (  # noqa: F401
    RecoveryError,
    heal,
    rank_rejoin,
    repair,
)
