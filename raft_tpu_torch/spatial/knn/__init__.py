"""Deprecated aliases of raft_tpu_torch.neighbors (counterpart of
raft_tpu/spatial/knn; the reference's spatial/knn/knn.cuh deprecation
shims kept for cuML)."""

import warnings

warnings.warn(
    "raft_tpu_torch.spatial.knn is deprecated; use raft_tpu_torch.neighbors",
    DeprecationWarning,
    stacklevel=2,
)

from raft_tpu_torch.neighbors import ball_cover, brute_force, ivf_flat, ivf_pq  # noqa: E402
from raft_tpu_torch.neighbors.brute_force import knn, knn_merge_parts  # noqa: E402
from raft_tpu_torch.neighbors.epsilon_neighborhood import eps_neighbors  # noqa: E402

__all__ = [
    "ball_cover",
    "brute_force",
    "ivf_flat",
    "ivf_pq",
    "knn",
    "knn_merge_parts",
    "eps_neighbors",
]
