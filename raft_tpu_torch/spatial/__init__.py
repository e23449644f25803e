"""Legacy spatial namespace (counterpart of raft_tpu/spatial; the
reference's `raft/spatial/`): `spatial.knn` forwards to
`raft_tpu_torch.neighbors` with a DeprecationWarning on import."""

from raft_tpu_torch.spatial import knn

__all__ = ["knn"]
