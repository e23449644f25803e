"""Deprecated aliases (counterpart of raft_tpu/sparse/selection.py, the
reference's sparse/selection/{knn,knn_graph,connect_components}.cuh
shims): `knn` lives in raft_tpu_torch.sparse.distance, the graph helpers
in raft_tpu_torch.sparse.neighbors."""

import warnings

warnings.warn(
    "raft_tpu_torch.sparse.selection is deprecated; use raft_tpu_torch.sparse.distance.knn"
    " and raft_tpu_torch.sparse.neighbors for the graph helpers",
    DeprecationWarning,
    stacklevel=2,
)

from raft_tpu_torch.sparse.distance import knn  # noqa: E402
from raft_tpu_torch.sparse.neighbors import (  # noqa: E402
    connect_components,
    cross_component_nn,
    knn_graph,
)

__all__ = ["knn", "knn_graph", "connect_components", "cross_component_nn"]
