"""Deprecated alias of raft_tpu_torch.cluster.single_linkage (counterpart
of raft_tpu/sparse/hierarchy.py, the reference's
sparse/hierarchy/single_linkage.cuh forwarding shim)."""

import warnings

warnings.warn(
    "raft_tpu_torch.sparse.hierarchy is deprecated; use raft_tpu_torch.cluster.single_linkage",
    DeprecationWarning,
    stacklevel=2,
)

from raft_tpu_torch.cluster.single_linkage import SingleLinkageOutput, single_linkage  # noqa: E402

__all__ = ["SingleLinkageOutput", "single_linkage"]
