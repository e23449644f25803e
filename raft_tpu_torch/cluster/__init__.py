"""Clustering (counterpart of raft_tpu/cluster): the ported names of the
JAX package's `__all__`, in its order."""

from raft_tpu_torch.cluster import kmeans
from raft_tpu_torch.cluster import kmeans_balanced
from raft_tpu_torch.cluster.kmeans import KMeansParams
from raft_tpu_torch.cluster.single_linkage import single_linkage, SingleLinkageOutput

__all__ = [
    "kmeans",
    "kmeans_balanced",
    "KMeansParams",
    "single_linkage",
    "SingleLinkageOutput",
]
