"""Pairwise distances, fused 1-NN, masked NN and kernel (Gram) matrices
(counterpart of raft_tpu/distance): the JAX package's `__all__`, in its
order."""

from raft_tpu_torch.distance.distance_types import (
    DistanceType,
    DISTANCE_TYPES,
    resolve_metric,
)
from raft_tpu_torch.distance.pairwise import pairwise_distance, distance, set_matmul_precision
from raft_tpu_torch.distance.fused_l2_nn import fused_l2_nn, fused_l2_nn_argmin
from raft_tpu_torch.distance.masked_nn import masked_l2_nn
from raft_tpu_torch.distance.kernels import (
    KernelType,
    KernelParams,
    GramMatrix,
    kernel_factory,
    gram_matrix,
)

__all__ = [
    "DistanceType",
    "DISTANCE_TYPES",
    "resolve_metric",
    "pairwise_distance",
    "distance",
    "set_matmul_precision",
    "fused_l2_nn",
    "fused_l2_nn_argmin",
    "masked_l2_nn",
    "KernelType",
    "KernelParams",
    "GramMatrix",
    "kernel_factory",
    "gram_matrix",
]
