"""Nearest-neighbour search (counterpart of raft_tpu/neighbors): the JAX
package's `__all__`, in its order. `refine` is the function, as in the
JAX package."""

from raft_tpu_torch.neighbors import brute_force
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.neighbors import ivf_pq
from raft_tpu_torch.neighbors import ivf_rabitq
from raft_tpu_torch.neighbors import quantizer
from raft_tpu_torch.neighbors import ball_cover
from raft_tpu_torch.neighbors.refine import refine
from raft_tpu_torch.neighbors import batch_loader
from raft_tpu_torch.neighbors.batch_loader import BatchLoadIterator
from raft_tpu_torch.neighbors.epsilon_neighborhood import eps_neighbors
from raft_tpu_torch.neighbors.ann_types import IndexParamsBase, SearchParamsBase

__all__ = [
    "brute_force",
    "batch_loader",
    "BatchLoadIterator",
    "ivf_flat",
    "ivf_pq",
    "ivf_rabitq",
    "quantizer",
    "ball_cover",
    "refine",
    "eps_neighbors",
    "IndexParamsBase",
    "SearchParamsBase",
]
