"""Nearest-neighbour search (counterpart of raft_tpu/neighbors): the
ported names of the JAX package's `__all__`, in its order. `refine` is
the function, as in the JAX package."""

from raft_tpu_torch.neighbors import brute_force
from raft_tpu_torch.neighbors import ivf_flat
from raft_tpu_torch.neighbors import ivf_pq
from raft_tpu_torch.neighbors import ivf_rabitq
from raft_tpu_torch.neighbors import quantizer
from raft_tpu_torch.neighbors.refine import refine

__all__ = [
    "brute_force",
    "ivf_flat",
    "ivf_pq",
    "ivf_rabitq",
    "quantizer",
    "refine",
]
