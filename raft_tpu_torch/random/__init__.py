"""Random generation (counterpart of raft_tpu/random): the ported names of
the JAX package's `__all__`, in its order. The port's draws take a
`torch.Generator` where the JAX package takes its RNG state."""

from raft_tpu_torch.random.rng import sample_without_replacement
from raft_tpu_torch.random.make_blobs import make_blobs
from raft_tpu_torch.random.generators import make_regression, rmat

__all__ = [
    "make_regression",
    "rmat",
    "sample_without_replacement",
    "make_blobs",
]
