"""Random sampling (counterpart of raft_tpu/random): the ported names of
the JAX package's `__all__`, in its order. The port's sampling takes a
`torch.Generator` where the JAX package takes its RNG state."""

from raft_tpu_torch.random.rng import sample_without_replacement

__all__ = [
    "sample_without_replacement",
]
