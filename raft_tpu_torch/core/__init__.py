"""Core runtime (counterpart of raft_tpu/core): the ported names of the
JAX package's `__all__`, in its order."""

from raft_tpu_torch.core import faults
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.core.serialize import deserialize_arrays, serialize_arrays
from raft_tpu_torch.core.validation import check_matrix

__all__ = [
    "Bitset",
    "check_matrix",
    "serialize_arrays",
    "deserialize_arrays",
    "faults",
]
