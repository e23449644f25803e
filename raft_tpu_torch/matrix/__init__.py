"""Matrix operations (counterpart of raft_tpu/matrix): the ported names
of the JAX package's `__all__`, in its order."""

from raft_tpu_torch.matrix.select_k import scan_select_k, select_k

__all__ = [
    "select_k",
    "scan_select_k",
]
