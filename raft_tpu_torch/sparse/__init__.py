"""Sparse formats, ops, linear algebra, distances, neighbors and solvers
(counterpart of raft_tpu/sparse): the ported names of the JAX package's
`__all__`, in its order."""

from raft_tpu_torch.sparse.formats import (
    CooMatrix,
    CsrMatrix,
    coo_to_csr,
    csr_to_coo,
    dense_to_csr,
    dense_to_coo,
    csr_to_dense,
    coo_to_dense,
)
from raft_tpu_torch.sparse.ops import (
    coo_sort,
    coo_remove_zeros,
    max_duplicates,
    csr_row_slice,
    degree,
    csr_row_op,
)
from raft_tpu_torch.sparse import linalg
from raft_tpu_torch.sparse import distance
from raft_tpu_torch.sparse import neighbors
from raft_tpu_torch.sparse import solver

__all__ = [
    "CooMatrix",
    "CsrMatrix",
    "coo_to_csr",
    "csr_to_coo",
    "dense_to_csr",
    "dense_to_coo",
    "csr_to_dense",
    "coo_to_dense",
    "coo_sort",
    "coo_remove_zeros",
    "max_duplicates",
    "csr_row_slice",
    "degree",
    "csr_row_op",
    "linalg",
    "distance",
    "neighbors",
    "solver",
]
