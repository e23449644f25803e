"""Dense linear algebra primitives (counterpart of raft_tpu/linalg; the
reference's `linalg/`): the JAX package's `__all__`, in its order.
`lanczos` resolves lazily (PEP 562) to `sparse.solver.lanczos`, as the
reference's linalg/lanczos.cuh is a shim over the sparse solver."""

from raft_tpu_torch.linalg.blas import gemm, gemv, axpy, dot, transpose
from raft_tpu_torch.linalg.solvers import (
    eig_dc,
    eigh,
    svd,
    rsvd,
    qr,
    lstsq,
    cholesky,
    cholesky_r1_update,
)
from raft_tpu_torch.linalg.elementwise import (
    unary_op,
    binary_op,
    ternary_op,
    map_op,
    eltwise_add,
    eltwise_sub,
    eltwise_multiply,
    eltwise_divide,
    eltwise_power,
    eltwise_sqrt,
    scalar_add,
    scalar_multiply,
)
from raft_tpu_torch.linalg.reductions import (
    reduce,
    coalesced_reduction,
    strided_reduction,
    map_reduce,
    norm,
    row_norm,
    col_norm,
    normalize,
    mean_squared_error,
    reduce_rows_by_key,
    reduce_cols_by_key,
    matrix_vector_op,
)

__all__ = [
    "gemm", "gemv", "axpy", "dot", "transpose",
    "eig_dc", "eigh", "svd", "rsvd", "qr", "lstsq", "cholesky",
    "cholesky_r1_update", "lanczos",
    "unary_op", "binary_op", "ternary_op", "map_op",
    "eltwise_add", "eltwise_sub", "eltwise_multiply", "eltwise_divide",
    "eltwise_power", "eltwise_sqrt", "scalar_add", "scalar_multiply",
    "reduce", "coalesced_reduction", "strided_reduction", "map_reduce",
    "norm", "row_norm", "col_norm", "normalize", "mean_squared_error",
    "reduce_rows_by_key", "reduce_cols_by_key", "matrix_vector_op",
]


def __getattr__(name):
    # resolved lazily so `import raft_tpu_torch.linalg` does not load the
    # sparse package
    if name == "lanczos":
        from raft_tpu_torch.sparse.solver import lanczos

        return lanczos
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(list(globals()) + __all__))
