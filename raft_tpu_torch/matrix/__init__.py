"""Matrix operations (counterpart of raft_tpu/matrix; the reference's
`matrix/`): `select_k` and `scan_select_k` plus the gather / argmax /
slice / sort helpers, the JAX package's `__all__` in its order. The
helpers are thin tensor expressions; each takes array-likes and an
explicit `device` (a tensor keeps its own when `device` is None)."""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.core.validation import as_input as _t, as_tensor
from raft_tpu_torch.matrix.select_k import scan_select_k, select_k

__all__ = [
    "select_k",
    "scan_select_k",
    "gather",
    "gather_if",
    "scatter",
    "argmax",
    "argmin",
    "slice",
    "reverse",
    "linewise_op",
    "col_wise_sort",
    "norm_rows",
    "eye",
    "fill",
    "diagonal",
    "set_diagonal",
    "upper_triangular",
    "lower_triangular",
    "power",
    "sqrt",
    "reciprocal",
    "ratio",
    "sign_flip",
    "threshold",
    "copy",
]


def _torch_dtype(dtype) -> torch.dtype:
    if isinstance(dtype, torch.dtype):
        return dtype
    return torch.from_numpy(np.zeros(0, dtype)).dtype


def gather(matrix, indices, axis: int = 0, device=None) -> torch.Tensor:
    """Gather rows (matrix/gather.cuh)."""
    m = _t(matrix, device)
    idx = as_tensor(indices, m.device).long()
    out = torch.index_select(m, axis, idx.reshape(-1))
    return out.reshape(m.shape[:axis] + idx.shape + m.shape[axis + 1:])


def gather_if(matrix, indices, mask, fill_value=0.0, device=None) -> torch.Tensor:
    g = gather(matrix, indices, device=device)
    msk = as_tensor(mask, g.device).bool()
    return torch.where(msk[:, None] if g.ndim == 2 else msk, g,
                       torch.tensor(fill_value, dtype=g.dtype, device=g.device))


def scatter(matrix, indices, updates, device=None) -> torch.Tensor:
    """A copy of `matrix` with rows `indices` set to `updates`."""
    m = _t(matrix, device).clone()
    m[as_tensor(indices, m.device).long()] = as_tensor(updates, m.device).to(m.dtype)
    return m


def argmax(matrix, axis: int = 1, device=None) -> torch.Tensor:
    """Per-row argmax (matrix/argmax.cuh), the first on ties, int32."""
    return torch.argmax(_t(matrix, device), dim=axis).to(torch.int32)


def argmin(matrix, axis: int = 1, device=None) -> torch.Tensor:
    return torch.argmin(_t(matrix, device), dim=axis).to(torch.int32)


def slice(matrix, row_start: int, row_end: int, col_start: int = 0, col_end=None,
          device=None) -> torch.Tensor:
    """Submatrix copy (matrix/slice.cuh)."""
    m = _t(matrix, device)
    col_end = m.shape[1] if col_end is None else col_end
    return m[row_start:row_end, col_start:col_end].clone()


def reverse(matrix, axis: int = 0, device=None) -> torch.Tensor:
    return torch.flip(_t(matrix, device), dims=(axis,))


def linewise_op(matrix, vec, op, along_rows: bool = True, device=None) -> torch.Tensor:
    """Broadcast a vector op along rows / cols (matrix/linewise_op.cuh)."""
    m = _t(matrix, device)
    v = as_tensor(vec, m.device)
    return op(m, v[None, :] if along_rows else v[:, None])


def col_wise_sort(matrix, ascending: bool = True, device=None):
    """Sort each column (matrix/col_wise_sort.cuh): (sorted, int32
    indices); a stable ascending sort, flipped for descending."""
    m = _t(matrix, device)
    idx = torch.argsort(m, dim=0, stable=True)
    if not ascending:
        idx = torch.flip(idx, dims=(0,))
    return torch.gather(m, 0, idx), idx.to(torch.int32)


def norm_rows(matrix, ord: int = 2, device=None) -> torch.Tensor:
    """Row norms (matrix/norm.cuh)."""
    return torch.linalg.vector_norm(_t(matrix, device).float(), ord=ord, dim=1)


def eye(n: int, m=None, dtype=torch.float32, device=None) -> torch.Tensor:
    from raft_tpu_torch.core.config import resolve_device

    return torch.eye(n, n if m is None else m, dtype=_torch_dtype(dtype),
                     device=resolve_device(device))


def fill(shape, value, dtype=torch.float32, device=None) -> torch.Tensor:
    from raft_tpu_torch.core.config import resolve_device

    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    return torch.full(shape, value, dtype=_torch_dtype(dtype), device=resolve_device(device))


def diagonal(matrix, device=None) -> torch.Tensor:
    return torch.diagonal(_t(matrix, device)).clone()


def set_diagonal(matrix, vec, device=None) -> torch.Tensor:
    m = _t(matrix, device).clone()
    n = min(m.shape)
    idx = torch.arange(n, device=m.device)
    m[idx, idx] = as_tensor(vec, m.device)[:n].to(m.dtype)
    return m


def upper_triangular(matrix, device=None) -> torch.Tensor:
    return torch.triu(_t(matrix, device))


def lower_triangular(matrix, device=None) -> torch.Tensor:
    return torch.tril(_t(matrix, device))


def power(matrix, exponent, device=None) -> torch.Tensor:
    """Elementwise power (matrix/power.cuh)."""
    return torch.pow(_t(matrix, device), exponent)


def sqrt(matrix, device=None) -> torch.Tensor:
    """Elementwise sqrt (matrix/sqrt.cuh)."""
    return torch.sqrt(_t(matrix, device))


def reciprocal(matrix, scalar=1.0, thres: float = 0.0, device=None) -> torch.Tensor:
    """Guarded elementwise reciprocal: scalar / x where |x| > thres, else 0
    (matrix/reciprocal.cuh)."""
    m = _t(matrix, device)
    return torch.where(torch.abs(m) > thres, scalar / m, torch.zeros((), dtype=m.dtype,
                                                                     device=m.device))


def ratio(matrix, device=None) -> torch.Tensor:
    """Each element divided by the sum of all elements (matrix/ratio.cuh)."""
    m = _t(matrix, device)
    return m / torch.sum(m)


def sign_flip(matrix, device=None) -> torch.Tensor:
    """Flip the sign of each column so its max-|value| entry is positive
    (matrix/sign_flip.cuh; canonicalizes eigenvectors)."""
    m = _t(matrix, device)
    pivot = torch.gather(m, 0, torch.argmax(torch.abs(m), dim=0)[None, :])
    return m * torch.where(pivot < 0, -1.0, 1.0).to(m.dtype)


def threshold(matrix, thres, fill_value=0.0, device=None) -> torch.Tensor:
    """Entries below `thres` set to `fill_value` (matrix/threshold.cuh)."""
    m = _t(matrix, device)
    return torch.where(m < thres, torch.tensor(fill_value, dtype=m.dtype, device=m.device), m)


def copy(matrix, device=None) -> torch.Tensor:
    """Out-of-place copy (matrix/copy.cuh)."""
    return _t(matrix, device).clone()
