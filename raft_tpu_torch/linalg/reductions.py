"""Reductions (counterpart of raft_tpu/linalg/reductions.py;
linalg/reduce.cuh, coalesced_reduction.cuh, strided_reduction.cuh,
map_reduce.cuh, norm.cuh, normalize.cuh, mean_squared_error.cuh,
reduce_rows_by_key.cuh, reduce_cols_by_key.cuh, matrix_vector_op.cuh).

The reference's reductions take a main op (per element), a reduce op
and a final op (epilogue), kept here as callables with the same
defaults. The by-key sums are `index_add_` segment sums in a fixed
order (no float atomics on the CPU; on the card `index_add_` adds in an
unspecified order, within f32 rounding of the JAX segment_sum).
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from raft_tpu_torch.core.validation import as_input, as_tensor
from raft_tpu_torch.stats.descriptive import _f32


def _identity(x):
    return x


def reduce(data, axis: int = 1, main_op: Callable = _identity, reduce_op: str = "add",
           final_op: Callable = _identity, init: float = 0.0, device=None):
    """Generalized row/col reduction (linalg/reduce.cuh). `axis=1` reduces
    along rows (per-row outputs)."""
    x = main_op(as_input(data, device))
    if reduce_op == "add":
        out = torch.sum(x, dim=axis) + init
    elif reduce_op == "min":
        out = torch.amin(x, dim=axis)
        out = torch.clamp(out, max=init) if init else out
    elif reduce_op == "max":
        out = torch.amax(x, dim=axis)
        out = torch.clamp(out, min=init) if init else out
    else:
        raise ValueError(f"unknown reduce_op {reduce_op}")
    return final_op(out)


def coalesced_reduction(data, main_op=_identity, final_op=_identity, device=None):
    """Reduce along the contiguous (last) dimension."""
    return reduce(data, axis=-1, main_op=main_op, final_op=final_op, device=device)


def strided_reduction(data, main_op=_identity, final_op=_identity, device=None):
    """Reduce along the strided (first) dimension."""
    return reduce(data, axis=0, main_op=main_op, final_op=final_op, device=device)


def map_reduce(op: Callable, *arrays, reduce_op: str = "add", device=None):
    """map then full reduce (map_reduce.cuh)."""
    first = as_input(arrays[0], device)
    x = op(first, *[as_tensor(a, first.device) for a in arrays[1:]])
    return {"add": torch.sum, "min": torch.amin, "max": torch.amax}[reduce_op](x)


def norm(data, norm_type: str = "l2", axis: int = 1, sqrt: bool = False, device=None):
    """Row/col norms (linalg/norm.cuh): L2 is the SQUARED norm unless
    sqrt=True, as the reference's rowNorm."""
    x = _f32(data, device)
    if norm_type in ("l2", 2):
        out = torch.sum(x * x, dim=axis)
        return torch.sqrt(out) if sqrt else out
    if norm_type in ("l1", 1):
        return torch.sum(torch.abs(x), dim=axis)
    if norm_type in ("linf",):
        return torch.amax(torch.abs(x), dim=axis)
    raise ValueError(norm_type)


def row_norm(data, norm_type="l2", sqrt: bool = False, device=None):
    return norm(data, norm_type, axis=1, sqrt=sqrt, device=device)


def col_norm(data, norm_type="l2", sqrt: bool = False, device=None):
    return norm(data, norm_type, axis=0, sqrt=sqrt, device=device)


def normalize(data, norm_type: str = "l2", axis: int = 1, eps: float = 1e-12, device=None):
    """Row normalization (linalg/normalize.cuh)."""
    x = _f32(data, device)
    n = norm(x, norm_type, axis=axis, sqrt=(norm_type in ("l2", 2)))
    return x / torch.clamp(n, min=eps).unsqueeze(axis)


def mean_squared_error(a, b, weight: float = 1.0, device=None):
    x = _f32(a, device)
    return weight * torch.mean((x - as_tensor(b, x.device).float()) ** 2)


def reduce_rows_by_key(data, keys, n_keys: Optional[int] = None, weights=None, device=None):
    """Sum rows by key (reduce_rows_by_key.cuh), the k-means centroid
    accumulator: (n_keys, cols) f32."""
    x = _f32(data, device)
    k = as_tensor(keys, x.device).long()
    if n_keys is None:
        n_keys = int(torch.max(k)) + 1
    if weights is not None:
        x = x * as_tensor(weights, x.device).float()[:, None]
    out = torch.zeros((n_keys,) + tuple(x.shape[1:]), dtype=torch.float32, device=x.device)
    return out.index_add_(0, k, x)


def reduce_cols_by_key(data, keys, n_keys: Optional[int] = None, device=None):
    """Sum columns sharing a key (reduce_cols_by_key.cuh)."""
    x = _f32(data, device)
    return reduce_rows_by_key(x.T, keys, n_keys).T


def matrix_vector_op(matrix, vec, op=torch.add, along_rows: bool = True, device=None):
    """Broadcast a vector over a matrix (matrix_vector_op.cuh):
    along_rows=True, vec has one entry per column."""
    m = as_input(matrix, device)
    v = as_tensor(vec, m.device)
    return op(m, v[None, :] if along_rows else v[:, None])
