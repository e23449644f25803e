"""mdarray/mdspan-style factories (counterpart of raft_tpu/core/mdarray.py;
the reference's core/device_mdarray.hpp, core/host_mdarray.hpp): owning
device tensors (zero-filled, on the card unless `device` says otherwise),
host numpy arrays, and the views, which validate rank and shape and
return a row-major tensor."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch.core.config import resolve_device
from raft_tpu_torch.core.validation import as_input

__all__ = [
    "make_device_matrix",
    "make_device_vector",
    "make_device_scalar",
    "make_host_matrix",
    "make_host_vector",
    "make_device_matrix_view",
    "make_device_vector_view",
]


def make_device_matrix(n_rows: int, n_cols: int, dtype=torch.float32,
                       device=None) -> torch.Tensor:
    """Owning zero-initialized device matrix (make_device_matrix)."""
    return torch.zeros((n_rows, n_cols), dtype=dtype, device=resolve_device(device))


def make_device_vector(n: int, dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros((n,), dtype=dtype, device=resolve_device(device))


def make_device_scalar(value, dtype=None, device=None) -> torch.Tensor:
    return torch.as_tensor(value, dtype=dtype, device=resolve_device(device))


def make_host_matrix(n_rows: int, n_cols: int, dtype=np.float32) -> np.ndarray:
    return np.zeros((n_rows, n_cols), dtype)


def make_host_vector(n: int, dtype=np.float32) -> np.ndarray:
    return np.zeros((n,), dtype)


def make_device_matrix_view(array, shape: Optional[Tuple[int, int]] = None,
                            device=None) -> torch.Tensor:
    """2-D view (make_device_matrix_view): a tensor stays where it is
    (and is not copied); anything else goes to `device`."""
    a = as_input(array, device)
    if shape is not None:
        a = a.reshape(shape)
    if a.ndim != 2:
        raise ValueError(f"expected a matrix, got ndim={a.ndim}")
    return a


def make_device_vector_view(array, device=None) -> torch.Tensor:
    a = as_input(array, device)
    if a.ndim != 1:
        raise ValueError(f"expected a vector, got ndim={a.ndim}")
    return a
