"""Input validation & conversion (counterpart of raft_tpu/core/validation.py).

Any array-like (numpy, torch tensor, nested lists) becomes a tensor on
the requested device; the validators enforce the same shape contracts
the JAX package does.
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.core.config import resolve_device


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """`x` as a tensor on `device` (resolved: CUDA unless told otherwise)."""
    dev = resolve_device(device)
    if not isinstance(x, torch.Tensor):
        a = np.asarray(x)
        # a read-only array (a JAX array's host view) is copied: torch
        # cannot share memory it may not write
        x = torch.as_tensor(a if a.flags.writeable else a.copy())
    return x.to(device=dev, dtype=dtype)


def as_input(x, device=None, dtype=None) -> torch.Tensor:
    """`x` as a tensor: a tensor stays on its own device unless `device`
    names another; anything else goes to `device` (resolved: CUDA unless
    told otherwise)."""
    if device is None and isinstance(x, torch.Tensor):
        device = x.device
    return as_tensor(x, device, dtype)


def check_matrix(x, dtypes=None, name: str = "matrix", device=None, dtype=None
                 ) -> torch.Tensor:
    """`x` as a 2-d tensor on `device` (resolved: the card unless told
    otherwise). `dtypes`, as in the JAX package, are the input's allowed
    dtypes (numpy or torch); `dtype` casts the checked tensor."""
    t = as_tensor(x, device)
    if t.ndim != 2:
        raise ValueError(f"{name}: expected 2-d array, got {t.ndim}-d")
    _check_dtypes(t, dtypes, name)
    return t if dtype is None else t.to(dtype)


def check_same_rows(a, b, name_a="a", name_b="b") -> None:
    if a.shape[0] != b.shape[0]:
        raise ValueError(
            f"{name_a} and {name_b} must have the same number of rows "
            f"({a.shape[0]} vs {b.shape[0]})"
        )


def check_same_cols(a, b, name_a="a", name_b="b") -> None:
    if a.shape[1] != b.shape[1]:
        raise ValueError(
            f"{name_a} and {name_b} must have the same number of columns "
            f"({a.shape[1]} vs {b.shape[1]})"
        )


def _np_dtype(dtype) -> np.dtype:
    if isinstance(dtype, torch.dtype):
        return torch.empty(0, dtype=dtype).numpy().dtype
    return np.dtype(dtype)


def check_array(x, dtypes=None, ndim=None, name: str = "array", device=None) -> torch.Tensor:
    """Validate dtype (numpy or torch dtypes) and rank; returns a tensor
    (a tensor stays on its device unless `device` says otherwise)."""
    t = as_input(x, device)
    if ndim is not None and t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim}-d array, got {t.ndim}-d")
    _check_dtypes(t, dtypes, name)
    return t


def _check_dtypes(t: torch.Tensor, dtypes, name: str) -> None:
    if dtypes is not None:
        allowed = tuple(_np_dtype(d) for d in dtypes)
        if _np_dtype(t.dtype) not in allowed:
            names = ", ".join(d.name for d in allowed)
            raise ValueError(f"{name}: dtype {_np_dtype(t.dtype).name} not in ({names})")


def check_vector(x, dtypes=None, name: str = "vector", device=None) -> torch.Tensor:
    return check_array(x, dtypes=dtypes, ndim=1, name=name, device=device)


class cai_wrapper:
    """pylibraft.common.cai_wrapper's surface: wraps any array-like as a
    tensor and exposes `.shape`, `.dtype` (numpy), `.c_contiguous` and
    `validate_shape_dtype`."""

    def __init__(self, x, device=None):
        self._arr = as_input(x, device)

    @property
    def shape(self):
        return tuple(self._arr.shape)

    @property
    def dtype(self) -> np.dtype:
        return _np_dtype(self._arr.dtype)

    @property
    def c_contiguous(self) -> bool:
        return self._arr.is_contiguous()

    def validate_shape_dtype(self, expected_dims=None, expected_dtype=None):
        if expected_dims is not None and self._arr.ndim != expected_dims:
            raise ValueError(f"unexpected number of dimensions {self._arr.ndim}")
        if expected_dtype is not None and self.dtype != _np_dtype(expected_dtype):
            raise ValueError(f"unexpected dtype {self.dtype}")
        return self

    @property
    def array(self) -> torch.Tensor:
        return self._arr
