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


def check_matrix(x, device=None, dtype=None, name: str = "matrix") -> torch.Tensor:
    t = as_tensor(x, device, dtype)
    if t.ndim != 2:
        raise ValueError(f"{name}: expected 2-d array, got {t.ndim}-d")
    return t


def check_same_cols(a, b, name_a="a", name_b="b") -> None:
    if a.shape[1] != b.shape[1]:
        raise ValueError(
            f"{name_a} and {name_b} must have the same number of columns "
            f"({a.shape[1]} vs {b.shape[1]})"
        )
