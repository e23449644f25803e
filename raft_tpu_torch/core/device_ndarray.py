"""device_ndarray: a minimal device array (counterpart of
raft_tpu/core/device_ndarray.py; pylibraft's common/device_ndarray.py).

It holds a tensor on the card (unless `device` says otherwise), built
from numpy or a tensor, and exposes what pylibraft users reach for:
`shape`, `dtype` (numpy), `copy_to_host`, `__array__` and, for a CUDA
tensor, `__cuda_array_interface__` (so CuPy and Numba read it without a
copy).
"""

from __future__ import annotations

import numpy as np
import torch

from raft_tpu_torch.core.validation import as_input


def _np_dtype(dtype: torch.dtype) -> np.dtype:
    return torch.empty(0, dtype=dtype).numpy().dtype


class device_ndarray:
    """pylibraft.common.device_ndarray's surface over a tensor."""

    def __init__(self, np_ndarray, device=None):
        self._tensor = as_input(np_ndarray, device)

    @classmethod
    def empty(cls, shape, dtype=np.float32, order="C", device=None):
        return cls(np.zeros(shape, dtype=dtype), device=device)

    @classmethod
    def zeros(cls, shape, dtype=np.float32, device=None):
        return cls.empty(shape, dtype=dtype, device=device)

    @classmethod
    def from_tensor(cls, t: torch.Tensor):
        self = cls.__new__(cls)
        self._tensor = t
        return self

    @property
    def array(self) -> torch.Tensor:
        return self._tensor

    @property
    def shape(self):
        return tuple(self._tensor.shape)

    @property
    def dtype(self) -> np.dtype:
        return _np_dtype(self._tensor.dtype)

    @property
    def ndim(self):
        return self._tensor.ndim

    @property
    def __cuda_array_interface__(self):
        if self._tensor.device.type != "cuda":
            raise AttributeError("__cuda_array_interface__ is only defined on a CUDA device")
        return self._tensor.__cuda_array_interface__

    def copy_to_host(self) -> np.ndarray:
        return self._tensor.detach().cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        out = self.copy_to_host()
        return out.astype(dtype) if dtype is not None else out

    def __len__(self):
        return self.shape[0] if self.ndim else 0

    def __repr__(self):
        return f"device_ndarray(shape={self.shape}, dtype={self.dtype}, device={self._tensor.device})"
