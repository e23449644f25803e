"""Sparse formats: COO and CSR containers and their conversions
(counterpart of raft_tpu/sparse/formats.py).

The containers are dataclasses of tensors on one device; every function
on a container runs on its tensors' device. Fields given as numpy arrays
or lists become tensors on the device of the container's first tensor
field, else on the default device (the card; `core.config`). The
conversions from dense are host work with a dynamic nnz, as in the JAX
package: the counting pass of `dense_to_csr` runs in the port's C++ host
library (`raft_tpu_torch.native`) when it is available, a numpy
`bincount` otherwise; the result moves to `device`.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.core.config import resolve_device


def _fields_to_tensors(obj, names) -> None:
    dev = next((getattr(obj, n).device for n in names
                if isinstance(getattr(obj, n), torch.Tensor)), None)
    for n in names:
        v = getattr(obj, n)
        if not isinstance(v, torch.Tensor):
            if dev is None:
                dev = resolve_device(None)
            setattr(obj, n, torch.tensor(np.asarray(v), device=dev))
    obj.shape = (int(obj.shape[0]), int(obj.shape[1]))


@dataclasses.dataclass
class CooMatrix:
    """COO (row, col, val) triplets; rows need not be sorted."""

    rows: torch.Tensor
    cols: torch.Tensor
    vals: torch.Tensor
    shape: Tuple[int, int]

    def __post_init__(self):
        _fields_to_tensors(self, ("rows", "cols", "vals"))

    @property
    def nnz(self) -> int:
        return int(self.rows.shape[0])

    @property
    def device(self) -> torch.device:
        return self.rows.device

    def sort_by_row(self) -> "CooMatrix":
        """Entries ordered by (row, col), equal pairs in their order
        (`jnp.lexsort((cols, rows))`)."""
        key = self.rows.long() * self.shape[1] + self.cols.long()
        order = torch.sort(key, stable=True).indices
        return CooMatrix(self.rows[order], self.cols[order], self.vals[order], self.shape)


@dataclasses.dataclass
class CsrMatrix:
    """CSR (indptr, indices, data)."""

    indptr: torch.Tensor
    indices: torch.Tensor
    data: torch.Tensor
    shape: Tuple[int, int]

    def __post_init__(self):
        _fields_to_tensors(self, ("indptr", "indices", "data"))

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    def row_lengths(self) -> torch.Tensor:
        """Entries a row, int64 (the segment lengths of the row reductions)."""
        return (self.indptr[1:] - self.indptr[:-1]).long()

    def row_ids(self) -> torch.Tensor:
        """The row of every entry, int32 (convert/csr.cuh csr_to_coo rows)."""
        return torch.repeat_interleave(
            torch.arange(self.shape[0], dtype=torch.int32, device=self.device),
            self.row_lengths(), output_size=self.nnz)


# -- conversions -------------------------------------------------------------


def coo_to_csr(coo: CooMatrix) -> CsrMatrix:
    s = coo.sort_by_row()
    counts = torch.bincount(s.rows.long(), minlength=coo.shape[0])
    indptr = torch.zeros(coo.shape[0] + 1, dtype=torch.int32, device=coo.device)
    indptr[1:] = torch.cumsum(counts, 0)
    return CsrMatrix(indptr, s.cols.to(torch.int32), s.vals, coo.shape)


def csr_to_coo(csr: CsrMatrix) -> CooMatrix:
    return CooMatrix(csr.row_ids(), csr.indices, csr.data, csr.shape)


def _host_dense(dense, tol):
    d = dense.detach().cpu().numpy() if isinstance(dense, torch.Tensor) else np.asarray(dense)
    mask = np.abs(d) > tol
    rows, cols = np.nonzero(mask)
    return d, mask, rows, cols


def _device_of(dense, device):
    if device is None and isinstance(dense, torch.Tensor):
        return dense.device
    return resolve_device(device)


def dense_to_csr(dense, tol: float = 0.0, device=None) -> CsrMatrix:
    """Entries with |value| > tol, row-major (host conversion)."""
    from raft_tpu_torch import native

    dev = _device_of(dense, device)
    d, mask, rows, cols = _host_dense(dense, tol)
    indptr = native.coo_rows_to_indptr(rows, d.shape[0])
    if indptr is None:
        counts = np.bincount(rows, minlength=d.shape[0])
        indptr = np.zeros(d.shape[0] + 1, np.int32)
        np.cumsum(counts, out=indptr[1:])
    return CsrMatrix(torch.as_tensor(indptr.astype(np.int32), device=dev),
                     torch.as_tensor(cols.astype(np.int32), device=dev),
                     torch.as_tensor(d[mask], device=dev), d.shape)


def dense_to_coo(dense, tol: float = 0.0, device=None) -> CooMatrix:
    dev = _device_of(dense, device)
    d, mask, rows, cols = _host_dense(dense, tol)
    return CooMatrix(torch.as_tensor(rows.astype(np.int32), device=dev),
                     torch.as_tensor(cols.astype(np.int32), device=dev),
                     torch.as_tensor(d[mask], device=dev), d.shape)


def _scatter_dense(shape, rows, cols, vals) -> torch.Tensor:
    out = torch.zeros(shape, dtype=vals.dtype, device=vals.device)
    return out.index_put_((rows.long(), cols.long()), vals, accumulate=True)


def csr_to_dense(csr: CsrMatrix) -> torch.Tensor:
    return _scatter_dense(csr.shape, csr.row_ids(), csr.indices, csr.data)


def coo_to_dense(coo: CooMatrix) -> torch.Tensor:
    return _scatter_dense(coo.shape, coo.rows, coo.cols, coo.vals)
