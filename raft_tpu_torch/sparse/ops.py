"""Sparse structural ops (counterpart of raft_tpu/sparse/ops.py;
sparse/op/{sort,filter,reduce,slice,row_op}.cuh, sparse/linalg/degree.cuh).

The JAX package runs the ops with a dynamic nnz on the host
(`np.unique`, `np.add.at`); here they run on the container's device and
give the same entries in the same order: `_group_reduce` takes the
sorted unique keys and folds each key's values in their order of
occurrence, as `np.add.at` / `np.maximum.at` do, one position of every
group a step (no float atomics, so the sums are the same on every run).
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from raft_tpu_torch.sparse.formats import CooMatrix, CsrMatrix


def _group_reduce(key: torch.Tensor, vals: torch.Tensor, op: Callable, init: float = 0.0
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(sorted unique keys, per key `init` folded with `op` over its values
    in order of occurrence, per key counts)."""
    order = torch.sort(key, stable=True).indices
    ks, vs = key[order], vals[order]
    uniq, counts = torch.unique_consecutive(ks, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    out = torch.full((uniq.shape[0],), init, dtype=vals.dtype, device=vals.device)
    for j in range(int(counts.max()) if counts.numel() else 0):
        sel = torch.nonzero(counts > j).squeeze(1)
        out[sel] = op(out[sel], vs[starts[sel] + j])
    return uniq, out, counts


def _split_key(uniq: torch.Tensor, n_cols: int):
    return (uniq // n_cols).to(torch.int32), (uniq % n_cols).to(torch.int32)


def coo_sort(coo: CooMatrix) -> CooMatrix:
    return coo.sort_by_row()


def coo_remove_zeros(coo: CooMatrix, tol: float = 0.0) -> CooMatrix:
    """Drop entries with |value| <= tol (op/filter.cuh)."""
    keep = torch.abs(coo.vals) > tol
    return CooMatrix(coo.rows[keep], coo.cols[keep], coo.vals[keep], coo.shape)


def max_duplicates(coo: CooMatrix) -> CooMatrix:
    """Deduplicate (row, col) pairs keeping the SUM of duplicates
    (op/reduce.cuh semantics, the JAX package's name), sorted by (row, col)."""
    key = coo.rows.long() * coo.shape[1] + coo.cols.long()
    uniq, sums, _ = _group_reduce(key, coo.vals, torch.add)
    r, c = _split_key(uniq, coo.shape[1])
    return CooMatrix(r, c, sums, coo.shape)


def csr_row_slice(csr: CsrMatrix, start: int, stop: int) -> CsrMatrix:
    """Rows [start, stop) as a CSR (op/slice.cuh)."""
    lo, hi = int(csr.indptr[start]), int(csr.indptr[stop])
    return CsrMatrix(csr.indptr[start:stop + 1] - lo, csr.indices[lo:hi], csr.data[lo:hi],
                     (stop - start, csr.shape[1]))


def degree(coo: CooMatrix) -> torch.Tensor:
    """Entries a row, int32 (sparse/linalg/degree.cuh)."""
    return torch.bincount(coo.rows.long(), minlength=coo.shape[0]).to(torch.int32)


def csr_row_op(csr: CsrMatrix, fn) -> CsrMatrix:
    """Apply fn(row_id, values) -> values to every entry (op/row_op.cuh)."""
    return CsrMatrix(csr.indptr, csr.indices, fn(csr.row_ids(), csr.data), csr.shape)
