"""Sparse linear algebra (counterpart of raft_tpu/sparse/linalg.py;
sparse/linalg/{add,transpose,symmetrize,norm,spectral}.cuh and the
cuSparse SPMV/SPMM wrappers).

SPMV, SPMM and the row norms reduce each CSR row's contiguous entries
with `torch.segment_reduce` (one reduction a segment, no float atomics:
the same bits on every run, which the Lanczos solver above it needs;
`index_add_` would add in a different order on each run on the card).
The JAX package's `segment_sum` adds in another order, so sums agree to
f32 rounding. The Laplacian is a matvec closure for the Lanczos solver.
"""

from __future__ import annotations

from typing import Callable

import torch

from raft_tpu_torch.sparse.formats import CooMatrix, CsrMatrix, coo_to_csr, csr_to_coo
from raft_tpu_torch.sparse.ops import _group_reduce, _split_key


def _row_reduce(csr: CsrMatrix, per_entry: torch.Tensor, reduce: str = "sum") -> torch.Tensor:
    return torch.segment_reduce(per_entry, reduce, lengths=csr.row_lengths(), axis=0)


def spmv(csr: CsrMatrix, x) -> torch.Tensor:
    """y = A @ x: a product an entry, summed a row."""
    xv = torch.as_tensor(x, device=csr.device)
    return _row_reduce(csr, csr.data * xv[csr.indices.long()])


def spmm(csr: CsrMatrix, B) -> torch.Tensor:
    """Y = A @ B: the entry's row of B scaled, summed a row."""
    b = torch.as_tensor(B, device=csr.device)
    return _row_reduce(csr, csr.data[:, None] * b[csr.indices.long()])


def transpose(csr: CsrMatrix) -> CsrMatrix:
    coo = csr_to_coo(csr)
    return coo_to_csr(CooMatrix(coo.cols, coo.rows, coo.vals, (csr.shape[1], csr.shape[0])))


def add(a: CsrMatrix, b: CsrMatrix) -> CsrMatrix:
    """A + B."""
    from raft_tpu_torch.sparse.ops import max_duplicates

    ca, cb = csr_to_coo(a), csr_to_coo(b)
    merged = CooMatrix(torch.cat([ca.rows, cb.rows]), torch.cat([ca.cols, cb.cols]),
                       torch.cat([ca.vals, cb.vals]), a.shape)
    return coo_to_csr(max_duplicates(merged))


def symmetrize(coo: CooMatrix, op: str = "max") -> CooMatrix:
    """A combined with its transpose (sparse/linalg/symmetrize.cuh), op in
    {max, sum, mean}; 'max' is the knn-graph default. Entries sorted by
    (row, col); each pair's values fold from 0 in their order in [A; A^T]
    (`np.maximum.at` / `np.add.at` on zeros), 'mean' divides the f32 sum
    by the count in float64 and rounds once, as numpy promotes it."""
    if op not in ("max", "sum", "mean"):
        raise ValueError(op)
    r = torch.cat([coo.rows, coo.cols]).long()
    c = torch.cat([coo.cols, coo.rows]).long()
    v = torch.cat([coo.vals, coo.vals])
    fold = torch.maximum if op == "max" else torch.add
    uniq, out, counts = _group_reduce(r * coo.shape[1] + c, v, fold)
    if op == "mean":
        out = (out.double() / counts.clamp(min=1)).to(v.dtype)
    rows, cols = _split_key(uniq, coo.shape[1])
    return CooMatrix(rows, cols, out, coo.shape)


def row_norm_csr(csr: CsrMatrix, norm_type: str = "l2") -> torch.Tensor:
    """Per-row sum of squares ('l2'), of magnitudes ('l1'), or the largest
    magnitude ('linf'; -inf on an empty row)."""
    d = csr.data
    if norm_type == "l2":
        return _row_reduce(csr, d * d)
    if norm_type == "l1":
        return _row_reduce(csr, torch.abs(d))
    if norm_type == "linf":
        return _row_reduce(csr, torch.abs(d), "max")
    raise ValueError(norm_type)


def laplacian_matvec(adj: CsrMatrix, normalized: bool = True) -> Callable:
    """v -> L @ v for the (normalized) graph Laplacian
    (spectral/matrix_wrappers.hpp laplacian_matrix_t semantics)."""
    deg = spmv(adj, torch.ones((adj.shape[1],), dtype=torch.float32, device=adj.device))
    if not normalized:
        def mv(v):
            return deg * v - spmv(adj, v)
        return mv
    dinv = 1.0 / torch.sqrt(torch.clamp(deg, min=1e-12))

    def mv(v):
        return v - dinv * spmv(adj, dinv * v)

    return mv
