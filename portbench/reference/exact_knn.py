"""Exact k nearest neighbours under squared L2, in plain PyTorch.

Two passes, in blocks so that a 10M-row table fits beside its inputs:
float32 expanded distances (TF32 off) pick each query's k + `margin`
nearest rows, then those candidates are scored again in float64 as
sum((row - query)^2) and the best k kept, equal distances to the smaller
id. The margin covers the float32 pass's rounding, which is far below
the gaps between neighbours at these widths.
"""

from __future__ import annotations

import torch


def strict_f32() -> None:
    """Float32 products in full float32 (no TF32) on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _sq_norms(rows: torch.Tensor, block: int) -> torch.Tensor:
    out = torch.empty(rows.shape[0], dtype=torch.float32, device=rows.device)
    for s in range(0, rows.shape[0], block):
        r = rows[s:s + block].float()
        out[s:s + block] = (r * r).sum(1)
    return out


def _best_first(d: torch.Tensor, ids: torch.Tensor, k: int):
    """The k smallest of each row of d, ties to the smaller id."""
    by_id = torch.argsort(ids, dim=1, stable=True)
    d, ids = torch.gather(d, 1, by_id), torch.gather(ids, 1, by_id)
    by_d = torch.argsort(d, dim=1, stable=True)[:, :k]
    return torch.gather(d, 1, by_d), torch.gather(ids, 1, by_d)


def pair_distances(rows: torch.Tensor, queries: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """float64 squared L2 between each query (b, dim) and the rows its ids
    (b, m) name; NaN where an id is out of range."""
    ok = (ids >= 0) & (ids < rows.shape[0])
    r = rows[torch.where(ok, ids, 0).long()].double()
    d = ((r - queries.double()[:, None, :]) ** 2).sum(2)
    return torch.where(ok, d, float("nan"))


def exact_knn(rows: torch.Tensor, queries: torch.Tensor, k: int, *, query_block: int = 1024,
              row_block: int = 1 << 20, margin: int = 32):
    """(distances (nq, k) float64, ids (nq, k) int64), best first."""
    strict_f32()
    n = rows.shape[0]
    kk = min(n, k + margin)
    rn = _sq_norms(rows, row_block)
    out_d, out_i = [], []
    for qs in range(0, queries.shape[0], query_block):
        q = queries[qs:qs + query_block].float()
        qn = (q * q).sum(1)[:, None]
        best_d = best_i = None
        for rs in range(0, n, row_block):
            r = rows[rs:rs + row_block].float()
            d = qn + rn[rs:rs + row_block][None, :] - 2.0 * (q @ r.T)
            v, i = torch.topk(d, min(kk, r.shape[0]), dim=1, largest=False)
            i = i + rs
            if best_d is not None:
                v, i = torch.cat([best_d, v], 1), torch.cat([best_i, i], 1)
                v, pos = torch.topk(v, kk, dim=1, largest=False)
                i = torch.gather(i, 1, pos)
            best_d, best_i = v, i
        d, i = _best_first(pair_distances(rows, q, best_i), best_i, k)
        out_d.append(d)
        out_i.append(i)
    return torch.cat(out_d), torch.cat(out_i)
