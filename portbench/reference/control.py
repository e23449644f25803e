"""The control: the plain reference put in the program's place, one
precision below the one the configuration states.

Both configurations state bf16 rows with float32 sums for the distances
they return (the default rerank's rows, IVF-Flat's residual rows), so the
control rounds the rows and the queries to float8 (e4m3) and answers with
the exact neighbours and distances of the rounded vectors. A check that
lets the control pass cannot tell a lower precision from the program.
"""

from __future__ import annotations

import torch

from portbench.reference.exact_knn import exact_knn


def round_fp8(x: torch.Tensor, block: int = 1 << 21) -> torch.Tensor:
    out = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    for s in range(0, x.shape[0], block):
        out[s:s + block] = x[s:s + block].to(torch.float8_e4m3fn).float()
    return out


def control_knn(rows: torch.Tensor, queries: torch.Tensor, k: int):
    """(distances (nq, k) float32, ids (nq, k) int32) of the fp8 control."""
    d, i = exact_knn(round_fp8(rows), round_fp8(queries), k)
    return d.float(), i.int()
