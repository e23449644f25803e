"""Linear assignment (counterpart of raft_tpu/solver;
solver/linear_assignment.cuh, the legacy lap/lap.cuh alias).

Bertsekas' auction with ε-scaling, as the JAX package runs it: in every
phase (ε from half the cost spread, times 0.2 a phase, 6 phases; prices
carried over, ownership reset) every row that holds no object bids at
once for its best object by the gap to its second best plus ε, and each
object goes to its highest bid, the lowest row on a tie. A row's object
is read from the ownership table the way the reference's scatter writes
it on the CPU: updates in object order, the last write to a row wins,
and every unowned object writes "none" to row 0 (so row 0 bids again
while an object after its own is unowned). The bids are a per-object
maximum (`scatter_reduce`) instead of the reference's dense (n, n) bid
matrix, the same values. The host drives the rounds and tests for the
end every `_CHECK_EVERY` rounds: a round after the end changes nothing,
and the reference's cap of 50 n + 200 rounds a phase is kept exactly.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from raft_tpu_torch.core.validation import as_tensor

__all__ = [
    "linear_assignment",
    "lap",
]

_CHECK_EVERY = 16
_NEG = -1e30


def _order_key(v: torch.Tensor) -> torch.Tensor:
    """int32 image of f32 values in `lax.top_k`'s total order."""
    b = v.contiguous().view(torch.int32)
    return torch.where(b < 0, b ^ 0x7FFFFFFF, b)


def _top2(values: torch.Tensor):
    """`lax.top_k(values, 2)`: the best and second best value a row, and
    the best one's column (the lowest column on a tie)."""
    key = _order_key(values)
    j1 = torch.argmax(key, dim=1, keepdim=True)
    v1 = torch.gather(values, 1, j1)
    key2 = key.scatter(1, j1, torch.iinfo(torch.int32).min)
    v2 = torch.gather(values, 1, torch.argmax(key2, dim=1, keepdim=True))
    return v1[:, 0], v2[:, 0], j1[:, 0]


def _col_of(row_of: torch.Tensor) -> torch.Tensor:
    """Each row's object from the ownership table, with the reference's
    last-write-wins scatter (see the module docstring)."""
    n = row_of.shape[0]
    obj = torch.arange(n, device=row_of.device)
    owned = row_of >= 0
    col = torch.full((n,), -1, dtype=torch.int64, device=row_of.device)
    col.scatter_reduce_(0, row_of.clamp(min=0).long(), torch.where(owned, obj, -1), "amax",
                        include_self=True)
    last_none = torch.max(torch.where(owned, -1, obj))
    last_row0 = torch.max(torch.where(owned & (row_of == 0), obj, -1))
    col[0] = torch.where(last_none > last_row0, -1, col[0])
    return col


def _auction(cost: torch.Tensor, maximize: bool, eps_start: float, scaling: float = 0.2,
             n_phases: int = 6) -> torch.Tensor:
    n = cost.shape[0]
    dev = cost.device
    benefit = (cost if maximize else -cost).float()
    prices = torch.zeros((n,), dtype=torch.float32, device=dev)
    # scaling^i as running f32 products: at the default 0.2 these are the
    # reference's f32 powers bit for bit (numpy's powf rounds 0.2^2 apart)
    powers = [np.float32(1.0)]
    for _ in range(n_phases - 1):
        powers.append(np.float32(powers[-1] * np.float32(scaling)))
    eps_seq = np.float32(eps_start) * np.array(powers, dtype=np.float32)
    cap = 50 * n + 200
    rows = torch.arange(n, device=dev)
    for eps in eps_seq.tolist():
        eps = torch.tensor(eps, dtype=torch.float32, device=dev)
        row_of = torch.full((n,), -1, dtype=torch.int64, device=dev)
        it = 0
        while it < cap and bool(torch.any(_col_of(row_of) < 0)):
            for _ in range(min(_CHECK_EVERY, cap - it)):
                unassigned = _col_of(row_of) < 0
                v1, v2, best_j = _top2(benefit - prices[None, :])
                bid = prices[best_j] + (v1 - v2) + eps
                win = torch.full((n,), _NEG, dtype=torch.float32, device=dev)
                win.scatter_reduce_(0, best_j, torch.where(unassigned, bid, _NEG), "amax",
                                    include_self=True)
                at_win = unassigned & (bid == win[best_j])
                winner = torch.full((n,), n, dtype=torch.int64, device=dev)
                winner.scatter_reduce_(0, best_j, torch.where(at_win, rows, n), "amin",
                                       include_self=True)
                has = win > _NEG
                prices = torch.where(has, win, prices)
                row_of = torch.where(has, winner, row_of)
                it += 1
    return _col_of(row_of)


def linear_assignment(cost, maximize: bool = False,
                      device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Solve the LAP: (row indices, int32 column of each row) minimizing
    (or with `maximize`, maximizing) sum(cost[i, col[i]])
    (LinearAssignmentProblem.solve parity)."""
    c = as_tensor(cost, device).float()
    if c.ndim != 2 or c.shape[0] != c.shape[1]:
        raise ValueError("cost must be square (n, n)")
    n = c.shape[0]
    if n == 0:
        z = torch.zeros((0,), dtype=torch.int32, device=c.device)
        return z, z.clone()
    spread = float(torch.max(c) - torch.min(c))
    col = _auction(c, maximize, eps_start=max(spread, 1e-3) / 2.0)
    return torch.arange(n, dtype=torch.int32, device=c.device), col.to(torch.int32)


lap = linear_assignment  # legacy lap/lap.cuh alias
