"""Fused L2 nearest neighbour (1-NN), the k-means labelling primitive
(counterpart of raft_tpu/distance/fused_l2_nn.py).

For each row of X, the index (and the distance) of the closest row of Y,
without the (m, n) distance matrix ever reaching memory: both entry
points go through `ops.fused_l2_argmin`, the hand-written CUDA kernel for
a CUDA tensor (as a TPU always takes the Pallas engine), its plain
version for a CPU tensor. Ties go to the lowest index.
"""

from __future__ import annotations

from typing import Tuple

import torch

from raft_tpu_torch.core.config import auto_convert_output
from raft_tpu_torch.core.resources import accepts_resources
from raft_tpu_torch.core.validation import check_matrix, check_same_cols


def _fused_l2_nn(x: torch.Tensor, y: torch.Tensor, *, sqrt: bool = False):
    from raft_tpu_torch.ops.fused_l2_argmin import fused_l2_argmin

    return fused_l2_argmin(x.float().contiguous(), y.float().contiguous(), sqrt=sqrt)


def _operands(X, Y, device):
    x = check_matrix(X, device=device, name="X")
    y = check_matrix(Y, device=x.device, name="Y")
    check_same_cols(x, y, "X", "Y")
    if y.shape[0] < 1:
        raise ValueError("Y must have at least one row")
    return x, y


@auto_convert_output
@accepts_resources
def fused_l2_nn_argmin(X, Y, sqrt: bool = False, resources=None, device=None) -> torch.Tensor:
    """(m,) int32 index of the nearest row of Y (L2) for each row of X
    (pylibraft's `fused_l2_nn_argmin`)."""
    x, y = _operands(X, Y, device)
    return _fused_l2_nn(x, y, sqrt=sqrt)[1]


@accepts_resources
def fused_l2_nn(X, Y, sqrt: bool = False, resources=None, device=None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """((m,) f32 min distance, (m,) int32 argmin) pairs: the KeyValuePair
    variant (`MinAndDistanceReduceOp`); squared L2 unless `sqrt`."""
    x, y = _operands(X, Y, device)
    return _fused_l2_nn(x, y, sqrt=sqrt)
