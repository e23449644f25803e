"""Kernel (Gram) matrices for SVM-style algorithms (counterpart of
raft_tpu/distance/kernels.py; distance/kernels.cuh,
detail/kernels/{gram_matrix,kernel_matrices,kernel_factory}.cuh):
linear, polynomial, RBF and tanh kernels with a factory over
`KernelParams`. The dots are `distance.pairwise._dot` (full float32
unless `set_matmul_precision` says otherwise)."""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional

import torch

from raft_tpu_torch.core.validation import as_input, as_tensor


class KernelType(enum.IntEnum):
    LINEAR = 0
    POLYNOMIAL = 1
    RBF = 2
    TANH = 3


@dataclasses.dataclass
class KernelParams:
    kernel: KernelType = KernelType.LINEAR
    degree: int = 3
    gamma: float = 1.0
    coef0: float = 0.0


class GramMatrix:
    """GramMatrixBase parity: a callable computing K(x1, x2), (m, n) f32
    on x1's device (the card unless `device` says otherwise)."""

    def __init__(self, params: KernelParams, device=None):
        self.params = params
        self.device = device

    def __call__(self, x1, x2) -> torch.Tensor:
        from raft_tpu_torch.distance.pairwise import _dot

        x = as_input(x1, self.device, torch.float32)
        y = as_tensor(x2, x.device, torch.float32)
        p = self.params
        if p.kernel == KernelType.LINEAR:
            return _dot(x, y)
        if p.kernel == KernelType.POLYNOMIAL:
            return (p.gamma * _dot(x, y) + p.coef0) ** p.degree
        if p.kernel == KernelType.TANH:
            return torch.tanh(p.gamma * _dot(x, y) + p.coef0)
        if p.kernel == KernelType.RBF:
            sq = (torch.sum(x * x, dim=1)[:, None] + torch.sum(y * y, dim=1)[None, :]
                  - 2.0 * _dot(x, y))
            return torch.exp(-p.gamma * torch.clamp(sq, min=0.0))
        raise ValueError(p.kernel)


def kernel_factory(params: KernelParams, device=None) -> GramMatrix:
    """KernelFactory::create parity."""
    return GramMatrix(params, device)


def gram_matrix(x1, x2, params: Optional[KernelParams] = None, device=None) -> torch.Tensor:
    return GramMatrix(params or KernelParams(), device)(x1, x2)
