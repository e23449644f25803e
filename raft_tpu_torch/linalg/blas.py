"""BLAS-level ops (counterpart of raft_tpu/linalg/blas.py; linalg/gemm.cuh,
gemv.cuh, axpy.cuh, dot.cuh): float32 products in full float32 (TF32
off), as the JAX package computes them at f32 accumulation."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.config import strict_f32_matmul
from raft_tpu_torch.core.validation import as_input, as_tensor


def _t(x, device=None, like=None) -> torch.Tensor:
    return as_tensor(x, like.device) if like is not None else as_input(x, device)


def gemm(A, B, alpha: float = 1.0, beta: float = 0.0, C=None, trans_a: bool = False,
         trans_b: bool = False, device=None) -> torch.Tensor:
    """alpha * op(A) @ op(B) + beta * C, accumulated in f32, returned in
    A's dtype."""
    a = _t(A, device)
    b = _t(B, like=a)
    if trans_a:
        a = a.T
    if trans_b:
        b = b.T
    strict_f32_matmul()
    out = alpha * (a.float() @ b.float())
    if C is not None and beta != 0.0:
        out = out + beta * _t(C, like=a)
    return out.to(a.dtype)


def gemv(A, x, alpha: float = 1.0, beta: float = 0.0, y=None, trans: bool = False,
         device=None) -> torch.Tensor:
    a = _t(A, device)
    if trans:
        a = a.T
    strict_f32_matmul()
    out = alpha * (a @ _t(x, like=a))
    if y is not None and beta != 0.0:
        out = out + beta * _t(y, like=a)
    return out


def axpy(alpha: float, x, y, device=None) -> torch.Tensor:
    xx = _t(x, device)
    return alpha * xx + _t(y, like=xx)


def dot(x, y, device=None) -> torch.Tensor:
    xx = _t(x, device)
    strict_f32_matmul()
    yy = _t(y, like=xx)
    if xx.ndim == 1 and yy.ndim == 1:
        return torch.dot(xx.float(), yy.float())
    return xx.float() @ yy.float()


def transpose(A, device=None) -> torch.Tensor:
    return _t(A, device).T
