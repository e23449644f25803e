"""Tiled unexpanded pairwise distances (counterpart of
raft_tpu/ops/pairwise_pallas.py).

`pairwise_tiled` is the wrapper over the hand-written CUDA kernel
`csrc/pairwise_tiled.cu`; `pairwise_tiled_plain` is the plain PyTorch
version of the same function beside it. The wrapper takes the plain
version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises, and adds one to `launch_counts()["pairwise_tiled"]`
(`ops._launch`) where it launches.

Contract (the JAX kernel's): (m, k) x (n, k) -> (m, n) f32 for one of the
seven metrics of `METRIC_OPS`: an elementwise term of the f32-cast
operands, reduced over k by sum (identity 0) or max (identity -inf), then
a finalize (sqrt for l2_sqrt_unexpanded; hamming multiplies its count by
the f32 reciprocal of the real k, as XLA compiles the reference's
division by k). The canberra and KL terms are the zero-guarded ones of
`distance.pairwise` (`_canberra_term`, `_kl_term`), which the kernel's
terms copy.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from raft_tpu_torch.distance.pairwise import _canberra_term, _kl_term, _tiled_rowwise
from raft_tpu_torch.ops._launch import (_I, _P, _check, _count_launch, _kernel_fn,
                                         _raise_on, _tensor_arg)


class MetricOp(NamedTuple):
    """One metric: elementwise term, reduction over k, finalize."""

    term: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    reduce: str  # "sum" | "max"
    finalize: Optional[Callable[[torch.Tensor], torch.Tensor]] = None


METRIC_OPS = {
    "l1": MetricOp(lambda a, b: torch.abs(a - b), "sum"),
    "linf": MetricOp(lambda a, b: torch.abs(a - b), "max"),
    "l2_unexpanded": MetricOp(lambda a, b: (a - b) ** 2, "sum"),
    "l2_sqrt_unexpanded": MetricOp(lambda a, b: (a - b) ** 2, "sum", torch.sqrt),
    "canberra": MetricOp(_canberra_term, "sum"),
    "kl_divergence": MetricOp(_kl_term, "sum"),
    # scaled by 1/k (the real k) in pairwise_tiled_plain
    "hamming": MetricOp(lambda a, b: (a != b).float(), "sum"),
}

#: the kernel's metric ids (csrc/pairwise_tiled.cu: Metric)
_METRIC_IDS = {name: i for i, name in enumerate(METRIC_OPS)}


def _f32_reciprocal(k: int) -> torch.Tensor:
    """1/k rounded once to f32, as XLA folds a division by the constant k
    into a multiply."""
    return torch.ones((), dtype=torch.float32) / k


def pairwise_tiled_plain(x: torch.Tensor, y: torch.Tensor, metric: str) -> torch.Tensor:
    """Plain PyTorch version of the kernel, row-blocked (`_tiled_rowwise`)."""
    op = METRIC_OPS[metric]
    inv_k = _f32_reciprocal(x.shape[1])

    def row_fn(xb, yy):
        t = op.term(xb[:, None, :].float(), yy[None, :, :].float())
        s = torch.sum(t, dim=-1) if op.reduce == "sum" else torch.amax(t, dim=-1)
        if metric == "hamming":
            return s * inv_k
        return op.finalize(s) if op.finalize is not None else s

    return _tiled_rowwise(x, y, row_fn)


def pairwise_tiled(x: torch.Tensor, y: torch.Tensor, metric: str) -> torch.Tensor:
    """(m, n) f32 distances for `metric` (a `METRIC_OPS` key) between the
    rows of x (m, k) and y (n, k), any real dtype, on one device."""
    _check(metric in METRIC_OPS, f"unknown pairwise_tiled metric {metric!r}")
    _check(isinstance(x, torch.Tensor), "x must be a tensor")
    dev = x.device
    xf, yf = x.float().contiguous(), y.float().contiguous()
    _tensor_arg("x", xf, (torch.float32,), 2, dev)
    _tensor_arg("y", yf, (torch.float32,), 2, dev)
    m, k = xf.shape
    n = yf.shape[0]
    _check(yf.shape[1] == k, f"x has {k} columns, y has {yf.shape[1]}")
    _check(k >= 1, "pairwise_tiled needs at least one column")
    if dev.type == "cpu":
        return pairwise_tiled_plain(xf, yf, metric)
    _check(dev.type == "cuda", f"pairwise_tiled runs on cpu or cuda, got {dev}")
    out = torch.empty((m, n), dtype=torch.float32, device=dev)
    if m == 0 or n == 0:
        return out
    fn = _kernel_fn("pairwise_tiled.cu", "pairwise_tiled_launch",
                    [_P, _P, _P, _I, _I, _I, _I, _P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(xf.data_ptr(), yf.data_ptr(), out.data_ptr(), m, n, k,
                 _METRIC_IDS[metric], stream)
    _raise_on(err, "pairwise_tiled")
    _count_launch("pairwise_tiled")
    return out
