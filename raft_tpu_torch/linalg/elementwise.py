"""Elementwise / map ops (counterpart of raft_tpu/linalg/elementwise.py;
linalg/unary_op.cuh, binary_op.cuh, ternary_op.cuh, map.cuh, eltwise.cuh):
API parity, tensor expressions underneath."""

from __future__ import annotations

import torch

from raft_tpu_torch.core.validation import as_input, as_tensor


def _all(arrays, device):
    first = as_input(arrays[0], device)
    return [first] + [as_tensor(a, first.device) for a in arrays[1:]]


def unary_op(x, op, device=None):
    return op(*_all([x], device))


def binary_op(x, y, op, device=None):
    return op(*_all([x, y], device))


def ternary_op(x, y, z, op, device=None):
    return op(*_all([x, y, z], device))


def map_op(op, *arrays, device=None):
    """linalg::map: n-ary elementwise map."""
    return op(*_all(arrays, device))


def eltwise_add(x, y, device=None):
    a, b = _all([x, y], device)
    return a + b


def eltwise_sub(x, y, device=None):
    a, b = _all([x, y], device)
    return a - b


def eltwise_multiply(x, y, device=None):
    a, b = _all([x, y], device)
    return a * b


def eltwise_divide(x, y, device=None):
    a, b = _all([x, y], device)
    return a / b


def eltwise_power(x, y, device=None):
    a, b = _all([x, y], device)
    return torch.pow(a, b)


def eltwise_sqrt(x, device=None):
    return torch.sqrt(*_all([x], device))


def scalar_add(x, s, device=None):
    return _all([x], device)[0] + s


def scalar_multiply(x, s, device=None):
    return _all([x], device)[0] * s
