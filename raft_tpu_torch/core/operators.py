"""Composable functional operators (counterpart of raft_tpu/core/operators.py;
the reference's `core/operators.hpp`): `identity_op`, `sq_op`, `add_op`,
`argmin_op`, `compose_op`, ... as plain Python callables over tensors,
usable as the `main_op` / `reduce_op` / `final_op` arguments of
`raft_tpu_torch.linalg.reduce`, `map_reduce`, `coalesced_reduction`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

__all__ = [
    "identity_op",
    "void_op",
    "sq_op",
    "abs_op",
    "sqrt_op",
    "nz_op",
    "add_op",
    "sub_op",
    "mul_op",
    "div_op",
    "min_op",
    "max_op",
    "pow_op",
    "mod_op",
    "equal_op",
    "notequal_op",
    "argmin_op",
    "argmax_op",
    "const_op",
    "cast_op",
    "key_op",
    "value_op",
    "compose_op",
    "map_args_op",
    "KeyValuePair",
]


class KeyValuePair(NamedTuple):
    """(key, value) pair (core/kvp.hpp `raft::KeyValuePair`), carried
    through argmin-style reductions."""

    key: torch.Tensor
    value: torch.Tensor


# -- unary -------------------------------------------------------------------

def identity_op(x, *args):
    return x


def void_op(*args):
    return None


def sq_op(x, *args):
    return x * x


def abs_op(x, *args):
    return torch.abs(torch.as_tensor(x))


def sqrt_op(x, *args):
    return torch.sqrt(torch.as_tensor(x))


def nz_op(x, *args):
    """1 where nonzero else 0 (used by L0 'norm')."""
    x = torch.as_tensor(x)
    return torch.where(x != 0, torch.ones_like(x), torch.zeros_like(x))


# -- binary ------------------------------------------------------------------

def add_op(a, b):
    return a + b


def sub_op(a, b):
    return a - b


def mul_op(a, b):
    return a * b


def div_op(a, b):
    return a / b


def min_op(a, b):
    return torch.minimum(torch.as_tensor(a), torch.as_tensor(b))


def max_op(a, b):
    return torch.maximum(torch.as_tensor(a), torch.as_tensor(b))


def pow_op(a, b):
    return a**b


def mod_op(a, b):
    return a % b


def equal_op(a, b):
    return a == b


def notequal_op(a, b):
    return a != b


def argmin_op(a: KeyValuePair, b: KeyValuePair) -> KeyValuePair:
    """KeyValuePair reduction keeping the smaller value (kvp argmin)."""
    take_a = (a.value < b.value) | ((a.value == b.value) & (a.key <= b.key))
    return KeyValuePair(
        torch.where(take_a, a.key, b.key), torch.where(take_a, a.value, b.value)
    )


def argmax_op(a: KeyValuePair, b: KeyValuePair) -> KeyValuePair:
    take_a = (a.value > b.value) | ((a.value == b.value) & (a.key <= b.key))
    return KeyValuePair(
        torch.where(take_a, a.key, b.key), torch.where(take_a, a.value, b.value)
    )


# -- structural --------------------------------------------------------------

def const_op(c) -> Callable:
    """Returns an op that ignores inputs and yields `c` (const_op<T>)."""

    def op(*args):
        return c

    return op


def cast_op(dtype) -> Callable:
    """Casting op factory (cast_op<T>)."""

    def op(x, *args):
        return torch.as_tensor(x).to(dtype)

    return op


def key_op(kv: KeyValuePair, *args):
    return kv.key


def value_op(kv: KeyValuePair, *args):
    return kv.value


def compose_op(*ops: Callable) -> Callable:
    """compose_op(f, g, h)(x) == f(g(h(x))) (core/operators.hpp compose_op)."""

    def op(x, *args):
        for f in reversed(ops):
            x = f(x, *args)
        return x

    return op


def map_args_op(fn: Callable, *arg_ops: Callable) -> Callable:
    """map_args_op: apply arg_ops[i] to the i-th argument, then fn."""

    def op(*args):
        mapped = [aop(a) for aop, a in zip(arg_ops, args)]
        mapped.extend(args[len(arg_ops):])
        return fn(*mapped)

    return op
