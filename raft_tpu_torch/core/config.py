"""Device resolution and output types for the PyTorch port (counterpart
of raft_tpu/core/config.py).

Every entry point takes an explicit `device`. The default is the CUDA
card: a caller that wants the CPU says so (`device="cpu"`, as the CPU
parity tests do). Without a card, a default request raises instead of
carrying on quietly on the CPU, so a measurement can never be a CPU
number under a device's name.

Output types (pylibraft's `set_output_as`, applied by
`auto_convert_output`): entry points return tensors; `set_output_as`
may ask for "numpy" (host copies) or any callable taking a tensor.
Conversion happens once, at the outermost decorated call.
"""

from __future__ import annotations

import functools
import threading
from typing import Any, Callable, Union

import torch


def resolve_device(device=None) -> torch.device:
    """`None` -> the current CUDA device; raises when no card is present.
    Any other value is returned as a `torch.device` (a CUDA request
    without a card raises as well)."""
    dev = torch.device("cuda") if device is None else torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "raft_tpu_torch runs on a CUDA device unless device='cpu' is "
            "passed, and torch.cuda.is_available() is False"
        )
    return dev


def strict_f32_matmul() -> None:
    """Keep float32 matmuls in full float32 on the card. The JAX
    reference computes its coarse, k-means and refine dots at
    `Precision.HIGHEST` (raft_tpu/distance/pairwise.py); TF32 would keep
    only ~3 decimal digits and flip near-tie rankings."""
    torch.backends.cuda.matmul.allow_tf32 = False


#: CUDA errors after which the raising process's context is poisoned:
#: every later operation on the card fails, and only a fresh process
#: recovers it
_CUDA_FAULTS = (
    "device-side assert triggered",
    "an illegal memory access was encountered",
    "unspecified launch failure",
    "misaligned address",
    "illegal instruction",
    "uncorrectable ECC error",
)


def is_device_fault(e: BaseException) -> bool:
    """True when an exception reports a device fault that poisons the
    raising process: the CUDA errors above (a kernel's illegal access,
    a device-side assert, an uncorrectable ECC error), and the JAX
    package's TPU strings ("UNAVAILABLE", "device error"), so a message
    both packages see is classified the same way. Long sessions use it
    to decide between "keep the partial results and stop" and "a
    configuration failed, go on"."""
    msg = str(e)
    return ("UNAVAILABLE" in msg or "device error" in msg
            or any(s in msg for s in _CUDA_FAULTS))


_TLS = threading.local()
_OUTPUT_AS: Union[str, Callable[[torch.Tensor], Any]] = "torch"
_VALID = ("torch", "numpy")


def set_output_as(output) -> None:
    """Set the output type of the API's returns: "torch" (the default),
    "numpy", or a callable tensor -> Any."""
    global _OUTPUT_AS
    if not callable(output) and output not in _VALID:
        raise ValueError(f"output must be one of {_VALID} or a callable, got {output!r}")
    _OUTPUT_AS = output


def get_output_as():
    return _OUTPUT_AS


def _convert_one(x: Any) -> Any:
    if not isinstance(x, torch.Tensor):
        return x
    out = _OUTPUT_AS
    if callable(out):
        return out(x)
    if out == "numpy":
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return x


def convert_output(value: Any) -> Any:
    """A return value (tensor, or tuple / list / dict of them) converted
    to the configured output type; other leaves pass through."""
    if isinstance(value, tuple):
        converted = [convert_output(v) for v in value]
        if hasattr(value, "_fields"):  # namedtuple: positional construction
            return type(value)(*converted)
        return type(value)(converted)
    if isinstance(value, list):
        return [convert_output(v) for v in value]
    if isinstance(value, dict):
        return {k: convert_output(v) for k, v in value.items()}
    return _convert_one(value)


def auto_convert_output(fn: Callable) -> Callable:
    """Decorator applying `convert_output` to a function's return value,
    at the OUTERMOST decorated call only: library code that chains public
    calls sees tensors, and the caller gets one conversion."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if getattr(_TLS, "depth", 0):
            return fn(*args, **kwargs)
        _TLS.depth = 1
        try:
            return convert_output(fn(*args, **kwargs))
        finally:
            _TLS.depth = 0

    return wrapper
