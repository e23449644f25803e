"""Device resolution for the PyTorch port.

Every entry point takes an explicit `device`. The default is the CUDA
card: a caller that wants the CPU says so (`device="cpu"`, as the CPU
parity tests do). Without a card, a default request raises instead of
carrying on quietly on the CPU, so a measurement can never be a CPU
number under a device's name.
"""

from __future__ import annotations

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
