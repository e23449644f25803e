"""Random sampling on explicit `torch.Generator`s (counterpart of
raft_tpu/random/rng.py).

The JAX package threads functional PRNG keys; the port threads a
`torch.Generator` seeded from the caller's `seed`. The two give different
numbers from the same seed, so tests that compare the packages feed both
the same inputs made with numpy rather than expecting equal draws.
"""

from __future__ import annotations

import torch


def make_generator(seed: int, device) -> torch.Generator:
    """A generator on `device` (CUDA draws need a CUDA generator)."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


def sample_without_replacement(gen: torch.Generator, n_population: int,
                               n_samples: int) -> torch.Tensor:
    """Uniform k-of-n sampling without replacement
    (rng.cuh:sampleWithoutReplacement): the first `n_samples` of a random
    permutation, int64 indices on the generator's device. The weighted
    variant is still to be ported."""
    if not 0 <= n_samples <= n_population:
        raise ValueError(f"cannot draw {n_samples} of {n_population} without replacement")
    return torch.randperm(n_population, generator=gen, device=gen.device)[:n_samples]
