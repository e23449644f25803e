"""Dataset and graph generators: make_regression and RMAT (counterpart of
raft_tpu/random/generators.py; random/make_regression.cuh and
random/rmat_rectangular_generator.cuh, pylibraft `rmat`).

Draws come from a `torch.Generator` on the target device (`state`, an
`RngState` as in the JAX package, or `generator`,
or one seeded with `seed`): the same distributions as the JAX package's,
other numbers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.config import resolve_device
from raft_tpu_torch.random.rng import generator_of, make_generator


def _gen_and_device(seed: int, state, generator, device):
    generator = generator_of(state, generator)
    dev = resolve_device(device if generator is None or device is not None
                         else generator.device)
    return (make_generator(seed, dev) if generator is None else generator), dev


def make_regression(n_samples: int, n_features: int, n_informative: int = 10,
                    n_targets: int = 1, bias: float = 0.0, noise: float = 0.0,
                    effective_rank: Optional[int] = None, tail_strength: float = 0.5,
                    shuffle: bool = True, seed: int = 0, dtype=torch.float32, state=None,
                    generator: Optional[torch.Generator] = None, device=None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Linear-model dataset (make_regression.cuh): (X, y, coef); the
    first `n_informative` coefficients U(0, 100), the others 0."""
    gen, dev = _gen_and_device(seed, state, generator, device)
    n_informative = min(n_informative, n_features)
    X = torch.randn((n_samples, n_features), generator=gen, device=dev)
    if effective_rank is not None:
        # low-rank-ish inputs by spectral decay (the reference's low-rank path)
        u, _, vt = torch.linalg.svd(X, full_matrices=False)
        r = min(n_samples, n_features)
        s = torch.exp(-torch.arange(r, device=dev) / (effective_rank * tail_strength + 1e-6))
        X = (u * s[None, :]) @ vt * torch.sqrt(torch.tensor(float(n_samples), device=dev))
    coef = torch.zeros((n_features, n_targets), dtype=torch.float32, device=dev)
    coef[:n_informative] = 100.0 * torch.rand((n_informative, n_targets), generator=gen,
                                              device=dev)
    y = X @ coef + bias
    if noise > 0:
        y = y + noise * torch.randn(y.shape, generator=gen, device=dev)
    if shuffle:
        perm = torch.randperm(n_samples, generator=gen, device=dev)
        X, y = X[perm], y[perm]
    y = y[:, 0] if n_targets == 1 else y
    return X.to(dtype), y.to(dtype), coef.to(dtype)


def rmat(r_scale: int, c_scale: int, n_edges: int, theta=None, a: float = 0.57,
         b: float = 0.19, c: float = 0.19, seed: int = 0, state=None,
         generator: Optional[torch.Generator] = None, device=None) -> torch.Tensor:
    """RMAT rectangular graph (rmat_rectangular_generator.cuh): (n_edges,
    2) int32 [src, dst]. Each edge picks a quadrant at every level (0 top
    left, 1 top right, 2 bottom left, 3 bottom right) with the level's
    shares of `theta` (or a, b, c, 1 - a - b - c); a level adds its bit to
    the row below r_scale and to the column below c_scale."""
    gen, dev = _gen_and_device(seed, state, generator, device)
    max_scale = max(r_scale, c_scale)
    if theta is not None:
        th = torch.as_tensor(theta, dtype=torch.float32, device=dev).reshape(-1, 4)
        if th.shape[0] == 1:
            th = th.repeat(max_scale, 1)
    else:
        th = torch.tensor([[a, b, c, 1.0 - a - b - c]], dtype=torch.float32,
                          device=dev).repeat(max_scale, 1)
    th = torch.clamp(th, min=0.0)
    cdf = torch.cumsum(th / th.sum(1, keepdim=True), 1)[:, :3]  # (max_scale, 3)
    u = torch.rand((n_edges, max_scale), generator=gen, device=dev)
    quad = (u[..., None] >= cdf[None]).sum(-1)
    levels = torch.arange(max_scale, device=dev)
    r_w = torch.where(levels < r_scale, 2 ** levels, 0)
    c_w = torch.where(levels < c_scale, 2 ** levels, 0)
    src = torch.sum((quad >= 2).long() * r_w, 1)
    dst = torch.sum((quad % 2).long() * c_w, 1)
    return torch.stack([src, dst], 1).to(torch.int32)
