"""RNG state and distributions on explicit `torch.Generator`s (counterpart
of raft_tpu/random/rng.py; random/rng_state.hpp:28-52, rng.cuh:44-576).

The JAX package threads functional PRNG keys; the port threads a
`torch.Generator` on the device the draws land on. Every distribution
takes an `RngState` (whose generator each draw advances) or a generator
itself. The numbers differ from the JAX package's for the same seed by
construction (another generator); the distributions are the same, and
the tests hold them by their moments and KS tests, not bits.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from raft_tpu_torch.core.config import resolve_device


def make_generator(seed: int, device) -> torch.Generator:
    """A generator on `device` (CUDA draws need a CUDA generator)."""
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed))
    return g


class RngState:
    """`RngState{seed, base_subsequence}` parity: a seeded generator on
    `device` (the card unless told otherwise); each draw advances its
    stream. `generator` names the generator family, as in the JAX
    package (kept for the record: torch's device generator draws), or
    is a `torch.Generator` to adopt."""

    def __init__(self, seed: int = 0, generator: Union[str, torch.Generator] = "philox",
                 device=None):
        self.seed = seed
        if isinstance(generator, torch.Generator):
            self.generator = generator.device.type
            self._gen = generator
        else:
            self.generator = generator
            self._gen = make_generator(seed, resolve_device(device))

    def advance(self) -> torch.Generator:
        """The generator the next draw advances."""
        return self._gen

    @property
    def key(self) -> torch.Generator:
        return self._gen

    @property
    def device(self) -> torch.device:
        return self._gen.device


State = Union[RngState, torch.Generator]


def generator_of(state, generator: Optional[torch.Generator]) -> Optional[torch.Generator]:
    """A generator function's draws: the JAX package's `state=` (an
    `RngState` or a generator) or the port's `generator=`, at most one of
    them; None where neither is given (the function seeds its own)."""
    if state is None:
        return generator
    if generator is not None:
        raise ValueError("pass state= or generator=, not both")
    return _gen_of(state)


def _gen_of(state: State) -> torch.Generator:
    if isinstance(state, RngState):
        return state.advance()
    if isinstance(state, torch.Generator):
        return state
    raise TypeError(f"expected an RngState or a torch.Generator, got {type(state).__name__}")


def _shape(shape) -> Tuple[int, ...]:
    return (int(shape),) if isinstance(shape, int) else tuple(int(s) for s in shape)


def _open_uniform(g: torch.Generator, shape, dtype=torch.float32) -> torch.Tensor:
    """U(0, 1) with 0 excluded (the logarithms below need it)."""
    u = torch.rand(_shape(shape), generator=g, device=g.device, dtype=dtype)
    return torch.clamp(u, min=torch.finfo(dtype).tiny)


def uniform(state, shape, low=0.0, high=1.0, dtype=torch.float32) -> torch.Tensor:
    g = _gen_of(state)
    u = torch.rand(_shape(shape), generator=g, device=g.device, dtype=dtype)
    return low + (high - low) * u


def uniform_int(state, shape, low, high, dtype=torch.int32) -> torch.Tensor:
    g = _gen_of(state)
    return torch.randint(int(low), int(high), _shape(shape), generator=g, device=g.device,
                         dtype=dtype)


def normal(state, shape, mu=0.0, sigma=1.0, dtype=torch.float32) -> torch.Tensor:
    g = _gen_of(state)
    return mu + sigma * torch.randn(_shape(shape), generator=g, device=g.device, dtype=dtype)


def normal_int(state, shape, mu, sigma, dtype=torch.int32) -> torch.Tensor:
    return torch.round(normal(state, shape, mu, sigma)).to(dtype)


def normal_table(state, n_rows, mu_vec, sigma_vec=None, dtype=torch.float32) -> torch.Tensor:
    """Per-column mu / sigma gaussian table (rng.cuh normalTable)."""
    g = _gen_of(state)
    mu = torch.as_tensor(mu_vec, dtype=dtype, device=g.device)
    sigma = (torch.ones_like(mu) if sigma_vec is None
             else torch.as_tensor(sigma_vec, dtype=dtype, device=g.device))
    z = torch.randn((int(n_rows), mu.shape[0]), generator=g, device=g.device, dtype=dtype)
    return mu[None, :] + sigma[None, :] * z


def bernoulli(state, shape, prob=0.5, dtype=torch.bool) -> torch.Tensor:
    return (uniform(state, shape) < prob).to(dtype)


def scaled_bernoulli(state, shape, prob, scale, dtype=torch.float32) -> torch.Tensor:
    b = uniform(state, shape) < prob
    return torch.where(b, scale, -scale).to(dtype)


def gumbel(state, shape, mu=0.0, beta=1.0, dtype=torch.float32) -> torch.Tensor:
    g = _gen_of(state)
    return mu + beta * -torch.log(-torch.log(_open_uniform(g, shape, dtype)))


def lognormal(state, shape, mu=0.0, sigma=1.0, dtype=torch.float32) -> torch.Tensor:
    return torch.exp(normal(state, shape, mu, sigma, dtype=dtype))


def logistic(state, shape, mu=0.0, scale=1.0, dtype=torch.float32) -> torch.Tensor:
    g = _gen_of(state)
    u = _open_uniform(g, shape, dtype)
    return mu + scale * (torch.log(u) - torch.log1p(-u))


def exponential(state, shape, lambda_=1.0, dtype=torch.float32) -> torch.Tensor:
    g = _gen_of(state)
    return -torch.log(_open_uniform(g, shape, dtype)) / lambda_


def rayleigh(state, shape, sigma=1.0, dtype=torch.float32) -> torch.Tensor:
    u = uniform(state, shape, low=1e-7, high=1.0, dtype=dtype)
    return sigma * torch.sqrt(-2.0 * torch.log(u))


def laplace(state, shape, mu=0.0, scale=1.0, dtype=torch.float32) -> torch.Tensor:
    g = _gen_of(state)
    u = _open_uniform(g, shape, dtype) - 0.5
    return mu - scale * torch.sign(u) * torch.log1p(-2.0 * torch.abs(u))


def discrete(state, shape, weights) -> torch.Tensor:
    """int32 indices drawn with the given unnormalized weights (rng.cuh
    discrete)."""
    g = _gen_of(state)
    w = torch.clamp(torch.as_tensor(weights, dtype=torch.float32, device=g.device), min=0.0)
    shp = _shape(shape)
    n = math.prod(shp)
    out = torch.multinomial(w, n, replacement=True, generator=g) if n else \
        torch.zeros((0,), dtype=torch.int64, device=g.device)
    return out.to(torch.int32).reshape(shp)


def permute(state, n: int) -> torch.Tensor:
    """Random permutation of [0, n), int32 (random/permute.cuh)."""
    g = _gen_of(state)
    return torch.randperm(int(n), generator=g, device=g.device).to(torch.int32)


def shuffle_rows(state, matrix) -> Tuple[torch.Tensor, torch.Tensor]:
    """(rows in a random order, the int32 permutation)."""
    g = _gen_of(state)
    m = torch.as_tensor(matrix, device=g.device)
    perm = torch.randperm(m.shape[0], generator=g, device=g.device)
    return m[perm], perm.to(torch.int32)


def sample_without_replacement(state, n_population: int, n_samples: int,
                               weights: Optional[torch.Tensor] = None) -> torch.Tensor:
    """k-of-n sampling without replacement (rng.cuh:sampleWithoutReplacement),
    int32 indices on the generator's device, as the JAX function returns.
    Uniform: the first `n_samples`
    of a random permutation. Weighted: the Gumbel-top-k race (the
    order-statistics method the reference implements with per-item keys),
    keys log(w) + Gumbel noise."""
    g = _gen_of(state)
    if not 0 <= n_samples <= n_population:
        raise ValueError(f"cannot draw {n_samples} of {n_population} without replacement")
    if weights is None:
        perm = torch.randperm(n_population, generator=g, device=g.device)
        return perm[:n_samples].to(torch.int32)
    w = torch.as_tensor(weights, dtype=torch.float32, device=g.device)
    keys = gumbel(g, (n_population,)) + torch.log(torch.clamp(w, min=1e-30))
    return torch.topk(keys, n_samples).indices.to(torch.int32)


def multi_variable_gaussian(state, mean, cov, n_samples: int) -> torch.Tensor:
    """Samples from N(mean, cov) (random/multi_variable_gaussian.cuh), by
    the SVD factor of cov, as the JAX package's method="svd"."""
    g = _gen_of(state)
    mu = torch.as_tensor(mean, dtype=torch.float32, device=g.device)
    c = torch.as_tensor(cov, dtype=torch.float32, device=g.device)
    u, s, _ = torch.linalg.svd(c)
    factor = u * torch.sqrt(s)[None, :]
    z = torch.randn((int(n_samples), mu.shape[0]), generator=g, device=g.device)
    from raft_tpu_torch.core.config import strict_f32_matmul

    strict_f32_matmul()
    return mu[None, :] + z @ factor.T
