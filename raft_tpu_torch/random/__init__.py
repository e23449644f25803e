"""Random generation (counterpart of raft_tpu/random): the JAX package's
`__all__`, in its order. The port's draws take an `RngState` or a
`torch.Generator` where the JAX package takes its RNG state or key."""

from raft_tpu_torch.random.rng import (
    RngState,
    uniform,
    uniform_int,
    normal,
    normal_int,
    normal_table,
    bernoulli,
    scaled_bernoulli,
    gumbel,
    lognormal,
    logistic,
    exponential,
    rayleigh,
    laplace,
    discrete,
    permute,
    shuffle_rows,
    sample_without_replacement,
    multi_variable_gaussian,
)
from raft_tpu_torch.random.make_blobs import make_blobs
from raft_tpu_torch.random.generators import make_regression, rmat

__all__ = [
    "make_regression",
    "rmat",
    "RngState",
    "uniform",
    "uniform_int",
    "normal",
    "normal_int",
    "normal_table",
    "bernoulli",
    "scaled_bernoulli",
    "gumbel",
    "lognormal",
    "logistic",
    "exponential",
    "rayleigh",
    "laplace",
    "discrete",
    "permute",
    "shuffle_rows",
    "sample_without_replacement",
    "multi_variable_gaussian",
    "make_blobs",
]
