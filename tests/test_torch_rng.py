"""PyTorch port: `random.rng`'s `RngState` and distributions on the CPU.

The port draws from `torch.Generator`s, so its numbers differ from the
JAX package's for the same seed by construction: each continuous
distribution is held by a scipy Kolmogorov-Smirnov test against its
closed form (p > 1e-3 at 20,000 draws; the JAX draws of the same
parameters pass the same test, so both packages sample one law), the
discrete ones by their frequencies and structure, as
tests/test_random.py holds the JAX package.
"""

import numpy as np
import pytest
import scipy.stats as sst
import torch

from raft_tpu import random as jrnd
from raft_tpu_torch import random as trnd

N = 20_000
P_MIN = 1e-3


def _state(seed):
    return trnd.RngState(seed, device="cpu")


# name -> (kwargs, scipy frozen distribution)
CONTINUOUS = {
    "uniform": (dict(low=-1.0, high=3.0), sst.uniform(-1.0, 4.0)),
    "normal": (dict(mu=0.5, sigma=2.0), sst.norm(0.5, 2.0)),
    "lognormal": (dict(mu=0.0, sigma=0.5), sst.lognorm(0.5)),
    "logistic": (dict(mu=1.0, scale=0.5), sst.logistic(1.0, 0.5)),
    "exponential": (dict(lambda_=2.0), sst.expon(scale=0.5)),
    "rayleigh": (dict(sigma=1.5), sst.rayleigh(scale=1.5)),
    "laplace": (dict(mu=-1.0, scale=1.0), sst.laplace(-1.0, 1.0)),
    "gumbel": (dict(mu=0.2, beta=1.5), sst.gumbel_r(0.2, 1.5)),
}


@pytest.mark.parametrize("name", sorted(CONTINUOUS))
def test_continuous_distribution_ks(name):
    kw, law = CONTINUOUS[name]
    x = getattr(trnd, name)(_state(3), (N,), **kw)
    assert x.shape == (N,) and x.dtype == torch.float32 and x.device.type == "cpu"
    assert sst.kstest(x.double().numpy(), law.cdf).pvalue > P_MIN
    jx = np.asarray(getattr(jrnd, name)(jrnd.RngState(3), (N,), **kw), np.float64)
    assert sst.kstest(jx, law.cdf).pvalue > P_MIN


def test_normal_int_and_uniform_int():
    u = trnd.uniform_int(_state(4), (N,), 5, 11)
    assert u.dtype == torch.int32 and int(u.min()) == 5 and int(u.max()) == 10
    freq = np.bincount(u.numpy() - 5, minlength=6) / N
    np.testing.assert_allclose(freq, np.full(6, 1 / 6), atol=0.02)
    ni = trnd.normal_int(_state(5), (N,), 10.0, 3.0)
    assert ni.dtype == torch.int32
    assert abs(float(ni.float().mean()) - 10.0) < 0.1


def test_bernoulli_and_scaled():
    b = trnd.bernoulli(_state(1), (N,), prob=0.3)
    assert b.dtype == torch.bool and abs(float(b.float().mean()) - 0.3) < 0.02
    s = trnd.scaled_bernoulli(_state(2), (N,), prob=0.25, scale=2.0)
    assert set(np.unique(s.numpy()).tolist()) <= {-2.0, 2.0}
    assert abs(float((s > 0).float().mean()) - 0.25) < 0.02


def test_discrete_frequencies():
    w = np.array([0.1, 0.0, 0.6, 0.3])
    d = trnd.discrete(_state(6), (200, 100), w)
    assert d.shape == (200, 100) and d.dtype == torch.int32
    freq = np.bincount(d.numpy().ravel(), minlength=4) / d.numel()
    assert freq[1] == 0.0
    np.testing.assert_allclose(freq, w, atol=0.02)


def test_normal_table_columns():
    mu = np.array([0.0, 5.0, -3.0], np.float32)
    sig = np.array([1.0, 0.1, 2.0], np.float32)
    t = trnd.normal_table(_state(7), N, mu, sig).numpy()
    np.testing.assert_allclose(t.mean(axis=0), mu, atol=0.05)
    np.testing.assert_allclose(t.std(axis=0), sig, rtol=0.05)


def test_permute_and_shuffle_rows():
    p = trnd.permute(_state(8), 1000)
    assert p.dtype == torch.int32 and sorted(p.tolist()) == list(range(1000))
    m = np.arange(50, dtype=np.float32).reshape(10, 5)
    shuffled, perm = trnd.shuffle_rows(_state(9), m)
    np.testing.assert_array_equal(shuffled.numpy(), m[perm.numpy()])


def test_sample_without_replacement_uniform_and_weighted():
    s = trnd.sample_without_replacement(_state(10), 500, 64)
    assert len(set(s.tolist())) == 64 and 0 <= int(s.min()) and int(s.max()) < 500
    means = [float(trnd.sample_without_replacement(_state(t), 4096, 64).float().mean())
             for t in range(20)]
    assert abs(np.mean(means) - 2047.5) < 150
    # weighted: zero weights never drawn; inclusion grows with the weight
    w = np.zeros(1000, np.float32)
    w[:100] = 1.0
    w[100:200] = 9.0
    hits = np.zeros(1000)
    g = torch.Generator().manual_seed(11)
    for _ in range(200):
        got = trnd.sample_without_replacement(g, 1000, 20, weights=w).numpy()
        assert len(set(got.tolist())) == 20
        hits[got] += 1
    assert hits[200:].sum() == 0
    assert hits[100:200].sum() > 4 * hits[:100].sum()
    with pytest.raises(ValueError):
        trnd.sample_without_replacement(g, 5, 6)


@pytest.mark.parametrize("n_population,n_samples,weighted", [
    (500, 64, False),    # the JAX permutation branch
    (4096, 64, False),   # the JAX top-k-of-bits branch
    (1000, 20, True),
])
def test_sample_without_replacement_dtype_matches_jax(n_population, n_samples, weighted):
    w = np.linspace(0.5, 2.0, n_population).astype(np.float32) if weighted else None
    jx = jrnd.sample_without_replacement(jrnd.RngState(4), n_population, n_samples,
                                         weights=w)
    got = trnd.sample_without_replacement(_state(4), n_population, n_samples, weights=w)
    assert got.dtype == torch.int32
    assert str(got.dtype).split(".")[-1] == np.asarray(jx).dtype.name
    assert got.shape == tuple(jx.shape)


def test_multi_variable_gaussian_covariance():
    cov = np.array([[2.0, 0.8], [0.8, 1.0]], np.float32)
    x = trnd.multi_variable_gaussian(_state(12), np.array([1.0, -1.0], np.float32), cov, 40_000)
    np.testing.assert_allclose(np.cov(x.numpy().T), cov, atol=0.05)
    np.testing.assert_allclose(x.numpy().mean(0), [1.0, -1.0], atol=0.03)


def test_rng_state_streams_differ_and_reproduce():
    a = trnd.uniform(_state(11), (64,))
    b = trnd.uniform(_state(11), (64,))
    c = trnd.uniform(_state(12), (64,))
    assert torch.equal(a, b) and not torch.equal(a, c)
    st = _state(13)
    assert not torch.equal(trnd.uniform(st, (64,)), trnd.uniform(st, (64,)))
    assert st.key is st.advance() and st.device == torch.device("cpu")
    assert st.seed == 13 and isinstance(st.generator, str)
    # a generator passed in is adopted, and a bare generator is a state too
    g = torch.Generator().manual_seed(5)
    adopted = trnd.RngState(0, generator=g)
    assert adopted.key is g
    x = trnd.normal(adopted, (8,))
    assert torch.equal(x, trnd.normal(torch.Generator().manual_seed(5), (8,)))
    with pytest.raises(TypeError):
        trnd.uniform(3, (2,))


def test_random_exports_the_jax_all():
    assert trnd.__all__ == jrnd.__all__
