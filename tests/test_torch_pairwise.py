"""PyTorch port: pairwise distances and the tiled kernel's plain version
against the JAX package on the same numpy inputs.

- `pairwise_tiled_plain` (what the CUDA kernel is held against on the
  card) against the JAX Pallas kernel `pairwise_tiled(..., interpret=True)`,
  for all seven metrics, at a ragged shape (33 x 47 x 10) and at k = 1.
- The port's public `pairwise_distance` against the JAX one for every
  metric name in `DISTANCE_TYPES`.

Tolerance: rtol 1e-5 with atol 1e-5 times the row's largest value, for
summation order (the two packages add the terms in another order). Linf
and hamming must be exact: a max, and a count times the f32 reciprocal
of k. On integer-grid data every term of l1, linf, the two unexpanded L2
and hamming is exact, as is every canberra term on values in {0, 1, 3}
(0, 1/2 or 1), so those sums must be bit-equal too; KL's terms are
logarithms, exact on no grid, and keep the tolerance. The expanded
metrics' public results are exact on the grid where they involve no
square root or division (sqeuclidean, inner product).
"""

import numpy as np
import pytest

import torch

from raft_tpu.distance.distance_types import DISTANCE_TYPES
from raft_tpu.distance.pairwise import pairwise_distance as jax_pairwise_distance
from raft_tpu.ops.pairwise_pallas import METRIC_OPS as JAX_METRIC_OPS
from raft_tpu.ops.pairwise_pallas import pairwise_tiled as jax_pairwise_tiled
from raft_tpu_torch.distance import pairwise as tpw
from raft_tpu_torch.ops import pairwise_tiled as tpt

_EXACT_ALWAYS = {"linf", "hamming"}
_EXACT_ON_GRID = {"l1", "linf", "l2_unexpanded", "l2_sqrt_unexpanded", "hamming", "canberra"}
_KERNEL_NAMES = {"l1", "cityblock", "manhattan", "taxicab", "chebyshev", "linf", "canberra",
                 "hamming", "kl_divergence", "kldivergence", "sqeuclidean_unexpanded",
                 "euclidean_unexpanded"}


def _assert_close(got, want, exact):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    if exact:
        np.testing.assert_array_equal(got, want)
        return
    fin = np.isfinite(want)
    np.testing.assert_array_equal(got[~fin], want[~fin])
    scale = np.where(fin, np.abs(want), 0.0).max(axis=1, keepdims=True)
    err = np.abs(np.where(fin, got - want, 0.0))
    assert np.all(err <= 1e-5 * np.abs(np.where(fin, want, 0.0)) + 1e-5 * scale)


def _operands(rng, metric, m, n, k, grid):
    if grid:
        vals = np.array([0, 1, 3], np.float32) if metric == "canberra" else np.arange(-3, 4)
        x = rng.choice(vals, (m, k)).astype(np.float32)
        y = rng.choice(vals, (n, k)).astype(np.float32)
        if metric == "kl_divergence":
            x, y = np.abs(x), np.abs(y)
        return x, y
    if metric == "kl_divergence":
        # distributions with zeros: the zero guards decide those terms
        x = rng.random((m, k)).astype(np.float32) * (rng.random((m, k)) > 0.3)
        y = rng.random((n, k)).astype(np.float32) * (rng.random((n, k)) > 0.3)
        x /= np.maximum(x.sum(1, keepdims=True), 1e-6)
        y /= np.maximum(y.sum(1, keepdims=True), 1e-6)
        return x.astype(np.float32), y.astype(np.float32)
    if metric == "hamming":
        return (rng.integers(0, 3, (m, k)).astype(np.float32),
                rng.integers(0, 3, (n, k)).astype(np.float32))
    x = rng.standard_normal((m, k)).astype(np.float32)
    y = rng.standard_normal((n, k)).astype(np.float32)
    if metric == "canberra":
        x[0, :] = 0.0  # zero denominators against y's zeros
        y[:3, :2] = 0.0
    return x, y


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("k", [10, 1])
@pytest.mark.parametrize("metric", sorted(tpt.METRIC_OPS))
def test_pairwise_tiled_plain_matches_jax_kernel(rng, metric, k, grid):
    assert set(tpt.METRIC_OPS) == set(JAX_METRIC_OPS)
    x, y = _operands(rng, metric, 33, 47, k, grid)
    want = jax_pairwise_tiled(x, y, metric, bm=16, bn=128, interpret=True)
    got = tpt.pairwise_tiled(torch.tensor(x), torch.tensor(y), metric)
    exact = metric in _EXACT_ALWAYS or (grid and metric in _EXACT_ON_GRID)
    _assert_close(got.numpy(), want, exact)


def test_pairwise_tiled_casts_inputs_to_f32_first(rng):
    """The kernel's operands are the f32 cast of any input dtype."""
    x = rng.integers(-100, 100, (9, 12)).astype(np.int16)
    y = rng.integers(-100, 100, (14, 12)).astype(np.int16)
    got = tpt.pairwise_tiled(torch.tensor(x), torch.tensor(y), "l1")
    want = jax_pairwise_tiled(x.astype(np.float32), y.astype(np.float32), "l1", bm=16, bn=128,
                              interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _public_operands(rng, name, grid):
    m, n, k = 21, 34, 6
    if grid:
        vals = np.array([0, 1, 3]) if name == "canberra" else np.arange(4)
        x = rng.choice(vals, (m, k)).astype(np.float32)
        y = rng.choice(vals, (n, k)).astype(np.float32)
    else:
        x = rng.standard_normal((m, k)).astype(np.float32)
        y = rng.standard_normal((n, k)).astype(np.float32)
    if name in ("jaccard", "dice", "russellrao"):  # binary semantics
        x, y = (x > 0.5).astype(np.float32), (y > 0.5).astype(np.float32)
    if name in ("hellinger", "kl_divergence", "kldivergence", "jensenshannon", "braycurtis"):
        x, y = np.abs(x), np.abs(y)
    if name in ("hellinger", "kl_divergence", "kldivergence", "jensenshannon"):
        x = x / np.maximum(x.sum(1, keepdims=True), 1e-6)
        y = y / np.maximum(y.sum(1, keepdims=True), 1e-6)
    if name == "haversine":
        x, y = x[:, :2] * 0.5, y[:, :2] * 0.5
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("grid", [False, True])
@pytest.mark.parametrize("name", sorted(DISTANCE_TYPES))
def test_pairwise_distance_matches_jax_for_every_metric_name(rng, name, grid):
    x, y = _public_operands(rng, name, grid)
    kw = {"p": 3.0} if name in ("lp", "minkowski") else {}
    want = jax_pairwise_distance(x, y, metric=name, **kw)
    got = tpw.pairwise_distance(x, y, metric=name, device="cpu", **kw)
    key = tpw._KERNEL_METRICS.get(tpw.resolve_metric(name))
    exact = (key in _EXACT_ALWAYS
             or (grid and (key in _EXACT_ON_GRID or name in ("sqeuclidean", "inner_product"))))
    _assert_close(got.numpy(), want, exact)


def test_kernel_metric_table_matches_jax():
    from raft_tpu.distance.pairwise import _PALLAS_METRICS

    assert {int(k): v for k, v in tpw._KERNEL_METRICS.items()} == {
        int(k): v for k, v in _PALLAS_METRICS.items()}
    assert {n for n in DISTANCE_TYPES
            if tpw.resolve_metric(n) in tpw._KERNEL_METRICS} == _KERNEL_NAMES


def test_tiled_rowwise_blocks_rows_within_budget(rng):
    """Row blocks of the broadcast engine cover every row once, at any
    budget (a small one forces many blocks, a ragged last one)."""
    x = rng.standard_normal((37, 5)).astype(np.float32)
    y = rng.standard_normal((11, 5)).astype(np.float32)
    xt, yt = torch.tensor(x), torch.tensor(y)
    full = tpw._tiled_rowwise(xt, yt, tpw._braycurtis_row)
    small = tpw._tiled_rowwise(xt, yt, tpw._braycurtis_row, budget_elems=100)
    np.testing.assert_array_equal(full.numpy(), small.numpy())
    assert tpw._block_rows(37, 11, 5, budget_elems=100) == 1
    assert tpw._block_rows(1000, 10, 10) == 1000


def test_pairwise_distance_checks_like_jax(rng):
    x = rng.standard_normal((5, 3)).astype(np.float32)
    y = rng.standard_normal((4, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        tpw.pairwise_distance(x, y, metric=tpw.DistanceType.Precomputed, device="cpu").numpy(), x)
    np.testing.assert_array_equal(
        tpw.pairwise_distance(x, y, metric=100, device="cpu").numpy(), x)
    with pytest.raises(ValueError, match="haversine"):
        tpw.pairwise_distance(x, y, metric="haversine", device="cpu")
    with pytest.raises(ValueError):
        tpw.pairwise_distance(x, y[:, :2], metric="l1", device="cpu")
    with pytest.raises(ValueError):
        tpw.pairwise_distance(x, y, metric="nope", device="cpu")
    with pytest.raises(ValueError, match="out"):
        tpw.pairwise_distance(x, y, out=torch.empty((4, 5)), metric="l1", device="cpu")
    got = tpw.pairwise_distance(x, y, out=np.empty((5, 4)), metric="l1", device="cpu")
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax_pairwise_distance(x, y, metric="l1", out=np.empty((5, 4)))))


# -- canberra and KL on the inputs the card kernel's fast paths must survive --

_TINY = np.float32(np.finfo(np.float32).tiny)  # the smallest normal f32


def _edge_operands(rng, metric, case, m=13, n=21, k=19):
    """Rows of zeros beside "denormals" (magnitudes below 2^-126), "1e-30"
    or "equal rows" (rows of y that are rows of x, at ordinary
    magnitudes); canberra with both signs, KL positive."""
    scale = {"denormals": 1e-39, "1e-30": 1e-30, "equal rows": 1.0}[case]
    x = rng.random((m, k)) * scale
    y = rng.random((n, k)) * scale
    if metric == "canberra":
        x *= rng.choice([-1.0, 1.0], x.shape)
        y *= rng.choice([-1.0, 1.0], y.shape)
    x[:, ::3], y[:, ::4] = 0.0, 0.0
    x[1], y[2] = 0.0, 0.0  # whole rows of zeros: 0/0 and KL's guards
    y[5:9] = x[3:7]
    return x.astype(np.float32), y.astype(np.float32)


def _flush(a):
    """Subnormals to signed zero, as XLA on the CPU treats them."""
    return np.where(np.abs(a) < _TINY, np.float32(0) * a, a).astype(np.float32)


@pytest.mark.parametrize("case", ["denormals", "1e-30", "equal rows"])
@pytest.mark.parametrize("metric", ["canberra", "kl_divergence"])
def test_canberra_and_kl_plain_match_jax_on_edge_rows(rng, metric, case):
    """The plain version (the card kernel's yardstick) against the JAX
    kernel. XLA on the CPU flushes subnormal inputs and results to zero;
    the port keeps IEEE subnormals, as torch does. On subnormal rows the
    JAX result is then that of the flushed rows, which the port gives on
    flushed rows; the port's own result on the rows themselves is held to
    float64 numpy. Equal rows give exactly 0 in both packages."""
    x, y = _edge_operands(rng, metric, case)
    want = np.asarray(jax_pairwise_tiled(x, y, metric, bm=16, bn=128, interpret=True))
    got = tpt.pairwise_tiled(torch.tensor(x), torch.tensor(y), metric).numpy()
    if case == "denormals":
        flushed = tpt.pairwise_tiled(torch.tensor(_flush(x)), torch.tensor(_flush(y)), metric)
        _assert_close(_flush(flushed.numpy()), want, exact=False)
        a, b = x.astype(np.float64)[:, None, :], y.astype(np.float64)[None, :, :]
        if metric == "canberra":
            den = np.abs(a) + np.abs(b)
            terms = np.where(den > 0, np.abs(a - b) / np.where(den > 0, den, 1.0), 0.0)
        else:
            safe = (a > 0) & (b > 0)
            terms = np.where(safe, a * np.log(np.where(safe, a / np.where(safe, b, 1.0), 1.0)),
                             0.0)
        truth = terms.sum(-1)
        scale = np.abs(truth).max(axis=1, keepdims=True)
        assert np.all(np.abs(got - truth) <= 1e-4 * np.abs(truth) + 1e-4 * scale)
        assert np.any(got != 0)  # subnormals kept, not flushed
    else:
        _assert_close(got, want, exact=False)
    eq = np.arange(4)
    assert np.all(got[3 + eq, 5 + eq] == 0) and np.all(want[3 + eq, 5 + eq] == 0)
    assert np.all(got[1][np.all(y == 0, axis=1)] == 0)  # zero row against zero row


def _near_identical(rng, delta, m=13, n=21, k=97):
    """Rows close to each other in every column: one profile times
    1 + delta gaussian noise, each row normalised to sum 1; rows 5-8 of y
    are rows 3-6 of x."""
    base = rng.random(k) + 0.5
    x = base * (1 + delta * rng.standard_normal((m, k)))
    y = base * (1 + delta * rng.standard_normal((n, k)))
    x, y = x / x.sum(1, keepdims=True), y / y.sum(1, keepdims=True)
    y[5:9] = x[3:7]
    return x.astype(np.float32), y.astype(np.float32)


@pytest.mark.parametrize("delta", [1e-2, 3e-2])
@pytest.mark.parametrize("metric", ["canberra", "kl_divergence"])
def test_canberra_and_kl_plain_match_jax_on_near_identical_rows(rng, metric, delta):
    """KL between rows this close sums terms ~delta a of both signs to
    ~delta^2 / 2; both packages round a / b once (IEEE), so they agree to
    the tolerance, and equal rows give exactly 0."""
    x, y = _near_identical(rng, delta)
    want = np.asarray(jax_pairwise_tiled(x, y, metric, bm=16, bn=128, interpret=True))
    got = tpt.pairwise_tiled(torch.tensor(x), torch.tensor(y), metric).numpy()
    _assert_close(got, want, exact=False)
    eq = np.arange(4)
    assert np.all(got[3 + eq, 5 + eq] == 0) and np.all(want[3 + eq, 5 + eq] == 0)


def _fma(a, b, c):
    """f32 fused multiply-add: the product is exact in float64, the sum
    rounded there and then to f32 (a double rounding, rare at these
    magnitudes)."""
    return (a.astype(np.float64) * b.astype(np.float64) + c.astype(np.float64)).astype(np.float32)


def _kl_fast_path_model(x, y):
    """csrc/pairwise_tiled.cu's KL fast path in numpy, for positive rows in
    its range: q = a RN(1/b) refined by two residual steps, its residual
    r, the logarithms staged in two floats each, a (log a - log b) - r a
    term, summed in depth order. Returns (distances, whether every q was
    the correctly rounded a / b)."""
    a, b = x[:, None, :], y[None, :, :]
    a, b = np.broadcast_arrays(a, b)
    rb = np.broadcast_to((np.float32(1) / y)[None, :, :], a.shape)
    la, lb = np.log(x.astype(np.float64)), np.log(y.astype(np.float64))
    la_hi, lb_hi = la.astype(np.float32), lb.astype(np.float32)
    la_lo, lb_lo = (la - la_hi).astype(np.float32), (lb - lb_hi).astype(np.float32)
    q = (a * rb).astype(np.float32)
    r = _fma(-b, q, a)
    q = _fma(r, rb, q)
    r = _fma(-b, q, a)
    q = _fma(r, rb, q)
    r = _fma(-b, q, a)
    d = ((la_hi[:, None, :] - lb_hi[None]).astype(np.float32)
         + (la_lo[:, None, :] - lb_lo[None]).astype(np.float32)).astype(np.float32)
    t = _fma(a, d, -r)
    acc = np.zeros(t.shape[:2], np.float32)
    for c in range(t.shape[2]):
        acc = (acc + t[..., c]).astype(np.float32)
    return acc, bool(np.all(q == (a / b).astype(np.float32)))


@pytest.mark.parametrize("case", ["near-identical 1e-2", "near-identical 3e-2", "random"])
def test_kl_fast_path_arithmetic_holds_the_plain_version(rng, case):
    """The card kernel's KL fast-path arithmetic (modelled in numpy) keeps
    the reference's correctly rounded ratio in every term and meets the
    tolerance the card holds it to against the plain version."""
    if case == "random":
        x, y = rng.random((13, 97)) + 1e-3, rng.random((21, 97)) + 1e-3
        x, y = (t / t.sum(1, keepdims=True) for t in (x, y))
        x, y = x.astype(np.float32), y.astype(np.float32)
    else:
        x, y = _near_identical(rng, float(case.split()[1]))
    got, exact_q = _kl_fast_path_model(x, y)
    want = tpt.pairwise_tiled_plain(torch.tensor(x), torch.tensor(y), "kl_divergence").numpy()
    assert exact_q
    _assert_close(got, want, exact=False)


@pytest.mark.parametrize("delta", [1e-2, 3e-2])
def test_kl_as_a_log_difference_misses_the_tolerance_on_near_identical_rows(rng, delta):
    """Why the card kernel keeps the reference's ratio: a (log a - log b)
    with each logarithm rounded to f32 carries |log a| times their
    rounding a term, and between rows this close that misses the
    tolerance against the plain version."""
    x, y = _near_identical(rng, delta)
    la, lb = np.log(x).astype(np.float32), np.log(y).astype(np.float32)
    terms = x[:, None, :] * (la[:, None, :] - lb[None, :, :])
    got = np.zeros(terms.shape[:2], np.float32)
    for c in range(terms.shape[2]):
        got = (got + terms[..., c]).astype(np.float32)
    want = tpt.pairwise_tiled_plain(torch.tensor(x), torch.tensor(y), "kl_divergence").numpy()
    with pytest.raises(AssertionError):
        _assert_close(got, want, exact=False)
