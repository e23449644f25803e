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
