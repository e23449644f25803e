"""PyTorch port: select_k and scan_select_k against the JAX package.

The tie rule is the point: equal values go to the smaller index, as
`lax.top_k` orders them. Rows full of exact ties must give the same ids
in both packages, min and max, on every strategy. Inputs come from numpy
and go through both packages; the port runs on the CPU. Indices are
int32 in both packages; `scan_select_k(strategy=None | "auto")`
resolves as the JAX package does without a tuned value.
"""

import numpy as np
import pytest

import torch

from raft_tpu.matrix import select_k as jax_select_k
from raft_tpu.matrix.select_k import resolve_scan_strategy as jax_resolve_scan_strategy
from raft_tpu.matrix.select_k import scan_select_k as jax_scan_select_k
from raft_tpu_torch.matrix.select_k import resolve_scan_strategy, scan_select_k, select_k


def _rows(rng, kind, shape):
    if kind == "ties":
        # few distinct values: nearly every selected slot is a tie
        return rng.integers(0, 5, shape).astype(np.float32)
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("strategy", [None, "topk", "two_phase"])
@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("kind", ["random", "ties"])
@pytest.mark.parametrize("k", [1, 7, 64])
def test_select_k_matches_jax_exactly(rng, kind, select_min, strategy, k):
    vals = _rows(rng, kind, (6, 700))
    jv, ji = jax_select_k(vals, k, select_min=select_min, strategy=strategy)
    tv, ti = select_k(vals, k, select_min=select_min, strategy=strategy, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("select_min", [True, False])
def test_select_k_two_phase_long_rows_keep_tie_rule(rng, select_min):
    """Rows past 2 * 16384 take the chunked two-phase path in both
    packages; ties must still resolve to the smaller index."""
    vals = _rows(rng, "ties", (2, 40000))
    jv, ji = jax_select_k(vals, 50, select_min=select_min, strategy="two_phase")
    tv, ti = select_k(vals, 50, select_min=select_min, strategy="two_phase", device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_select_k_maps_caller_indices_and_squeezes(rng):
    vals = rng.standard_normal(50).astype(np.float32)
    ids = np.arange(1000, 1050)
    jv, ji = jax_select_k(vals, 5, indices=ids)
    tv, ti = select_k(vals, 5, indices=ids, device="cpu")
    assert tv.shape == (5,)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


def test_select_k_rejects_bad_requests(rng):
    vals = rng.standard_normal((2, 10)).astype(np.float32)
    with pytest.raises(ValueError):
        select_k(vals, 11, device="cpu")
    with pytest.raises(ValueError):
        select_k(vals, 3, strategy="nope", device="cpu")
    with pytest.raises(ValueError, match="f32-embeddable"):
        select_k(vals.astype(np.float64), 3, strategy="counting", device="cpu")


def _signed_zero_rows(rng, shape):
    """Rows of +-0.0 with a few +-1.0: nearly every selected slot is a tie
    under `==`, and only the total order (-0.0 before +0.0) separates
    them."""
    vals = rng.choice(np.array([0.0, -0.0, 1.0, -1.0], np.float32), shape,
                      p=[0.499, 0.499, 0.001, 0.001])
    return vals.astype(np.float32)


def test_select_k_signed_zeros_follow_the_total_order():
    row = np.array([[0.0, -0.0, 1.0, 0.0, -0.0]], np.float32)
    assert select_k(row, 3, device="cpu")[1].tolist() == [[1, 4, 0]]
    assert select_k(row, 3, select_min=False, device="cpu")[1].tolist() == [[2, 0, 3]]


@pytest.mark.parametrize("strategy", [None, "topk", "two_phase"])
@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("length,k", [(700, 7), (700, 300), (40000, 50)])
def test_select_k_signed_zeros_match_jax(rng, strategy, select_min, length, k):
    """-0.0 ranks strictly before +0.0, as in `lax.top_k`; the long rows
    take the chunked two-phase path in both packages."""
    vals = _signed_zero_rows(rng, (3, length))
    jv, ji = jax_select_k(vals, k, select_min=select_min, strategy=strategy)
    tv, ti = select_k(vals, k, select_min=select_min, strategy=strategy, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (tv.numpy() == np.asarray(jv)).all()
    np.testing.assert_array_equal(np.signbit(tv.numpy()), np.signbit(np.asarray(jv)))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16, torch.float64])
def test_select_k_order_key_keeps_dtype_and_total_order(dtype):
    row = torch.tensor([[0.0, -0.0, -2.0, 1.0, -0.0, 0.0]], dtype=dtype)
    v, i = select_k(row, 4, device="cpu")
    assert v.dtype == dtype
    assert i.tolist() == [[2, 1, 4, 0]]
    assert torch.signbit(v).tolist() == [[True, True, True, False]]


def test_brute_force_tile_merge_keeps_signed_zero_order(rng):
    """Inner products of +-1 against +-0.0 rows are signed zeros in both
    packages; the per-tile selects and the running merge must rank +0.0
    before -0.0 (a similarity: largest first) and keep index order among
    equal keys across tiles."""
    from raft_tpu.distance.distance_types import resolve_metric as jax_resolve_metric
    from raft_tpu.neighbors.brute_force import _bf_knn_impl as jax_bf_knn_impl
    from raft_tpu_torch.neighbors import brute_force as tbf

    ds = rng.choice(np.array([0.0, -0.0], np.float32), (1000, 1)).astype(np.float32)
    q = np.array([[-1.0], [1.0], [0.0], [-0.0]], np.float32)
    jv, ji = jax_bf_knn_impl(ds, q, 10, jax_resolve_metric("inner_product"), tile=128)
    tv, ti = tbf._bf_knn_impl(torch.tensor(ds), torch.tensor(q), 10,
                              tbf.resolve_metric("inner_product"), tile=128)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert (tv.numpy() == np.asarray(jv)).all()


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product"])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_scan_select_k_fused_plain_agrees_with_two_phase(rng, metric, k):
    """On bf16-exact integer data the fused path's rounding is a no-op
    and every dot is exact, so fused and two-phase agree bit for bit."""
    x = rng.integers(-8, 8, (29, 33)).astype(np.float32)
    y = rng.integers(-8, 8, (517, 33)).astype(np.float32)
    vf, jf = scan_select_k(x, y, k, metric=metric, strategy="fused", device="cpu")
    vr, jr = scan_select_k(x, y, k, metric=metric, strategy="two_phase", device="cpu")
    np.testing.assert_array_equal(jf.numpy(), jr.numpy())
    np.testing.assert_array_equal(vf.numpy(), vr.numpy())
    assert jf.dtype == torch.int32


def test_scan_select_k_fused_rejects_unsupported_metric(rng):
    x = rng.standard_normal((4, 8)).astype(np.float32)
    with pytest.raises(ValueError):
        scan_select_k(x, x, 2, metric="l1", strategy="fused", device="cpu")
    with pytest.raises(ValueError):
        scan_select_k(x, x, 300, strategy="fused", device="cpu")


# --- public call shapes: the strategy resolver and the index dtype ---------


@pytest.mark.parametrize("strategy", [None, "auto"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product", "l1"])
def test_scan_select_k_resolves_none_and_auto_like_jax(rng, strategy, metric):
    """None/"auto" resolve as the JAX package does without a tuned value
    ("two_phase"); on integer grids every distance is exact, so ids (ties
    included) and values match."""
    x = rng.integers(-5, 6, (13, 9)).astype(np.float32)
    y = rng.integers(-5, 6, (300, 9)).astype(np.float32)
    jv, ji = jax_scan_select_k(x, y, 8, metric=metric, strategy=strategy)
    tv, ti = scan_select_k(x, y, 8, metric=metric, strategy=strategy, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.dtype == torch.int32
    rv, ri = scan_select_k(x, y, 8, metric=metric, strategy="two_phase", device="cpu")
    np.testing.assert_array_equal(ti.numpy(), ri.numpy())


def test_resolve_scan_strategy_matches_jax():
    for strategy in (None, "auto", "fused", "two_phase"):
        for fused_ok in (True, False):
            assert (resolve_scan_strategy(1000, 96, 10, strategy, fused_ok=fused_ok)
                    == jax_resolve_scan_strategy(1000, 96, 10, strategy, fused_ok=fused_ok))
    assert resolve_scan_strategy(1000, 96, 10) == "two_phase"
    with pytest.raises(ValueError):
        resolve_scan_strategy(1000, 96, 10, "nope")
    with pytest.raises(ValueError):
        scan_select_k(np.ones((2, 3), np.float32), np.ones((5, 3), np.float32), 2,
                      strategy="nope", device="cpu")


@pytest.mark.parametrize("strategy", [None, "auto", "topk", "two_phase", "counting"])
def test_select_k_returns_int32_indices_like_jax(rng, strategy):
    vals = _rows(rng, "ties", (4, 300))
    jv, ji = jax_select_k(vals, 5, strategy=strategy)
    tv, ti = select_k(vals, 5, strategy=strategy, device="cpu")
    assert ti.dtype == torch.int32 and np.asarray(ji).dtype == np.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _, t1 = select_k(vals[0], 5, strategy=strategy, device="cpu")
    assert t1.dtype == torch.int32 and t1.shape == (5,)
