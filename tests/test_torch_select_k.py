"""PyTorch port: select_k and scan_select_k against the JAX package.

The tie rule is the point: equal values go to the smaller index, as
`lax.top_k` orders them. Rows full of exact ties must give the same ids
in both packages, min and max, on every strategy. Inputs come from numpy
and go through both packages; the port runs on the CPU.
"""

import numpy as np
import pytest

import torch

from raft_tpu.matrix import select_k as jax_select_k
from raft_tpu_torch.matrix.select_k import scan_select_k, select_k


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
    with pytest.raises(NotImplementedError):
        select_k(vals, 3, strategy="counting", device="cpu")


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
