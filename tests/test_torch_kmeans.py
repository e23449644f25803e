"""PyTorch port: Lloyd k-means (pylibraft's public `kmeans`) against the
JAX package.

- From the same starting centroids (`init="array"`, one near each blob)
  the two packages run the same Lloyd iterations: equal `n_iter`,
  centroids within 1e-5 relative, equal `predict` labels, inertia within
  1e-5 relative; weighted and unweighted. The sums are taken in another
  order, so the centroids differ in their last bits: a row that is a
  near-tie between two centroids (two centroids started inside one
  blob) can then change sides, and the runs part. The starting
  centroids sit one in each blob, so no row is such a tie.
- `transform`, `cluster_cost` and `compute_new_centroids` from the same
  centroids agree to rtol 1e-5 (labels and weights given or not).
- The trained initialisers ("k-means++", "random") draw from different
  generators in the two packages, so their fits are held by inertia on
  the same data: within 5% of the JAX fit's. `find_k` gives the JAX
  package's k on well-separated blobs.
"""

import numpy as np
import pytest

import torch

from raft_tpu.cluster import kmeans as jkm
from raft_tpu_torch.cluster import kmeans as tkm


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    blobs = rng.uniform(-8, 8, (9, 12)).astype(np.float32)
    x = (blobs[rng.integers(0, 9, 3000)] + rng.standard_normal((3000, 12))).astype(np.float32)
    c0 = (blobs + rng.standard_normal((9, 12))).astype(np.float32)
    w = rng.uniform(0.5, 2.0, 3000).astype(np.float32)
    return x, c0, w


@pytest.mark.parametrize("weighted", [False, True])
def test_lloyd_from_array_matches_jax(data, weighted):
    x, c0, w = data
    sw = w if weighted else None
    params = dict(n_clusters=9, max_iter=50, tol=1e-4, init="array")
    jc, ji, jn = jkm.fit(x, jkm.KMeansParams(**params), sample_weights=sw, centroids=c0)
    tc, ti, tn = tkm.fit(x, tkm.KMeansParams(**params), sample_weights=sw, centroids=c0,
                         device="cpu")
    jc = np.asarray(jc)
    assert tn == jn and 1 < tn < 50
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ti, ji, rtol=1e-5)
    jl = np.asarray(jkm.predict(x, jc))
    tl = tkm.predict(x, tc, device="cpu")
    assert tl.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), jl)


def test_fit_predict_and_max_iter(data):
    x, c0, _ = data
    jl, jc, ji, jn = jkm.fit_predict(x, n_clusters=9, init="array", centroids=c0, max_iter=2)
    tl, tc, ti, tn = tkm.fit_predict(x, n_clusters=9, init="array", centroids=c0, max_iter=2,
                                     device="cpu")
    assert tn == jn == 2
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ti, ji, rtol=1e-5)


@pytest.mark.parametrize("weighted", [False, True])
def test_transform_cost_and_centroid_update_match_jax(data, weighted):
    x, c0, w = data
    sw = w if weighted else None
    np.testing.assert_allclose(tkm.transform(x, c0, device="cpu").numpy(),
                               np.asarray(jkm.transform(x, c0)), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(tkm.cluster_cost(x, c0, device="cpu"),
                               jkm.cluster_cost(x, c0), rtol=1e-5)
    labels = np.asarray(jkm.predict(x, c0))
    jn = np.asarray(jkm.compute_new_centroids(x, c0, labels, sample_weights=sw))
    tn = tkm.compute_new_centroids(x, c0, labels, sample_weights=sw, device="cpu")
    np.testing.assert_allclose(tn.numpy(), jn, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("init", ["k-means++", "random"])
def test_trained_initialisers_within_five_percent_of_jax(data, init):
    x, _, _ = data
    params = dict(n_clusters=9, max_iter=30, init=init, n_init=2, seed=4)
    _, ji, _ = jkm.fit(x, jkm.KMeansParams(**params))
    tc, ti, tn = tkm.fit(x, tkm.KMeansParams(**params), device="cpu")
    assert tc.shape == (9, 12) and torch.isfinite(tc).all() and tn >= 1
    assert abs(ti / ji - 1.0) <= 0.05, (ti, ji)
    # the returned inertia is the data's cost against the fit's centroids
    # as of its last assignment; one more step only lowers it
    assert tkm.cluster_cost(x, tc, device="cpu") <= ti * (1 + 1e-5)


def test_find_k_matches_jax_on_separated_blobs():
    rng = np.random.default_rng(3)
    centers = np.array([[-30.0, 0.0], [0.0, 30.0], [30.0, 0.0], [0.0, -30.0]], np.float32)
    x = (centers[rng.integers(0, 4, 800)] + rng.standard_normal((800, 2))).astype(np.float32)
    jk, _, _ = jkm.find_k(x, kmax=8, kmin=1, max_iter=30, seed=1)
    tk, ti, tn = tkm.find_k(x, kmax=8, kmin=1, max_iter=30, seed=1, device="cpu")
    assert tk == jk, (tk, jk)
    assert np.isfinite(ti) and tn >= 1


def test_bad_requests_raise(data):
    x, _, _ = data
    with pytest.raises(ValueError, match="requires centroids"):
        tkm.fit(x, init="array", device="cpu")
    with pytest.raises(ValueError, match="2-d"):
        tkm.fit(x[0], n_clusters=2, device="cpu")
