"""PyTorch port: every name of `stats` against the JAX package on the same
numpy inputs, on the CPU, within 1e-5 relative (the sums run in another
order in torch than in XLA); integer results (histogram, contingency
matrix) exactly. `trustworthiness_score` ranks blocks of rows instead of
the JAX (n, n) rank table, so two block sizes are held equal as well.
"""

import numpy as np
import pytest
import torch

import raft_tpu.stats as js
import raft_tpu_torch.stats as ts
from raft_tpu_torch.stats import metrics as tmetrics

RTOL = 1e-5


def _data():
    rng = np.random.default_rng(11)
    x = rng.random((60, 6), dtype=np.float32)
    w = rng.random(60, dtype=np.float32)
    a = rng.integers(0, 4, 300)
    b = a.copy()
    flip = rng.choice(300, 60, replace=False)
    b[flip] = rng.integers(0, 4, 60)
    p = rng.random(10).astype(np.float32)
    q = rng.random(10).astype(np.float32)
    c = rng.random((4, 3), dtype=np.float32)
    sizes = np.array([10, 20, 30, 40], np.float32)
    y = rng.random(101, dtype=np.float32)
    yh = y + 0.1 * rng.random(101, dtype=np.float32)
    centers = rng.uniform(-3, 3, (3, 5))
    lab = rng.integers(0, 3, 150)
    blobs = (centers[lab] + 0.5 * rng.standard_normal((150, 5))).astype(np.float32)
    return dict(x=x, w=w, a=a, b=b, p=p / p.sum(), q=q / q.sum(), c=c, sizes=sizes, y=y, yh=yh,
                blobs=blobs, lab=lab, emb=rng.random((150, 2), dtype=np.float32))


D = _data()

CASES = {
    "mean": lambda: ((D["x"],), {}),
    "sum_stat": lambda: ((D["x"],), {"axis": 1}),
    "stddev": lambda: ((D["x"],), {}),
    "vars_stat": lambda: ((D["x"],), {"sample": False}),
    "meanvar": lambda: ((D["x"],), {}),
    "mean_center": lambda: ((D["x"],), {}),
    "mean_add": lambda: ((D["x"], D["x"][0]), {}),
    "cov": lambda: ((D["x"],), {}),
    "minmax": lambda: ((D["x"],), {"axis": 1}),
    "weighted_mean": lambda: ((D["x"], D["w"]), {}),
    "row_weighted_mean": lambda: ((D["x"], D["w"][:6]), {}),
    "histogram": lambda: ((D["w"] * 1.2 - 0.1, 7, 0.0, 1.0), {}),
    "dispersion": lambda: ((D["c"], D["sizes"]), {}),
    "accuracy": lambda: ((D["a"], D["b"]), {}),
    "r2_score": lambda: ((D["y"], D["yh"]), {}),
    "regression_metrics": lambda: ((D["yh"], D["y"]), {}),
    "contingency_matrix": lambda: ((D["a"], D["b"]), {}),
    "rand_index": lambda: ((D["a"], D["b"]), {}),
    "adjusted_rand_index": lambda: ((D["a"], D["b"]), {}),
    "entropy": lambda: ((D["a"],), {}),
    "mutual_info_score": lambda: ((D["a"], D["b"]), {}),
    "homogeneity_score": lambda: ((D["a"], D["b"]), {}),
    "completeness_score": lambda: ((D["a"], D["b"]), {}),
    "v_measure": lambda: ((D["a"], D["b"]), {"beta": 0.5}),
    "kl_divergence": lambda: ((D["p"], D["q"]), {}),
    "silhouette_score": lambda: ((D["blobs"], D["lab"]), {"batch": 64}),
    "trustworthiness_score": lambda: ((D["blobs"], D["emb"]), {"n_neighbors": 5}),
    "information_criterion_batched": lambda: ((np.float32(-120.0), 5, 100), {"criterion": "AICc"}),
}


def _leaves(v):
    if isinstance(v, dict):
        return [v[k] for k in sorted(v)]
    if isinstance(v, (tuple, list)):
        return list(v)
    return [v]


def test_cases_cover_every_name():
    assert sorted(CASES) == sorted(js.__all__) and ts.__all__ == js.__all__


@pytest.mark.parametrize("name", sorted(CASES))
def test_stat_matches_jax(name):
    args, kw = CASES[name]()
    want = _leaves(getattr(js, name)(*args, **kw))
    got = _leaves(getattr(ts, name)(*args, **kw, device="cpu"))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        w = np.asarray(w)
        g = g.numpy()
        assert g.shape == w.shape, (g.shape, w.shape)
        if np.issubdtype(w.dtype, np.integer) or w.dtype == bool:
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        else:
            assert g.dtype == np.float32
            np.testing.assert_allclose(g, w, rtol=RTOL, atol=RTOL * max(1.0, np.abs(w).max()))


@pytest.mark.parametrize("criterion", ["AIC", "BIC"])
def test_information_criteria(criterion):
    ll = np.array([-120.0, -80.5], np.float32)
    np.testing.assert_allclose(
        ts.information_criterion_batched(ll, 5, 100, criterion, device="cpu").numpy(),
        np.asarray(js.information_criterion_batched(ll, 5, 100, criterion)), rtol=RTOL)


def test_trustworthiness_blocks_and_extremes(monkeypatch):
    x, emb = D["blobs"], D["emb"]
    whole = ts.trustworthiness_score(x, emb, device="cpu")
    monkeypatch.setattr(tmetrics, "BLOCK_BUDGET_BYTES", 4 * 150 * 7)
    assert torch.equal(whole, ts.trustworthiness_score(x, emb, device="cpu"))
    # identity embedding: 1; integer-grid duplicates tie in rank, by id
    assert float(ts.trustworthiness_score(x, x.copy(), device="cpu")) == pytest.approx(1.0)
    grid = np.random.default_rng(3).integers(0, 3, (80, 3)).astype(np.float32)
    emb2 = grid[:, :2] + np.float32(0.5)
    np.testing.assert_allclose(
        float(ts.trustworthiness_score(grid, emb2, n_neighbors=4, device="cpu")),
        float(js.trustworthiness_score(grid, emb2, n_neighbors=4)), rtol=RTOL)


def test_silhouette_against_sklearn():
    import sklearn.metrics as skm

    got = float(ts.silhouette_score(D["blobs"], D["lab"], device="cpu"))
    assert got == pytest.approx(skm.silhouette_score(D["blobs"], D["lab"]), abs=1e-4)


def test_median_of_an_even_count():
    m = ts.regression_metrics(np.array([1, 2, 3, 10], np.float32), np.zeros(4, np.float32),
                              device="cpu")
    assert float(m["median_abs_error"]) == 2.5
