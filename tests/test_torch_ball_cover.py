"""PyTorch port: the random ball cover, epsilon neighbourhoods and the
legacy `spatial` aliases against the JAX package on the same numpy
inputs, on the CPU.

Tolerances: the index's landmarks, `row_ids` (so every point's ball) are
equal exactly; radii and distances to 1e-5 relative (the haversine's
transcendentals and the expanded dots round differently in XLA and
torch). Ids are equal outside groups of equal distance. The port takes
the second pass's ball count per block of queries where the JAX package
takes it over the call, so two block sizes give the same answer.
"""

import importlib
import sys
import warnings

import numpy as np
import pytest
import torch

from raft_tpu.neighbors import ball_cover as jbc
from raft_tpu.neighbors import eps_neighbors as jeps
from raft_tpu_torch import distance as tpd
from raft_tpu_torch.neighbors import ball_cover as tbc
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import epsilon_neighborhood as teps_mod
from raft_tpu_torch.neighbors import eps_neighbors as teps

RTOL = 1e-5


def _latlon(rng, n):
    lat = rng.uniform(-np.pi / 2, np.pi / 2, (n, 1))
    lon = rng.uniform(-np.pi, np.pi, (n, 1))
    return np.concatenate([lat, lon], 1).astype(np.float32)


def _blobs(rng, n, dim, centers=12, std=0.3):
    c = rng.uniform(-5, 5, (centers, dim))
    return (c[rng.integers(0, centers, n)] + std * rng.standard_normal((n, dim))).astype(
        np.float32)


def _data(metric, rng):
    if metric == "haversine":
        return _latlon(rng, 1500)
    if metric == "cosine":
        return (rng.random((800, 4)) + 0.1).astype(np.float32)
    return _blobs(rng, 2000, 3)


def _scale(metric, pts):
    """The absolute error scale of a metric's f32 values: the expanded
    form cancels |q|^2 + |c|^2, so its error is relative to that."""
    if metric == "sqeuclidean":
        return 2.0 * float((pts.astype(np.float64) ** 2).sum(1).max())
    return 1.0


def _assert_knn_equal(jd, ji, td, ti, rtol=RTOL, scale=1.0):
    """Distances to rtol (absolute: rtol x the metric's scale); ids equal
    wherever the distance is not tied (within that) with a neighbour in
    the row."""
    jd, ji = np.asarray(jd), np.asarray(ji)
    td, ti = td.numpy(), ti.numpy()
    assert td.dtype == np.float32 and ti.dtype == np.int32
    np.testing.assert_allclose(td, jd, rtol=rtol, atol=rtol * scale)
    tol = rtol * np.maximum(np.abs(jd), scale)
    with np.errstate(invalid="ignore"):  # inf - inf in a padded tail
        gap = np.diff(jd, axis=1)
    tied = np.zeros(jd.shape, bool)
    tied[:, 1:] |= gap <= tol[:, 1:]
    tied[:, :-1] |= gap <= tol[:, :-1]
    np.testing.assert_array_equal(ti[~tied], ji[~tied])


@pytest.mark.parametrize("metric", ["haversine", "sqeuclidean", "l1", "cosine"])
def test_index_fields_equal_jax(metric):
    pts = _data(metric, np.random.default_rng(1))
    ji = jbc.build_index(pts, metric=metric)
    ti = tbc.build_index(pts, metric=metric, device="cpu")
    assert ti.n == ji.n and ti.n_landmarks == ji.n_landmarks
    assert ti.metric == ji.metric
    np.testing.assert_array_equal(ti.landmarks.numpy(), np.asarray(ji.landmarks))
    np.testing.assert_array_equal(ti.row_ids.numpy(), np.asarray(ji.row_ids))
    assert ti.row_ids.dtype == torch.int32
    np.testing.assert_allclose(ti.radii.numpy(), np.asarray(ji.radii), rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("n_probes", [0, 3])
@pytest.mark.parametrize("metric", ["haversine", "sqeuclidean", "l1", "cosine"])
def test_knn_query_matches_jax(metric, n_probes):
    rng = np.random.default_rng(2)
    pts = _data(metric, rng)
    q = pts[rng.choice(len(pts), 60, replace=False)] + np.float32(1e-3)
    ji = jbc.build_index(pts, metric=metric)
    ti = tbc.build_index(pts, metric=metric, device="cpu")
    jd, jid = jbc.knn_query(ji, q, 7, n_probes=n_probes)
    td, tid = tbc.knn_query(ti, q, 7, n_probes=n_probes)
    _assert_knn_equal(jd, jid, td, tid, scale=_scale(metric, pts))


def test_haversine_all_knn_is_exact():
    pts = _latlon(np.random.default_rng(3), 700)
    ti = tbc.build_index(pts, metric="haversine", device="cpu")
    d, i = tbc.all_knn_query(ti, 5)
    bd, bi = tbf.knn(pts, pts, 5, metric="haversine", device="cpu")
    _assert_knn_equal(bd, bi, d, i)
    np.testing.assert_array_equal(i[:, 0].numpy(), np.arange(700))
    jd, jid = jbc.all_knn_query(jbc.build_index(pts, metric="haversine"), 5)
    _assert_knn_equal(jd, jid, d, i)


def _haversine64(x, y):
    x, y = x.astype(np.float64), y.astype(np.float64)
    h = (np.sin(0.5 * (y[None, :, 0] - x[:, None, 0])) ** 2
         + np.cos(x[:, None, 0]) * np.cos(y[None, :, 0])
         * np.sin(0.5 * (y[None, :, 1] - x[:, None, 1])) ** 2)
    return 2.0 * np.arcsin(np.sqrt(np.clip(h, 0.0, 1.0)))


def test_haversine_across_the_antimeridian_matches_float64():
    """A city astride lon +-pi: lon2 - lon1 is near 2 pi while the
    distances are ~1e-3 rad, so the f32 difference's rounding would be a
    large share of them; the port adds it back. Its distances and the
    ball cover's exact k-NN hold to float64 within 1e-5 relative."""
    rng = np.random.default_rng(5)
    lat = 0.3 + 2e-3 * rng.standard_normal(600)
    lon = np.pi + 2e-3 * rng.standard_normal(600)
    lon = (lon + np.pi) % (2 * np.pi) - np.pi
    pts = np.stack([lat, lon], 1).astype(np.float32)
    assert (pts[:, 1] > 3.0).any() and (pts[:, 1] < -3.0).any()
    d64 = _haversine64(pts, pts)
    got = tpd.pairwise_distance(pts, pts, metric="haversine", device="cpu").numpy()
    off = ~np.eye(len(pts), dtype=bool)
    np.testing.assert_allclose(got[off], d64[off], rtol=1e-5)
    ti = tbc.build_index(pts, metric="haversine", n_landmarks=24, device="cpu")
    d, i = tbc.all_knn_query(ti, 8)
    order = np.argsort(d64, axis=1, kind="stable")[:, :8]
    _assert_knn_equal(np.take_along_axis(d64, order, 1), order.astype(np.int32), d, i)


def test_far_clusters_and_the_second_pass_are_exact():
    """Two clusters 10 apart (the squared metric's bounds compare in the
    root domain) and a ring of points around centre queries: every ball
    of the ring survives the prune, so those queries need more balls than
    p1 = 32 and the second pass runs. Every returned id is within the f32
    error of the float64 k-th distance."""
    rng = np.random.default_rng(4)
    a = rng.random((300, 2), dtype=np.float32)
    b = rng.random((300, 2), dtype=np.float32) + 10.0
    t = rng.uniform(0, 2 * np.pi, 1200)
    ring = (np.stack([np.cos(t), np.sin(t)], 1) + 30.0).astype(np.float32)
    pts = np.concatenate([a, b, ring])
    q = np.concatenate([a[:5], b[:5], np.full((3, 2), 30.0, np.float32)])
    ti = tbc.build_index(pts, metric="sqeuclidean", n_landmarks=96, device="cpu")
    ji = jbc.build_index(pts, metric="sqeuclidean", n_landmarks=96)
    td, tid = tbc.knn_query(ti, q, 3)
    jd, jid = jbc.knn_query(ji, q, 3)
    _assert_knn_equal(jd, jid, td, tid, scale=_scale("sqeuclidean", pts))
    d64 = ((q[:, None, :].astype(np.float64) - pts[None]) ** 2).sum(-1)
    kth = np.sort(d64, axis=1)[:, 2]
    got = np.take_along_axis(d64, tid.numpy().astype(np.int64), 1)
    assert (got <= kth[:, None] + 1e-4).all()
    lb = tbc._landmark_lower_bounds(ti, torch.as_tensor(q))
    bound = tbc._root_domain(ti, td[:, 2])
    assert int((lb <= bound[:, None] * (1 + 4e-3) + 1e-6).sum(1).max()) > 32


@pytest.mark.parametrize("budget_rows", [1, 7])
def test_two_query_block_sizes_give_the_same_answer(monkeypatch, budget_rows):
    rng = np.random.default_rng(5)
    pts = _blobs(rng, 3000, 3, centers=6, std=1.0)
    q = np.concatenate([pts[:40] + 0.01, rng.uniform(-8, 8, (20, 3)).astype(np.float32)])
    ti = tbc.build_index(pts, metric="sqeuclidean", device="cpu")
    whole = tbc.knn_query(ti, q, 9)
    p1 = max(32, 9)
    rows = tbc._Rows(ti)
    width = rows.widest(p1) * (3 + 4) * 4
    monkeypatch.setattr(tbc, "BLOCK_BUDGET_BYTES", width * budget_rows)
    assert tbc._query_rows(ti, rows, p1) == budget_rows
    blocked = tbc.knn_query(ti, q, 9)
    assert torch.equal(whole[0], blocked[0]) and torch.equal(whole[1], blocked[1])


def test_blocked_build_equals_the_whole_build(monkeypatch):
    pts = _blobs(np.random.default_rng(6), 1000, 3)
    whole = tbc.build_index(pts, metric="l1", device="cpu")
    monkeypatch.setattr(tbc, "BLOCK_BUDGET_BYTES", 4 * whole.n_landmarks * 37)
    blocked = tbc.build_index(pts, metric="l1", device="cpu")
    assert torch.equal(whole.row_ids, blocked.row_ids)
    assert torch.equal(whole.radii, blocked.radii)


def test_fewer_candidates_than_k_pads_the_tail():
    pts = _blobs(np.random.default_rng(7), 200, 2, centers=4)
    ti = tbc.build_index(pts, metric="sqeuclidean", n_landmarks=50, device="cpu")
    ji = jbc.build_index(pts, metric="sqeuclidean", n_landmarks=50)
    k = ti.row_ids.shape[1] + 5  # more than any one ball holds
    td, tid = tbc.knn_query(ti, pts[:6], k, n_probes=1)
    jd, jid = jbc.knn_query(ji, pts[:6], k, n_probes=1)
    tail = tid.numpy() == -1
    np.testing.assert_array_equal(tail, np.asarray(jid) == -1)
    assert tail[:, -5:].all() and np.isinf(td.numpy()[tail]).all()
    _assert_knn_equal(jd, jid, td, tid, scale=_scale("sqeuclidean", pts))


def test_empty_query():
    pts = _blobs(np.random.default_rng(8), 300, 4)
    ti = tbc.build_index(pts, metric="cosine", n_landmarks=16, device="cpu")
    d, i = tbc.knn_query(ti, np.empty((0, 4), np.float32), 3)
    assert d.shape == (0, 3) and i.shape == (0, 3)
    assert d.dtype == torch.float32 and i.dtype == torch.int32


def _eps_equal(jadj, jdeg, tadj, tdeg, dist, eps):
    near = np.abs(dist - eps) <= 1e-5 * max(eps, 1e-6)
    np.testing.assert_array_equal(tadj.numpy()[~near], np.asarray(jadj)[~near])
    if not near.any():
        np.testing.assert_array_equal(tdeg.numpy(), np.asarray(jdeg))
    assert tadj.dtype == torch.bool and tdeg.dtype == torch.int32


@pytest.mark.parametrize("metric,eps", [("sqeuclidean", 0.3), ("l1", 1.1), ("euclidean", 0.5)])
def test_eps_neighbors_matches_jax(metric, eps):
    from scipy.spatial import distance as spdist

    rng = np.random.default_rng(9)
    x = rng.random((40, 4), dtype=np.float32)
    y = rng.random((70, 4), dtype=np.float32)
    jadj, jdeg = jeps(x, y, eps, metric=metric)
    tadj, tdeg = teps(x, y, eps, metric=metric, device="cpu")
    sp = {"sqeuclidean": "sqeuclidean", "l1": "cityblock", "euclidean": "euclidean"}[metric]
    _eps_equal(jadj, jdeg, tadj, tdeg, spdist.cdist(x, y, sp), eps)
    np.testing.assert_array_equal(tdeg.numpy(), tadj.numpy().sum(1))


def test_eps_blocks_and_eps_nn_query(monkeypatch):
    rng = np.random.default_rng(10)
    pts = _blobs(rng, 500, 3)
    q = pts[:30] + 0.05
    ti = tbc.build_index(pts, metric="sqeuclidean", device="cpu")
    adj, deg = tbc.eps_nn_query(ti, q, 0.5)
    monkeypatch.setattr(teps_mod, "BLOCK_BUDGET_BYTES", 4 * 500 * 7)
    adj2, deg2 = teps(q, pts, 0.5, device="cpu")
    assert torch.equal(adj, adj2) and torch.equal(deg, deg2)
    jadj, jdeg = jbc.eps_nn_query(jbc.build_index(pts, metric="sqeuclidean"), q, 0.5)
    d = ((q[:, None, :].astype(np.float64) - pts[None]) ** 2).sum(-1)
    _eps_equal(jadj, jdeg, adj, deg, d, 0.5)


def test_spatial_aliases_warn_and_forward():
    for name in ("raft_tpu_torch.spatial", "raft_tpu_torch.spatial.knn"):
        sys.modules.pop(name, None)
    with pytest.warns(DeprecationWarning, match="raft_tpu_torch.spatial.knn is deprecated"):
        knn_mod = importlib.import_module("raft_tpu_torch.spatial.knn")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        spatial = importlib.import_module("raft_tpu_torch.spatial")
    assert spatial.knn is knn_mod and spatial.__all__ == ["knn"]
    assert knn_mod.ball_cover is tbc and knn_mod.brute_force is tbf
    assert knn_mod.knn is tbf.knn and knn_mod.knn_merge_parts is tbf.knn_merge_parts
    assert knn_mod.eps_neighbors is teps
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        jknn = importlib.import_module("raft_tpu.spatial.knn")
    assert knn_mod.__all__ == jknn.__all__


def test_candidates_are_the_probed_members_in_probe_order():
    pts = _blobs(np.random.default_rng(12), 600, 2, centers=5)
    ti = tbc.build_index(pts, metric="l1", n_landmarks=20, device="cpu")
    rows = tbc._Rows(ti)
    probes = torch.tensor([[3, 0, 7], [19, 19, 2]])
    cand = tbc._candidates(ti, rows, probes)
    for r in range(2):
        want = ti.row_ids[probes[r]].reshape(-1)
        want = want[want >= 0]
        got = cand[r][cand[r] >= 0]
        assert torch.equal(got, want)
        assert (cand[r][want.numel():] == -1).all()
    assert cand.shape[1] == int(rows.ball_sizes[probes].sum(1).max()) <= rows.widest(3)
