"""PyTorch port: single-linkage, spectral clustering, the label
utilities, the masked L2 NN, the LAP solver and the generators against
the JAX package on the same numpy inputs, on the CPU.

Tolerances: on integer-grid data every distance is exact in f32, so
single-linkage's `children`, `deltas`, `sizes` and labels, and the masked
NN's distances and ids, are equal bit for bit (tied distances included;
the masked NN's square roots to one f32 ulp, as XLA's CPU sqrt is not
correctly rounded).
Spectral runs Lanczos from the same start vector as the JAX package: the
partitions are the same (ARI 1), eigenvalues to rtol 1e-4 and the
quality measures to rtol 1e-5. LAP totals are within the JAX test's 1.02
of scipy's optimum, and the assignment is the JAX package's. The
generators draw from a `torch.Generator`, so they are held by their
distributions.
"""

import importlib

import numpy as np
import pytest
import torch
from scipy.optimize import linear_sum_assignment
from sklearn.metrics import adjusted_rand_score

import jax
import jax.numpy as jnp

from raft_tpu import label as jlabel
from raft_tpu import solver as jsolver
from raft_tpu import spectral as jspectral
from raft_tpu.cluster import single_linkage as jax_single_linkage
from raft_tpu.distance import masked_l2_nn as jax_masked_l2_nn
from raft_tpu.random import make_blobs as jax_make_blobs
from raft_tpu.random import rmat as jax_rmat
from raft_tpu.sparse import neighbors as jneighbors
from raft_tpu_torch import label as tlabel
from raft_tpu_torch import solver as tsolver
from raft_tpu_torch import spectral as tspectral
from raft_tpu_torch import sparse as tsp
from raft_tpu_torch.cluster import single_linkage
from raft_tpu_torch.distance import masked_l2_nn
from raft_tpu_torch.random import make_blobs, make_regression, rmat

DEV = "cpu"


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _grid_blobs(rng, n, dim, n_blobs, spread, box=60):
    centers = rng.integers(-box, box, (n_blobs, dim))
    lab = rng.integers(0, n_blobs, n)
    x = (centers[lab] + rng.integers(-spread, spread + 1, (n, dim))).astype(np.float32)
    return x, lab


def _to_port_coo(g):
    return tsp.CooMatrix(torch.tensor(np.asarray(g.rows)), torch.tensor(np.asarray(g.cols)),
                         torch.tensor(np.asarray(g.vals)), g.shape)


# -- single-linkage ----------------------------------------------------------


def _assert_linkage_equal(got, want):
    for name in ("children", "deltas", "sizes", "labels"):
        np.testing.assert_array_equal(_np(getattr(got, name)), _np(getattr(want, name)),
                                      err_msg=name)
    assert got.n_clusters == want.n_clusters
    assert got.labels.dtype == got.children.dtype == got.sizes.dtype == torch.int32
    assert got.deltas.dtype == torch.float32


@pytest.mark.parametrize("metric", ["sqeuclidean", "l1"])
def test_single_linkage_knn_equals_jax_through_the_repair(rng, metric):
    """Separated grid blobs and 4 neighbours: the k-NN graph falls apart,
    so the repair passes run; equal distances tie throughout."""
    x, _ = _grid_blobs(rng, 600, 3, 6, 2)
    stages = {}
    got = single_linkage(x, n_clusters=6, metric=metric, n_neighbors=4, device=DEV,
                         stages=stages)
    want = jax_single_linkage(x, n_clusters=6, metric=metric, n_neighbors=4)
    assert stages["repair"] and stages["repair"][0]["components"] > 1
    _assert_linkage_equal(got, want)
    assert got.children.shape == (599, 2)


def test_single_linkage_pairwise_equals_jax(rng):
    x, truth = _grid_blobs(rng, 160, 2, 4, 3)
    got = single_linkage(x, n_clusters=4, connectivity="pairwise", device=DEV)
    want = jax_single_linkage(x, n_clusters=4, connectivity="pairwise")
    _assert_linkage_equal(got, want)
    assert np.all(np.diff(_np(got.deltas)) >= 0)
    assert adjusted_rand_score(truth, _np(got.labels)) == 1.0


def test_single_linkage_rejects_bad_cluster_counts(rng):
    x, _ = _grid_blobs(rng, 20, 2, 2, 1)
    for k in (0, 21):
        with pytest.raises(ValueError, match="out of range"):
            single_linkage(x, n_clusters=k, device=DEV)


# -- spectral ----------------------------------------------------------------


def _two_moons():
    data, labels = jax_make_blobs(300, 5, n_clusters=2, cluster_std=0.5, seed=17)
    g = jneighbors.knn_graph(np.asarray(data), 10)
    return g, np.asarray(labels)


@pytest.fixture
def jax_start(monkeypatch):
    """The port's Lanczos starts from the JAX package's start vector (its
    draw from PRNGKey(seed)) instead of its own generator's."""
    from raft_tpu_torch.sparse import solver

    def start(n, seed, device):
        v0 = jax.random.normal(jax.random.PRNGKey(seed), (n,), dtype=jnp.float32)
        return torch.tensor(np.asarray(v0), device=device)

    monkeypatch.setattr(solver, "_start_vector", start)


def test_partition_equals_jax_from_the_same_start_vector(jax_start):
    g, truth = _two_moons()
    jl, jv, _ = jspectral.partition(g, 2)
    tl, tv, temb = tspectral.partition(_to_port_coo(g), 2)
    assert tl.dtype == torch.int32 and temb.shape == (300, 2)
    assert adjusted_rand_score(_np(jl), _np(tl)) == 1.0
    assert adjusted_rand_score(truth, _np(tl)) > 0.95
    np.testing.assert_allclose(_np(tv), _np(jv), rtol=1e-4, atol=1e-5)
    cut_t = tspectral.analyze_partition(_to_port_coo(g), tl, 2)
    cut_j = jspectral.analyze_partition(g, _np(tl), 2)
    np.testing.assert_allclose(cut_t, cut_j, rtol=1e-6)
    np.testing.assert_allclose(tspectral.modularity(_to_port_coo(g), tl),
                               jspectral.modularity(g, _np(tl)), rtol=1e-5)


def test_modularity_maximization_equals_jax(jax_start):
    g, _ = _two_moons()
    jl, jv, _ = jspectral.modularity_maximization(g, 2)
    tl, tv, _ = tspectral.modularity_maximization(_to_port_coo(g), 2)
    assert adjusted_rand_score(_np(jl), _np(tl)) == 1.0
    np.testing.assert_allclose(_np(tv), _np(jv), rtol=1e-4, atol=1e-5)
    assert tspectral.modularity(_to_port_coo(g), tl) > 0.3


def test_fit_embedding_and_solvers_match_jax(rng, jax_start):
    x = rng.random((200, 3)).astype(np.float32)
    g = jneighbors.knn_graph(x, 12)
    from raft_tpu.sparse.formats import coo_to_csr

    tcsr = tsp.coo_to_csr(_to_port_coo(g))
    got = _np(tspectral.fit_embedding(tcsr, 2))
    want = np.asarray(jspectral.fit_embedding(coo_to_csr(g), 2))
    sign = np.sign(np.sum(got * want, axis=0))
    np.testing.assert_allclose(got * sign, want, atol=2e-3)
    solver = tspectral.LanczosSolver(tspectral.EigenSolverConfig(n_eigenvecs=3), device=DEV)
    mv = tsp.linalg.laplacian_matvec(tcsr)
    vals, vecs = solver.solve_smallest(mv, 200)
    jvals, _ = jspectral.LanczosSolver(jspectral.EigenSolverConfig(n_eigenvecs=3)).solve_smallest(
        jspectral.laplacian_matvec(coo_to_csr(g)), 200)
    np.testing.assert_allclose(_np(vals), np.asarray(jvals), rtol=1e-4, atol=1e-5)
    top, _ = solver.solve_largest(mv, 200)
    assert np.all(np.diff(_np(top)) <= 0) and _np(top)[0] <= 2.0 + 1e-4
    lab = tspectral.KmeansSolver(2).solve(torch.as_tensor(np.vstack([x, x + 10])))
    assert lab.dtype == torch.int32 and len(set(_np(lab[:200]))) == 1


# -- label -------------------------------------------------------------------


def test_labels_equal_jax(rng):
    labels = rng.integers(-3, 50, 300)
    np.testing.assert_array_equal(_np(tlabel.get_unique_labels(labels, device=DEV)),
                                  np.asarray(jlabel.get_unique_labels(labels)))
    for inp in (labels, torch.as_tensor(labels)):  # native path, tensor path
        mono, uniq = tlabel.make_monotonic(inp, device=DEV)
        jm, ju = jlabel.make_monotonic(labels)
        assert mono.dtype == uniq.dtype == torch.int32
        np.testing.assert_array_equal(_np(mono), np.asarray(jm))
        np.testing.assert_array_equal(_np(uniq), np.asarray(ju))
    mono, uniq = tlabel.make_monotonic(labels, ignore_value=7, device=DEV)
    jm, ju = jlabel.make_monotonic(labels, ignore_value=7)
    np.testing.assert_array_equal(_np(mono), np.asarray(jm))
    np.testing.assert_array_equal(_np(uniq), np.asarray(ju))


def test_merge_labels_equals_jax(rng):
    a = rng.integers(0, 40, 500)
    b = rng.integers(0, 60, 500)
    mask = rng.random(500) < 0.7
    for m in (None, mask):
        got = tlabel.merge_labels(a, b, mask=m, device=DEV)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(_np(got), np.asarray(jlabel.merge_labels(a, b, mask=m)))


# -- masked NN ---------------------------------------------------------------


def test_masked_l2_nn_equals_jax(rng, monkeypatch):
    x, _ = _grid_blobs(rng, 300, 4, 5, 3)
    y, _ = _grid_blobs(rng, 500, 4, 5, 3)
    groups = rng.integers(0, 9, 500)
    adj = rng.random((300, 9)) < 0.4
    adj[7] = False  # a row with no allowed group
    d, i = masked_l2_nn(x, y, adj, groups, device=DEV)
    jd, ji = jax_masked_l2_nn(x, y, adj, groups)
    np.testing.assert_array_equal(_np(d), np.asarray(jd))
    np.testing.assert_array_equal(_np(i), np.asarray(ji))
    assert i.dtype == torch.int32 and int(i[7]) == -1 and np.isinf(_np(d)[7])
    # 11-row blocks: the same answer
    with monkeypatch.context() as mp:
        mp.setattr(importlib.import_module("raft_tpu_torch.distance.masked_nn"),
                   "BLOCK_BUDGET_BYTES", 4 * 500 * 11)
        bd, bi = masked_l2_nn(x, y, adj, groups, device=DEV)
    assert torch.equal(bd, d) and torch.equal(bi, i)
    sd, si = masked_l2_nn(x, y, adj, groups, sqrt=True, device=DEV)
    # XLA's CPU sqrt is not correctly rounded: one f32 ulp apart
    np.testing.assert_allclose(_np(sd), np.asarray(jax_masked_l2_nn(x, y, adj, groups,
                                                                    sqrt=True)[0]), rtol=2.4e-7)
    with pytest.raises(ValueError, match="adj"):
        masked_l2_nn(x, y, adj[:5], groups, device=DEV)
    with pytest.raises(ValueError, match="group_ids"):
        masked_l2_nn(x, y, adj, groups[:5], device=DEV)


# -- LAP ---------------------------------------------------------------------


@pytest.mark.parametrize("n", [5, 20, 64])
def test_linear_assignment_matches_scipy_and_jax(n):
    cost = np.random.default_rng(n).random((n, n)).astype(np.float32)
    rows, cols = tsolver.linear_assignment(cost, device=DEV)
    assert rows.dtype == cols.dtype == torch.int32
    c = _np(cols)
    assert sorted(c.tolist()) == list(range(n))
    r, cc = linear_sum_assignment(cost)
    assert cost[np.arange(n), c].sum() <= cost[r, cc].sum() * 1.02 + 1e-4
    np.testing.assert_array_equal(c, np.asarray(jsolver.linear_assignment(cost)[1]))


def test_linear_assignment_maximize_and_alias():
    cost = np.random.default_rng(1).random((10, 10)).astype(np.float32)
    _, cols = tsolver.lap(cost, maximize=True, device=DEV)
    r, c = linear_sum_assignment(cost, maximize=True)
    assert cost[np.arange(10), _np(cols)].sum() >= cost[r, c].sum() * 0.98
    with pytest.raises(ValueError, match="square"):
        tsolver.linear_assignment(cost[:3], device=DEV)
    assert tsolver.linear_assignment(np.zeros((0, 0)), device=DEV)[1].numel() == 0


# -- generators --------------------------------------------------------------


def test_make_blobs_by_distribution():
    centers = np.array([[0.0, 0.0, 0.0], [10.0, -5.0, 2.0], [-7.0, 3.0, 8.0]], np.float32)
    x, lab = make_blobs(30000, 3, centers=centers, cluster_std=0.5, seed=3, device=DEV)
    assert x.dtype == torch.float32 and lab.dtype == torch.int32 and x.shape == (30000, 3)
    x, lab = _np(x), _np(lab)
    for c in range(3):
        rows = x[lab == c]
        assert abs(len(rows) / 30000 - 1 / 3) < 0.02
        np.testing.assert_allclose(rows.mean(0), centers[c], atol=0.03)
        np.testing.assert_allclose(rows.std(0), 0.5, atol=0.02)
    x2, _ = make_blobs(4000, 5, n_clusters=7, center_box=(-5.0, 5.0), seed=0, device=DEV)
    jx, _ = jax_make_blobs(4000, 5, n_clusters=7, center_box=(-5.0, 5.0), seed=0)
    assert np.abs(_np(x2)).max() < 5.0 + 6 and np.abs(np.asarray(jx)).max() < 5.0 + 6
    again, _ = make_blobs(4000, 5, n_clusters=7, center_box=(-5.0, 5.0), seed=0, device=DEV)
    assert torch.equal(again, x2)


def test_rmat_by_distribution():
    edges = rmat(8, 8, 20000, a=0.7, b=0.1, c=0.1, seed=0, device=DEV)
    jedges = np.asarray(jax_rmat(8, 8, 20000, a=0.7, b=0.1, c=0.1, seed=0))
    assert edges.shape == (20000, 2) and edges.dtype == torch.int32
    e = _np(edges)
    assert e.min() >= 0 and e.max() < 256
    # each level sets the row bit with c + d = 0.2 and the column bit with b + d = 0.2
    for side in (0, 1):
        for bit in range(8):
            share = ((e[:, side] >> bit) & 1).mean()
            jshare = ((jedges[:, side] >> bit) & 1).mean()
            assert abs(share - 0.2) < 0.015 and abs(share - jshare) < 0.02
    rect = _np(rmat(6, 9, 2000, seed=1, device=DEV))
    assert rect[:, 0].max() < 64 and rect[:, 1].max() < 512 and rect[:, 1].max() >= 64


def test_make_regression_is_a_linear_model():
    X, y, coef = make_regression(500, 20, n_informative=5, bias=2.0, seed=4, device=DEV)
    assert X.shape == (500, 20) and y.shape == (500,) and coef.shape == (20, 1)
    c = _np(coef)[:, 0]
    assert np.all(c[5:] == 0) and np.all((c[:5] > 0) & (c[:5] < 100))
    np.testing.assert_allclose(_np(y), _np(X) @ c + 2.0, rtol=1e-4, atol=1e-3)
    Xr, _, _ = make_regression(100, 30, effective_rank=5, seed=4, device=DEV)
    s = np.linalg.svd(_np(Xr).astype(np.float64), compute_uv=False)
    assert s[0] > 10 * s[-1]


def test_namespaces_are_the_functions():
    sl = importlib.import_module("raft_tpu_torch.cluster.single_linkage")
    assert single_linkage is sl.single_linkage
    assert masked_l2_nn is importlib.import_module(
        "raft_tpu_torch.distance.masked_nn").masked_l2_nn
