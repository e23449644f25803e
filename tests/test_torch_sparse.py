"""PyTorch port: `raft_tpu_torch.sparse` (formats, ops, linalg, the Borůvka
MST and Lanczos, the k-NN graph and component repair, sparse distances
and k-NN) against the JAX package's `raft_tpu.sparse` on the same numpy
inputs, on the CPU.

Tolerances: structure (indices, edge order, the MST mask) is exact; so
are values that both compute with the same operations in the same order
(symmetrize, max_duplicates, mean), and every distance on integer-grid
data, where f32 sums are exact (ties included). Reductions whose order
differs (spmv, spmm, the row norms, Lanczos) agree to f32 rounding
(rtol 1e-5, eigenvectors up to sign); the sparse distances on gaussian
data to rtol 1e-5 / atol 1e-5.
"""

import warnings

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from raft_tpu import sparse as jsp
from raft_tpu.sparse import solver as jsolver
from raft_tpu_torch import sparse as tsp
from raft_tpu_torch.sparse import solver as tsolver

DEV = "cpu"


def _np(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _coo_pair(rows, cols, vals, shape):
    j = jsp.CooMatrix(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(vals), shape)
    t = tsp.CooMatrix(torch.as_tensor(rows), torch.as_tensor(cols), torch.as_tensor(vals), shape)
    return j, t


def _assert_coo_equal(t, j):
    for a, b in ((t.rows, j.rows), (t.cols, j.cols), (t.vals, j.vals)):
        np.testing.assert_array_equal(_np(a), _np(b))
    assert tuple(t.shape) == tuple(j.shape)


def _assert_csr_equal(t, j):
    for a, b in ((t.indptr, j.indptr), (t.indices, j.indices), (t.data, j.data)):
        np.testing.assert_array_equal(_np(a), _np(b))


def _sparse_dense(rng, shape, density, grid=False):
    d = (rng.integers(1, 5, shape).astype(np.float32) if grid
         else rng.random(shape, dtype=np.float32))
    d[rng.random(shape) > density] = 0.0
    return d


def _grid_points(rng, n, dim, n_blobs=4, spread=3):
    centers = rng.integers(-40, 40, (n_blobs, dim))
    lab = rng.integers(0, n_blobs, n)
    return (centers[lab] + rng.integers(-spread, spread + 1, (n, dim))).astype(np.float32)


# -- formats and ops ---------------------------------------------------------


def test_dense_conversions_and_row_ids_equal_jax(rng):
    d = _sparse_dense(rng, (37, 23), 0.2)
    d[5] = 0.0  # an empty row
    tc, jc = tsp.dense_to_csr(d, device=DEV), jsp.dense_to_csr(d)
    _assert_csr_equal(tc, jc)
    assert tc.indptr.dtype == tc.indices.dtype == torch.int32
    _assert_coo_equal(tsp.dense_to_coo(d, device=DEV), jsp.dense_to_coo(d))
    np.testing.assert_array_equal(_np(tc.row_ids()), _np(jc.row_ids()))
    np.testing.assert_array_equal(_np(tsp.csr_to_dense(tc)), d)
    _assert_coo_equal(tsp.csr_to_coo(tc), jsp.csr_to_coo(jc))
    np.testing.assert_array_equal(_np(tsp.coo_to_dense(tsp.csr_to_coo(tc))), d)


def test_coo_to_csr_sorts_like_lexsort(rng):
    rows = rng.integers(0, 9, 80).astype(np.int32)
    cols = rng.integers(0, 6, 80).astype(np.int32)  # many duplicate pairs
    vals = rng.standard_normal(80).astype(np.float32)
    j, t = _coo_pair(rows, cols, vals, (9, 6))
    _assert_coo_equal(tsp.coo_sort(t), jsp.coo_sort(j))
    _assert_csr_equal(tsp.coo_to_csr(t), jsp.coo_to_csr(j))


def test_structural_ops_equal_jax(rng):
    rows = rng.integers(0, 12, 200).astype(np.int32)
    cols = rng.integers(0, 5, 200).astype(np.int32)  # up to ~8 duplicates a pair
    vals = rng.standard_normal(200).astype(np.float32)
    vals[::7] = 0.0
    j, t = _coo_pair(rows, cols, vals, (12, 5))
    _assert_coo_equal(tsp.coo_remove_zeros(t), jsp.coo_remove_zeros(j))
    _assert_coo_equal(tsp.coo_remove_zeros(t, tol=0.5), jsp.coo_remove_zeros(j, tol=0.5))
    # sums folded in order of occurrence: bit for bit np.add.at
    _assert_coo_equal(tsp.max_duplicates(t), jsp.max_duplicates(j))
    deg = tsp.degree(t)
    assert deg.dtype == torch.int32
    np.testing.assert_array_equal(_np(deg), _np(jsp.degree(j)))
    tc, jc = tsp.coo_to_csr(t), jsp.coo_to_csr(j)
    _assert_csr_equal(tsp.csr_row_slice(tc, 3, 9), jsp.csr_row_slice(jc, 3, 9))
    got = tsp.csr_row_op(tc, lambda r, v: v * (r + 1).float())
    want = jsp.csr_row_op(jc, lambda r, v: v * (r + 1))
    _assert_csr_equal(got, want)


# -- linalg ------------------------------------------------------------------


def test_spmv_spmm_and_row_norms_match_jax(rng):
    d = _sparse_dense(rng, (300, 120), 0.1)
    d[17] = 0.0
    tc, jc = tsp.dense_to_csr(d, device=DEV), jsp.dense_to_csr(d)
    x = rng.standard_normal(120).astype(np.float32)
    B = rng.standard_normal((120, 7)).astype(np.float32)
    np.testing.assert_allclose(_np(tsp.linalg.spmv(tc, torch.as_tensor(x))),
                               _np(jsp.linalg.spmv(jc, x)), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(tsp.linalg.spmm(tc, torch.as_tensor(B))),
                               _np(jsp.linalg.spmm(jc, B)), rtol=1e-5, atol=1e-5)
    for norm in ("l2", "l1"):
        np.testing.assert_allclose(_np(tsp.linalg.row_norm_csr(tc, norm)),
                                   _np(jsp.linalg.row_norm_csr(jc, norm)), rtol=1e-5)
    np.testing.assert_array_equal(_np(tsp.linalg.row_norm_csr(tc, "linf")),
                                  _np(jsp.linalg.row_norm_csr(jc, "linf")))
    with pytest.raises(ValueError):
        tsp.linalg.row_norm_csr(tc, "l3")


def test_spmv_is_the_same_on_every_run(rng):
    d = _sparse_dense(rng, (500, 400), 0.2)
    tc = tsp.dense_to_csr(d, device=DEV)
    x = torch.as_tensor(rng.standard_normal(400).astype(np.float32))
    assert torch.equal(tsp.linalg.spmv(tc, x), tsp.linalg.spmv(tc, x))


def test_transpose_add_and_symmetrize_equal_jax(rng):
    a = _sparse_dense(rng, (30, 30), 0.15, grid=True)
    b = _sparse_dense(rng, (30, 30), 0.15, grid=True)
    ta, ja = tsp.dense_to_csr(a, device=DEV), jsp.dense_to_csr(a)
    tb, jb = tsp.dense_to_csr(b, device=DEV), jsp.dense_to_csr(b)
    _assert_csr_equal(tsp.linalg.transpose(ta), jsp.linalg.transpose(ja))
    _assert_csr_equal(tsp.linalg.add(ta, tb), jsp.linalg.add(ja, jb))
    # duplicates and both directions present: up to 4 values fold a pair
    rows = rng.integers(0, 15, 120).astype(np.int32)
    cols = rng.integers(0, 15, 120).astype(np.int32)
    vals = rng.standard_normal(120).astype(np.float32)
    j, t = _coo_pair(rows, cols, vals, (15, 15))
    for op in ("max", "sum", "mean"):
        _assert_coo_equal(tsp.linalg.symmetrize(t, op), jsp.linalg.symmetrize(j, op))
    with pytest.raises(ValueError):
        tsp.linalg.symmetrize(t, "min")


def test_laplacian_matvec_matches_jax(rng):
    d = _sparse_dense(rng, (80, 80), 0.1)
    d = d + d.T
    tc, jc = tsp.dense_to_csr(d, device=DEV), jsp.dense_to_csr(d)
    v = rng.standard_normal(80).astype(np.float32)
    for normalized in (True, False):
        got = tsp.linalg.laplacian_matvec(tc, normalized)(torch.as_tensor(v))
        want = jsp.linalg.laplacian_matvec(jc, normalized)(jnp.asarray(v))
        np.testing.assert_allclose(_np(got), _np(want), rtol=1e-5, atol=1e-5)


# -- the MST -----------------------------------------------------------------


def _tied_graph(rng, n, m):
    """A symmetric graph whose weights come from 3 values: many ties."""
    r = rng.integers(0, n, m)
    c = rng.integers(0, n, m)
    keep = r != c
    r, c = r[keep], c[keep]
    w = rng.integers(1, 4, len(r)).astype(np.float32)
    rows = np.concatenate([r, c]).astype(np.int32)
    cols = np.concatenate([c, r]).astype(np.int32)
    return rows, cols, np.concatenate([w, w])


@pytest.mark.parametrize("n,m", [(60, 40), (300, 900), (1000, 6000)])
def test_boruvka_mask_and_mst_edges_equal_jax(rng, n, m):
    rows, cols, w = _tied_graph(rng, n, m)
    comp_t, mask_t = tsolver._boruvka(torch.as_tensor(rows).long(), torch.as_tensor(cols).long(),
                                      torch.as_tensor(w), n)
    comp_j, mask_j = jsolver._boruvka(jnp.asarray(rows), jnp.asarray(cols), jnp.asarray(w), n)
    np.testing.assert_array_equal(_np(mask_t), _np(mask_j))
    np.testing.assert_array_equal(_np(comp_t), _np(comp_j))
    j, t = _coo_pair(rows, cols, w, (n, n))
    got, want = tsolver.mst(t), jsolver.mst(j)
    _assert_coo_equal(got, want)
    assert got.rows.dtype == got.cols.dtype == torch.int32 and got.vals.dtype == torch.float32


def test_mst_weight_equals_scipy_on_a_connected_graph(rng):
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import minimum_spanning_tree

    n = 400
    rows, cols, w = _tied_graph(rng, n, 4000)
    path = np.arange(n - 1, dtype=np.int32)  # a path of heavy edges: connected
    coo = tsp.linalg.symmetrize(tsp.CooMatrix(
        torch.as_tensor(np.concatenate([rows, path])),
        torch.as_tensor(np.concatenate([cols, path + 1])),
        torch.as_tensor(np.concatenate([w, np.full(n - 1, 9.0, np.float32)])), (n, n)))
    g = coo_matrix((_np(coo.vals).astype(np.float64), (_np(coo.rows), _np(coo.cols))),
                   shape=(n, n))
    want = minimum_spanning_tree(g).sum()
    tree = tsolver.mst(coo)
    assert tree.nnz == n - 1
    assert abs(float(tree.vals.double().sum()) - want) <= 1e-6 * want


# -- Lanczos -----------------------------------------------------------------


def _laplacian_pair(rng, n):
    a = _sparse_dense(rng, (n, n), 0.05)
    a = a + a.T
    return tsp.dense_to_csr(a, device=DEV), jsp.dense_to_csr(a)


@pytest.mark.parametrize("which", ["smallest", "largest"])
def test_lanczos_with_a_shared_start_vector_matches_jax(rng, which):
    tc, jc = _laplacian_pair(rng, 200)
    v0 = rng.standard_normal(200).astype(np.float32)
    tv, tvec = tsolver.lanczos(tsp.linalg.laplacian_matvec(tc), 200, 4, which, v0=v0, device=DEV)
    jv, jvec = jsolver.lanczos(jsp.linalg.laplacian_matvec(jc), 200, 4, which, v0=jnp.asarray(v0))
    np.testing.assert_allclose(_np(tv), _np(jv), rtol=1e-4, atol=1e-5)
    tvec, jvec = _np(tvec), _np(jvec)
    sign = np.sign(np.sum(tvec * jvec, axis=0))
    np.testing.assert_allclose(tvec * sign, jvec, atol=2e-3)


def test_lanczos_tol_runs_the_same_sequence_on_until_the_pairs_converge(rng):
    """Two blobs, no edge between them: the fixed 32 steps miss the second
    zero eigenvalue; `tol` doubles the steps until both pairs converge,
    and the pairs equal a fixed run of that many steps bit for bit. A
    tolerance the fixed run meets returns its pairs unchanged."""
    x = rng.standard_normal((300, 5)).astype(np.float32) * 0.5
    x[150:] += 20.0
    g = tsp.neighbors.knn_graph(x, 10, device=DEV)
    mv = tsp.linalg.laplacian_matvec(tsp.coo_to_csr(g))
    v0 = rng.standard_normal(300).astype(np.float32)
    fixed_v, fixed_vec = tsolver.lanczos(mv, 300, 2, v0=v0, device=DEV)
    info = {}
    vals, vecs = tsolver.lanczos(mv, 300, 2, v0=v0, device=DEV, tol=1e-5, info=info)
    assert info["ncv"] > 32 and float(info["residuals"].max()) <= 1e-5
    assert float(vals.abs().max()) < 1e-4  # both zero eigenvalues
    again_v, again_vec = tsolver.lanczos(mv, 300, 2, ncv=info["ncv"], v0=v0, device=DEV)
    assert torch.equal(again_v, vals) and torch.equal(again_vec, vecs)
    loose_v, loose_vec = tsolver.lanczos(mv, 300, 2, v0=v0, device=DEV, tol=10.0, info=info)
    assert info["ncv"] == 32
    assert torch.equal(loose_v, fixed_v) and torch.equal(loose_vec, fixed_vec)
    resid = tsolver.ritz_residuals(mv, vals, vecs)
    assert resid.shape == (2,) and float(resid.max()) <= 1e-5


def test_compute_eigenvectors_are_eigenpairs(rng):
    tc, _ = _laplacian_pair(rng, 150)
    dense = _np(tsp.csr_to_dense(tc)).astype(np.float64)
    for fn in (tsolver.compute_smallest_eigenvectors, tsolver.compute_largest_eigenvectors):
        vals, vecs = fn(tc, 3)
        assert vals.dtype == vecs.dtype == torch.float32 and vecs.shape == (150, 3)
        v = _np(vecs).astype(np.float64)
        resid = np.linalg.norm(dense @ v - v * _np(vals)[None, :], axis=0)
        assert resid.max() < 5e-2, resid


# -- the k-NN graph and component repair -------------------------------------


@pytest.mark.parametrize("metric", ["sqeuclidean", "l1"])
def test_knn_graph_equals_jax_with_tied_distances(rng, metric):
    x = _grid_points(rng, 700, 3)
    got = tsp.neighbors.knn_graph(x, 6, metric=metric, device=DEV)
    want = jsp.neighbors.knn_graph(x, 6, metric=metric)
    _assert_coo_equal(got, want)
    assert got.rows.dtype == torch.int32 and got.vals.dtype == torch.float32


def test_knn_graph_does_not_depend_on_the_query_batch(rng, monkeypatch):
    x = _grid_points(rng, 500, 4)
    whole = tsp.neighbors.knn_graph(x, 5, device=DEV)
    # 4 bytes x 500 rows x 37 = a 37-row batch
    monkeypatch.setattr(tsp.neighbors, "BLOCK_BUDGET_BYTES", 4 * 500 * 37)
    batched = tsp.neighbors.knn_graph(x, 5, device=DEV)
    _assert_coo_equal(batched, whole)


def test_cross_component_nn_and_connect_components_equal_jax(rng, monkeypatch):
    x = _grid_points(rng, 400, 3, n_blobs=6, spread=2)
    labels = rng.integers(0, 5, 400)
    td, ti = tsp.neighbors.cross_component_nn(x, labels, device=DEV)
    jd, ji = jsp.neighbors.cross_component_nn(x, labels)
    np.testing.assert_array_equal(_np(td), _np(jd))
    np.testing.assert_array_equal(_np(ti), _np(ji))
    assert ti.dtype == torch.int32
    # 4 bytes x 400 columns x 7 rows: 58 blocks, the same answer
    with monkeypatch.context() as mp:
        mp.setattr(tsp.neighbors, "BLOCK_BUDGET_BYTES", 4 * 400 * 7)
        bd, bi = tsp.neighbors.cross_component_nn(x, labels, device=DEV)
    assert torch.equal(bd, td) and torch.equal(bi, ti)
    _assert_coo_equal(tsp.neighbors.connect_components(x, labels, device=DEV),
                      jsp.neighbors.connect_components(x, labels))
    empty = tsp.neighbors.connect_components(x, np.zeros(400, np.int64), device=DEV)
    assert empty.nnz == 0


# -- sparse distances and k-NN ------------------------------------------------

_METRIC_NAMES = [m.name for m in jsp.distance.SUPPORTED_DISTANCES]


def _prob_rows(d):
    s = d.sum(1, keepdims=True)
    return np.where(s > 0, d / np.where(s > 0, s, 1), d).astype(np.float32)


@pytest.mark.parametrize("metric", _METRIC_NAMES)
def test_pairwise_distance_every_metric_matches_jax(rng, metric):
    xd = _sparse_dense(rng, (45, 60), 0.3)
    yd = _sparse_dense(rng, (33, 60), 0.3)
    if metric in ("KLDivergence", "JensenShannon", "HellingerExpanded"):
        xd, yd = _prob_rows(xd), _prob_rows(yd)
    if metric in ("JaccardExpanded", "DiceExpanded", "RusselRaoExpanded"):
        xd, yd = (xd > 0).astype(np.float32), (yd > 0).astype(np.float32)
    tx, ty = tsp.dense_to_csr(xd, device=DEV), tsp.dense_to_csr(yd, device=DEV)
    jx, jy = jsp.dense_to_csr(xd), jsp.dense_to_csr(yd)
    m = getattr(jsp.distance.DistanceType, metric)
    got = _np(tsp.distance.pairwise_distance(tx, ty, int(m), p=3.0))
    want = _np(jsp.distance.pairwise_distance(jx, jy, m, p=3.0))
    assert got.dtype == np.float32 and got.shape == (45, 33)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("metric", ["sqeuclidean", "l1", "canberra", "hamming",
                                    "correlation", "russellrao", "cosine"])
def test_streamed_and_compacted_paths_match_jax(rng, metric):
    """y over the densify budget (x dense, y streamed); both over it;
    and one block pair over it, which compacts the column space."""
    xd = _sparse_dense(rng, (50, 4000), 0.003)
    yd = _sparse_dense(rng, (70, 4000), 0.003)
    tx, ty = tsp.dense_to_csr(xd, device=DEV), tsp.dense_to_csr(yd, device=DEV)
    jx, jy = jsp.dense_to_csr(xd), jsp.dense_to_csr(yd)
    for budget, rb in ((4 * 4000 * 60, 16), (4 * 4000 * 40, 16), (4 * 4000 * 20, None)):
        got = _np(tsp.distance.pairwise_distance(tx, ty, metric, densify_budget_bytes=budget,
                                                 row_block=rb))
        want = _np(jsp.distance.pairwise_distance(jx, jy, metric, densify_budget_bytes=budget,
                                                  row_block=rb))
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="densify_budget_bytes"):
        tsp.distance.pairwise_distance(tx, ty, metric, densify_budget_bytes=64)


@pytest.mark.parametrize("metric", ["sqeuclidean", "l1"])
def test_sparse_knn_equals_jax_across_dataset_blocks(rng, metric, monkeypatch):
    """5000 dataset rows: two dense blocks merged; integer grid values so
    every distance is exact and equal ones tie by row."""
    xd = _sparse_dense(rng, (5000, 24), 0.2, grid=True)
    yd = _sparse_dense(rng, (40, 24), 0.2, grid=True)
    tx, ty = tsp.dense_to_csr(xd, device=DEV), tsp.dense_to_csr(yd, device=DEV)
    tv, ti = tsp.distance.knn(tx, ty, 10, metric=metric)
    jv, ji = jsp.distance.knn(jsp.dense_to_csr(xd), jsp.dense_to_csr(yd), 10, metric=metric)
    np.testing.assert_array_equal(_np(ti), _np(ji))
    np.testing.assert_array_equal(_np(tv), _np(jv))
    assert ti.dtype == torch.int32
    # queries in batches of 3: the same answer
    with monkeypatch.context() as mp:
        mp.setattr(tsp.neighbors, "BLOCK_BUDGET_BYTES", 4 * 4096 * 3)
        bv, bi = tsp.distance.knn(tx, ty, 10, metric=metric)
    assert torch.equal(bi, ti) and torch.equal(bv, tv)
    small_v, small_i = tsp.distance.knn(tsp.csr_row_slice(tx, 0, 300), ty, 5, metric=metric)
    jsv, jsi = jsp.distance.knn(jsp.dense_to_csr(xd[:300]), jsp.dense_to_csr(yd), 5, metric=metric)
    np.testing.assert_array_equal(_np(small_i), _np(jsi))


def test_bad_metric_and_columns_raise(rng):
    x = tsp.dense_to_csr(_sparse_dense(rng, (4, 5), 0.5), device=DEV)
    y = tsp.dense_to_csr(_sparse_dense(rng, (4, 6), 0.5), device=DEV)
    with pytest.raises(ValueError, match="not supported"):
        tsp.distance.pairwise_distance(x, x, "haversine")
    with pytest.raises(ValueError, match="column"):
        tsp.distance.pairwise_distance(x, y)


def test_deprecated_aliases_warn():
    import importlib
    import sys

    for name in ("raft_tpu_torch.sparse.hierarchy", "raft_tpu_torch.sparse.selection"):
        sys.modules.pop(name, None)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            mod = importlib.import_module(name)
        assert any(issubclass(w.category, DeprecationWarning) for w in caught), name
        assert all(callable(getattr(mod, n)) for n in mod.__all__)
    from raft_tpu_torch.sparse.selection import knn_graph

    assert knn_graph is tsp.neighbors.knn_graph
