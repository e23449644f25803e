"""PyTorch port: the C++ host routines of the graph path
(`raft_tpu_torch/native`, built from `raft_tpu_torch/csrc/graph_host.cc`
with the system compiler) against their Python twins and against the
JAX package's dendrogram and cut on the same numpy inputs. Every
comparison is exact: these are integer algorithms over the same edge
order (tied weights included).
"""

import importlib

import numpy as np
import pytest

from raft_tpu_torch import native

# the modules (each package's `single_linkage` name is the function)
jsl = importlib.import_module("raft_tpu.cluster.single_linkage")
tsl = importlib.import_module("raft_tpu_torch.cluster.single_linkage")


def _tree_edges(rng, n, n_extra, n_weights):
    """A random spanning tree plus extra edges (cycles), weights from a
    few values so that many tie."""
    perm = rng.permutation(n)
    src = [perm[i] for i in range(1, n)]
    dst = [perm[rng.integers(0, i)] for i in range(1, n)]
    src += list(rng.integers(0, n, n_extra))
    dst += list(rng.integers(0, n, n_extra))
    w = rng.integers(0, n_weights, len(src)).astype(np.float32) / 4
    return np.array(src, np.int32), np.array(dst, np.int32), w


def test_library_builds_into_the_ignored_build_dir():
    assert native.available(), native.load_error()
    target = native._target()
    assert target.parent.name == "_build" and target.parent.parent.name == "raft_tpu_torch"
    assert target.exists() and target.name.startswith("graph_host_")


@pytest.mark.parametrize("n,n_extra,n_weights", [(2, 0, 1), (50, 0, 3), (300, 200, 4),
                                                 (1000, 3000, 7)])
def test_mst_linkage_native_equals_the_python_loop(n, n_extra, n_weights):
    rng = np.random.default_rng(n)
    src, dst, w = _tree_edges(rng, n, n_extra, n_weights)
    order = np.argsort(w, kind="stable")
    s, d, ww = src[order], dst[order], w[order]
    got = native.mst_linkage(s, d, ww, n)
    want = tsl._mst_linkage_plain(n, s, d, ww)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype
        np.testing.assert_array_equal(g, x)
    assert len(got[0]) == n - 1


@pytest.mark.parametrize("n_clusters", [1, 2, 7, 40])
def test_cut_tree_native_equals_the_python_loop(n_clusters):
    rng = np.random.default_rng(3)
    n = 400
    src, dst, w = _tree_edges(rng, n, 100, 5)
    children, _, _ = tsl._mst_linkage(n, src, dst, w)
    got = native.cut_tree(children, n, n_clusters)
    want = tsl._cut_tree_plain(n, children, n_clusters)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    assert got.max() + 1 == n_clusters


def test_dendrogram_and_cut_equal_the_jax_package():
    rng = np.random.default_rng(11)
    n = 600
    src, dst, w = _tree_edges(rng, n, 400, 3)
    for g, x in zip(tsl._mst_linkage(n, src, dst, w), jsl._mst_linkage(n, src, dst, w)):
        np.testing.assert_array_equal(g, x)
    children = tsl._mst_linkage(n, src, dst, w)[0]
    for k in (1, 5, 33):
        np.testing.assert_array_equal(tsl._cut_tree(n, children, k),
                                      jsl._cut_tree(n, children, k))


def test_indptr_and_monotonic_equal_numpy():
    rng = np.random.default_rng(5)
    rows = rng.integers(0, 40, 500)
    indptr = native.coo_rows_to_indptr(rows, 40)
    np.testing.assert_array_equal(indptr[1:], np.cumsum(np.bincount(rows, minlength=40)))
    assert indptr[0] == 0 and indptr.dtype == np.int64
    assert native.coo_rows_to_indptr(np.array([0, 40]), 40) is None
    labels = rng.integers(-5, 1000, 300)
    mono, uniq = native.make_monotonic(labels)
    want_uniq, want_mono = np.unique(labels, return_inverse=True)
    np.testing.assert_array_equal(mono, want_mono)
    np.testing.assert_array_equal(uniq, want_uniq)


def test_bad_input_gives_none():
    assert native.mst_linkage(np.array([0], np.int32), np.array([5], np.int32),
                              np.zeros(1, np.float32), 3) is None
    assert native.cut_tree(np.zeros((0, 2), np.int64), 3, 0) is None
