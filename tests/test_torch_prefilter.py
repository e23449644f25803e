"""PyTorch port: sample filtering (`prefilter=`) against the JAX package.

One seeded mask goes through the JAX package and the port on the same
numpy inputs, for every engine of every index family, each held to the
tolerance its unfiltered parity test states:

- brute force, "tiled" and "fused", on integer grids: ids and values
  exact (tests/test_torch_brute_force.py);
- IVF-Flat on a carried index, "query" and "list": ids equal away from
  float64 near-ties, values to rtol 1e-5; "pallas": ids in at least 99%
  of slots, values to rtol 1e-4 where they agree
  (tests/test_torch_ivf_flat.py);
- IVF-PQ on a carried index, trims "fused" and "pallas" on bf16 and int8
  rows, a 4k shortlist refined to k: shortlists and ids agree in at least
  99% of slots, values to rtol 1e-4 where they agree
  (tests/test_torch_ivf_pq.py);
- IVF-RaBitQ on a carried index with a signed-permutation rotation,
  "xla" and "fused" without rerank: ids exact and values bit for bit
  (tests/test_torch_ivf_rabitq.py).

Every id returned passes the filter. Beside them: a filter that keeps
k - 1 rows (the tail is id -1 with the worst value), a filter that keeps
one IVF list, and a brute-force survivor whose distance is +inf, which
keeps its id.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch

from raft_tpu.core import bitset as jbs
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import ivf_rabitq as jr
from raft_tpu.neighbors import refine as jax_refine
from raft_tpu_torch.core import bitset as tbs
from raft_tpu_torch.neighbors import brute_force as tbf
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import ivf_rabitq as tr
from raft_tpu_torch.neighbors.refine import refine as torch_refine

N, DIM, NQ, K = 3000, 32, 24, 10
N_LISTS, N_PROBES = 16, 4


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    centers = rng.uniform(-5, 5, (N_LISTS, DIM)).astype(np.float32)
    x = (centers[rng.integers(0, N_LISTS, N)] + rng.standard_normal((N, DIM))).astype(np.float32)
    q = (centers[rng.integers(0, N_LISTS, NQ)] + rng.standard_normal((NQ, DIM))).astype(np.float32)
    keep = np.random.default_rng(23).random(N) < 0.5
    return x, q, keep


def _all_pass(ids, keep):
    ids = np.asarray(ids)
    assert keep[ids[ids >= 0]].all(), "a returned id fails the filter"


def _tail_is_worst(vals, ids, n_kept, worst=np.inf):
    vals, ids = np.asarray(vals), np.asarray(ids)
    assert (ids[:, :n_kept] >= 0).all()
    assert (ids[:, n_kept:] == -1).all() and (vals[:, n_kept:] == worst).all()


# --- brute force ---------------------------------------------------------


def _grid(rng, shape):
    return rng.integers(-6, 7, shape).astype(np.float32)


@pytest.mark.parametrize("engine", ["tiled", "fused"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_brute_force_matches_jax(engine, metric):
    rng = np.random.default_rng(1)
    ds, q = _grid(rng, (900, 24)), _grid(rng, (21, 24))
    keep = rng.random(900) < 0.5
    jv, ji = jbf.knn(ds, q, K, metric=metric, engine=engine, prefilter=keep)
    tv, ti = tbf.knn(ds, q, K, metric=metric, engine=engine, prefilter=keep, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _all_pass(ti, keep)
    # a Bitset, and a JAX bitset's words carried across, give the same
    for pf in (tbs.Bitset.from_mask(keep), tbs.Bitset(np.asarray(jbs.Bitset.from_mask(keep).bits),
                                                      900)):
        np.testing.assert_array_equal(
            tbf.knn(ds, q, K, metric=metric, engine=engine, prefilter=pf, device="cpu")[1],
            ti.numpy())


def test_brute_force_tiled_merge_matches_jax():
    """Tiles far below n: the mask applies tile by tile, the padded last
    tile included."""
    from raft_tpu.distance.distance_types import resolve_metric
    from raft_tpu.neighbors.brute_force import _bf_knn_impl

    rng = np.random.default_rng(2)
    ds, q = _grid(rng, (1000, 8)), _grid(rng, (9, 8))
    keep = rng.random(1000) < 0.3
    jv, ji = _bf_knn_impl(ds, q, K, resolve_metric("sqeuclidean"), tile=128,
                          prefilter=jbs.Bitset.from_mask(keep))
    tv, ti = tbf._bf_knn_impl(torch.tensor(ds), torch.tensor(q), K,
                              tbf.resolve_metric("sqeuclidean"), tile=128,
                              prefilter=tbs.Bitset.from_mask(keep))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("engine", ["tiled", "fused"])
def test_brute_force_keeps_k_minus_one_rows(engine):
    rng = np.random.default_rng(3)
    ds, q = _grid(rng, (500, 16)), _grid(rng, (7, 16))
    keep = np.zeros(500, bool)
    keep[rng.choice(500, K - 1, replace=False)] = True
    jv, ji = jbf.knn(ds, q, K, engine=engine, prefilter=keep)
    tv, ti = tbf.knn(ds, q, K, engine=engine, prefilter=keep, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    _tail_is_worst(tv, ti, K - 1)
    _all_pass(ti, keep)


def test_brute_force_survivor_at_infinite_distance_keeps_its_id():
    rng = np.random.default_rng(4)
    ds, q = _grid(rng, (300, 8)), _grid(rng, (5, 8))
    # every squared distance to row 0 overflows to +inf; at +inf it ties
    # with the masked rows and wins on its id, the smallest
    ds[0] = 1e30
    keep = np.zeros(300, bool)
    keep[[0, 20, 40]] = True
    jv, ji = jbf.knn(ds, q, 4, prefilter=keep)
    tv, ti = tbf.knn(ds, q, 4, prefilter=keep, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert (ti.numpy()[:, 2] == 0).all() and np.isinf(tv.numpy()[:, 2]).all()
    assert (ti.numpy()[:, 3] == -1).all()


# --- IVF-Flat ------------------------------------------------------------


@pytest.fixture(scope="module")
def flat(data):
    x, _, _ = data
    jidx = jfl.build(jfl.IndexParams(n_lists=N_LISTS, kmeans_n_iters=5), x)
    arrays = {f: np.asarray(getattr(jidx, f)) for f in tfl.INDEX_FIELDS}
    return jidx, tfl.index_from_arrays(arrays, tfl.IndexParams(n_lists=N_LISTS), device="cpu")


def _flat_pair(flat, engine, q, keep, k=K, n_probes=N_PROBES):
    jidx, tidx = flat
    jv, ji = jfl.search(jfl.SearchParams(n_probes=n_probes, engine=engine), jidx, q, k,
                        prefilter=keep)
    tv, ti = tfl.search(tfl.SearchParams(n_probes=n_probes, engine=engine), tidx,
                        torch.tensor(q), k, prefilter=keep)
    return (tv.numpy(), ti.numpy()), (np.asarray(jv), np.asarray(ji))


def _flat_parity(x, q, engine, port, ref):
    (tv, ti), (jv, ji) = port, ref
    if engine == "pallas":
        same = ti == ji
        assert same.mean() >= 0.99, same.mean()
        np.testing.assert_allclose(tv[same], jv[same], rtol=1e-4, atol=1e-4)
        return
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    diff = ti != ji
    if diff.any():  # only float64 near-ties may swap
        d = lambda ids: np.where(ids >= 0, ((x[np.maximum(ids, 0)].astype(np.float64)
                                             - q[:, None, :]) ** 2).sum(-1), np.nan)
        gap = np.abs(d(ti) - d(ji))
        assert (gap[diff] <= 1e-5 * np.nanmax(np.abs(d(ji)))).all()


@pytest.mark.parametrize("engine", ["query", "list", "pallas"])
def test_ivf_flat_matches_jax(data, flat, engine):
    x, q, keep = data
    port, ref = _flat_pair(flat, engine, q, keep)
    _flat_parity(x, q, engine, port, ref)
    _all_pass(port[1], keep)
    unfiltered = tfl.search(tfl.SearchParams(n_probes=N_PROBES, engine=engine), flat[1],
                            torch.tensor(q), K)[1].numpy()
    assert not keep[unfiltered].all()  # the filter had something to remove


@pytest.mark.parametrize("engine", ["query", "list", "pallas"])
def test_ivf_flat_keeps_k_minus_one_rows(data, flat, engine):
    x, q, _ = data
    keep = np.zeros(N, bool)
    keep[np.random.default_rng(5).choice(N, K - 1, replace=False)] = True
    port, ref = _flat_pair(flat, engine, q, keep, n_probes=N_LISTS)
    np.testing.assert_array_equal(port[1], ref[1])
    _flat_parity(x, q, engine, port, ref)
    _tail_is_worst(*port, K - 1)


@pytest.mark.parametrize("engine", ["query", "list", "pallas"])
def test_ivf_flat_filter_keeping_one_list(data, flat, engine):
    x, q, _ = data
    tidx = flat[1]
    sizes = tidx.list_sizes.numpy()
    li = int(np.argsort(sizes)[len(sizes) // 2])
    members = tidx.slot_rows[li][tidx.slot_rows[li] >= 0].long()
    keep = np.zeros(N, bool)
    keep[tidx.source_ids[members].numpy()] = True
    port, ref = _flat_pair(flat, engine, q, keep)
    np.testing.assert_array_equal(port[1], ref[1])
    _flat_parity(x, q, engine, port, ref)
    _all_pass(port[1], keep)
    from raft_tpu_torch.neighbors.ivf_flat import _probes

    probed = (_probes(torch.tensor(q), tidx.centers, N_PROBES, tidx.metric) == li).any(1).numpy()
    assert probed.any() and not probed.all()
    assert (port[1][~probed] == -1).all() and (port[1][probed, 0] >= 0).all()


# --- IVF-PQ --------------------------------------------------------------


@pytest.fixture(scope="module")
def pq(data):
    x, _, _ = data
    jidx = jpq.build(jpq.IndexParams(n_lists=N_LISTS, pq_dim=16, kmeans_n_iters=5), x)
    arrays = {f: np.asarray(getattr(jidx, f)) for f in tpq.INDEX_FIELDS}
    return jidx, arrays


@pytest.mark.parametrize("trim,dtype", [("fused", "bf16"), ("fused", "int8"),
                                        ("pallas", "bf16"), ("pallas", "int8")])
def test_ivf_pq_matches_jax(data, pq, trim, dtype):
    x, q, keep = data
    jidx, arrays = pq
    tidx = tpq.index_from_arrays(arrays, tpq.IndexParams(n_lists=N_LISTS, pq_dim=16),
                                 device="cpu")
    jsp = jpq.SearchParams(n_probes=N_PROBES, score_mode="recon8_list", trim_engine=trim,
                           score_dtype=dtype)
    _, jcand = jpq.search(jsp, jidx, q, 4 * K, prefilter=keep)
    jv, ji = (np.asarray(a) for a in jax_refine(x, q, jcand, K, strategy="fused"))
    tsp = tpq.SearchParams(n_probes=N_PROBES, trim_engine=trim, score_dtype=dtype)
    _, tcand = tpq.search(tsp, tidx, torch.tensor(q), 4 * K, prefilter=keep)
    tv, ti = (a.numpy() for a in torch_refine(torch.tensor(x), torch.tensor(q), tcand, K,
                                              strategy="fused", device="cpu"))
    jcand, tcand = np.asarray(jcand), tcand.numpy()
    _all_pass(tcand, keep)
    shortlist = np.mean([len(set(tcand[r]) & set(jcand[r])) / (4 * K) for r in range(NQ)])
    assert shortlist >= 0.99, shortlist
    same = ti == ji
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(tv[same], jv[same], rtol=1e-4)
    _all_pass(ti, keep)


def test_ivf_pq_keeps_k_minus_one_rows(data, pq):
    x, q, _ = data
    jidx, arrays = pq
    tidx = tpq.index_from_arrays(arrays, tpq.IndexParams(n_lists=N_LISTS, pq_dim=16),
                                 device="cpu")
    keep = np.zeros(N, bool)
    keep[np.random.default_rng(6).choice(N, K - 1, replace=False)] = True
    _, ji = jpq.search(jpq.SearchParams(n_probes=N_LISTS, score_mode="recon8_list",
                                        trim_engine="fused"), jidx, q, K, prefilter=keep)
    tv, ti = tpq.search(tpq.SearchParams(n_probes=N_LISTS, score_mode="recon8_list",
                                         trim_engine="fused"), tidx, torch.tensor(q), K,
                        prefilter=keep)
    for r in range(NQ):
        assert set(ti[r].tolist()) == set(np.asarray(ji)[r].tolist())
    _tail_is_worst(tv, ti, K - 1)


# --- IVF-RaBitQ ----------------------------------------------------------


@pytest.fixture(scope="module")
def rabitq():
    """A JAX index over grid rows with a signed-permutation rotation (as
    tests/test_torch_ivf_rabitq.py builds it) and the port's copy."""
    rng = np.random.default_rng(3)
    x = rng.integers(-8, 8, (3000, 32)).astype(np.float32)
    q = rng.integers(-8, 8, (16, 32)).astype(np.float32)
    prng = np.random.default_rng(11)
    perm = np.zeros((32, 32), np.float32)
    perm[np.arange(32), prng.permutation(32)] = prng.choice([-1.0, 1.0], 32)
    jb = jr.build(jr.IndexParams(n_lists=N_LISTS, kmeans_n_iters=4, store_dataset=False,
                                 add_data_on_build=False), x)
    cent = (np.asarray(jb.centers) @ np.asarray(jb.rotation) @ perm.T).astype(np.float32)
    jidx = jr.extend(jr.Index(jb.params, jnp.asarray(perm), jnp.asarray(cent), jb.codes, jb.aux,
                              jb.slot_rows, jb.list_sizes, jb.source_ids), x)
    arrays = {f: np.asarray(getattr(jidx, f)) for f in tr.INDEX_FIELDS}
    tidx = tr.index_from_arrays(arrays, tr.IndexParams(n_lists=N_LISTS, store_dataset=False),
                                device="cpu")
    return x, q, jidx, tidx


@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_ivf_rabitq_matches_jax(rabitq, engine):
    x, q, jidx, tidx = rabitq
    keep = np.random.default_rng(29).random(3000) < 0.5
    for k, mask in ((K, keep), (K, np.isin(np.arange(3000), np.flatnonzero(keep)[:K - 1]))):
        jv, ji = jr.search(jr.SearchParams(n_probes=N_LISTS, scan_engine=engine), jidx, q, k,
                           prefilter=mask)
        tv, ti = tr.search(tr.SearchParams(n_probes=N_LISTS, scan_engine=engine), tidx,
                           torch.tensor(q), k, prefilter=mask)
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy().view(np.int32), np.asarray(jv).view(np.int32))
        _all_pass(ti, mask)
    _tail_is_worst(tv, ti, K - 1)
