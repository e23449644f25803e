"""PyTorch port: IVF-Flat build, extend and search against the JAX package.

Parity goes through one index: a JAX index over 4000 x 32 blob rows,
n_lists 16, carried across with `index_from_arrays`; n_probes 4, k 10.
The JAX "pallas" engine runs its Pallas kernel in interpret mode; the
port runs its plain kernel versions on the CPU.

- "query" and "list" (exact f32 over the probed lists): ids equal to
  JAX's except where the two ids' float64 distances are a near-tie
  (within 1e-5 of the row's scale: the f32 sums run in another order),
  values to rtol 1e-5;
- "pallas"/"fused" (bf16 residual store): ids agree in at least 99% of
  slots, values to rtol 1e-4 where they agree;
- every engine under L2, L2SqrtExpanded and inner product;
- two query-block sizes of the "query" engine give equal answers;
- extend: custom ids move `id_bound` and come back from a search as the
  JAX extend's do; `adaptive_centers` moves the centers as JAX's do
  (rtol 1e-6);
- `resolve_auto_engine` decides as the JAX package does without a tuned
  value, over a grid of (nq, n_probes, n_lists);
- the port's own build reaches recall@10 within 0.03 of the JAX build's,
  and so does a build past 1024 lists (the hierarchical trainer);
- probes: k 257 on "pallas" raises before the residual store is built;
  save and load round-trip the index (tests/test_torch_serialize.py holds
  them to the JAX files); a build at 1025 lists of equal rows gives
  finite centers.
"""

import numpy as np
import pytest

import torch

from raft_tpu.core import tuned as jtuned
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.ops.pq_list_scan import lane_padded

N, DIM, NQ, K = 4000, 32, 48, 10
N_LISTS, N_PROBES = 16, 4
METRICS = ("sqeuclidean", "euclidean", "inner_product")


def _blobs(rng, n, centers):
    return (centers[rng.integers(0, len(centers), n)]
            + rng.standard_normal((n, centers.shape[1]))).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    centers = rng.uniform(-5, 5, (N_LISTS, DIM)).astype(np.float32)
    return _blobs(rng, N, centers), _blobs(rng, NQ, centers)


def _carry(jidx, metric, adaptive=False):
    arrays = {f: np.asarray(getattr(jidx, f)) for f in tfl.INDEX_FIELDS}
    return tfl.index_from_arrays(arrays, tfl.IndexParams(n_lists=N_LISTS, metric=metric,
                                                         adaptive_centers=adaptive),
                                 device="cpu")


@pytest.fixture(scope="module")
def indexes(data):
    """{metric: (JAX index, the port's copy of it)}."""
    x, _ = data
    out = {}
    for metric in METRICS:
        jidx = jfl.build(jfl.IndexParams(n_lists=N_LISTS, kmeans_n_iters=5, metric=metric), x)
        out[metric] = (jidx, _carry(jidx, metric))
    return out


def _f64_dist(x, q, ids, metric):
    """float64 distances of (query, id) pairs (ids -1 give nan)."""
    rows = x[np.maximum(ids, 0)].astype(np.float64)
    qq = q.astype(np.float64)[:, None, :]
    d = -(rows * qq).sum(-1) if metric == "inner_product" else ((rows - qq) ** 2).sum(-1)
    return np.where(ids >= 0, d, np.nan)


def _exact_parity(x, q, metric, port, ref):
    (tv, ti), (jv, ji) = port, ref
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    diff = ti != ji
    if diff.any():
        dt, dj = _f64_dist(x, q, ti, metric), _f64_dist(x, q, ji, metric)
        scale = np.maximum(np.nanmax(np.abs(dj), axis=1, keepdims=True), 1.0)
        gap = np.abs(dt - dj)
        assert (gap[diff] <= 1e-5 * np.broadcast_to(scale, gap.shape)[diff]).all(), \
            "ids differ away from float64 near-ties"


def _search(indexes, metric, engine, q, k=K, n_probes=N_PROBES, prefilter=None):
    jidx, tidx = indexes[metric]
    jv, ji = jfl.search(jfl.SearchParams(n_probes=n_probes, engine=engine), jidx, q, k,
                        prefilter=prefilter)
    tv, ti = tfl.search(tfl.SearchParams(n_probes=n_probes, engine=engine), tidx,
                        torch.tensor(q), k, prefilter=prefilter)
    return (tv.numpy(), ti.numpy()), (np.asarray(jv), np.asarray(ji))


@pytest.mark.parametrize("engine", ["query", "list"])
@pytest.mark.parametrize("metric", METRICS)
def test_exact_engines_match_jax(data, indexes, metric, engine):
    x, q = data
    port, ref = _search(indexes, metric, engine, q)
    assert port[1].shape == (NQ, K) and port[1].dtype == np.int32
    assert port[0].dtype == np.float32
    _exact_parity(x, q, metric, port, ref)


@pytest.mark.parametrize("metric", METRICS)
def test_fused_engine_matches_jax(data, indexes, metric):
    _, q = data
    (tv, ti), (jv, ji) = _search(indexes, metric, "pallas", q)
    same = ti == ji
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(tv[same], jv[same], rtol=1e-4, atol=1e-4)
    tidx = indexes[metric][1]
    lpad = lane_padded(int(tidx.list_data.shape[1]))
    assert tidx.list_data.shape[1] == lpad and tidx.resid_bf16.dtype == torch.bfloat16
    slot = torch.arange(lpad)[None, :]
    assert torch.all((tidx.slot_rows >= 0) == (slot < tidx.list_sizes[:, None]))
    pad = tidx.slot_rows < 0
    assert torch.all(tidx.resid_bf16[pad] == 0) and torch.all(tidx.resid_norm[pad] == 0)
    # "fused" is the same engine by its other name; the exact engines
    # still answer on the padded store
    tv2, ti2 = tfl.search(tfl.SearchParams(n_probes=N_PROBES, engine="fused"), tidx,
                          torch.tensor(q), K)
    np.testing.assert_array_equal(ti2.numpy(), ti)
    _exact_parity(data[0], q, metric, *_search(indexes, metric, "query", q))


def test_query_blocks_give_equal_answers(data, indexes):
    _, q = data
    tidx = indexes["sqeuclidean"][1]
    args = (torch.tensor(q), tidx.centers, tidx.list_data, tidx.slot_rows, K, N_PROBES,
            tidx.metric)
    v1, r1 = tfl._search_impl(*args, query_block=5)
    v2, r2 = tfl._search_impl(*args, query_block=NQ)
    np.testing.assert_array_equal(r1.numpy(), r2.numpy())
    np.testing.assert_array_equal(v1.numpy(), v2.numpy())


def _new_rows(n):
    """More rows from the blobs of `data`."""
    centers = np.random.default_rng(5).uniform(-5, 5, (N_LISTS, DIM)).astype(np.float32)
    return _blobs(np.random.default_rng(9), n, centers)


def test_extend_custom_ids_move_id_bound(data, indexes):
    x, q = data
    jb, tb = indexes["sqeuclidean"]
    tb = _carry(jb, "sqeuclidean")
    assert tb.id_bound == N
    nv = _new_rows(600)
    ids = np.arange(10_000, 10_600, dtype=np.int32)
    je = jfl.extend(jb, nv, ids)
    te = tfl.extend(tb, torch.tensor(nv), torch.tensor(ids))
    assert te.id_bound == je.id_bound == 10_600 and te.size == N + 600
    np.testing.assert_array_equal(te.slot_rows.numpy(), np.asarray(je.slot_rows))
    np.testing.assert_array_equal(te.list_data.numpy(), np.asarray(je.list_data))
    np.testing.assert_array_equal(te.dataset.numpy(), np.concatenate([x, nv]))
    jv, ji = jfl.search(jfl.SearchParams(n_probes=N_PROBES), je, q, K)
    tv, ti = tfl.search(tfl.SearchParams(n_probes=N_PROBES), te, torch.tensor(q), K)
    by_id = np.zeros((10_600, DIM), np.float32)
    by_id[:N], by_id[10_000:] = x, nv
    _exact_parity(by_id, q, "sqeuclidean", (tv.numpy(), ti.numpy()),
                  (np.asarray(jv), np.asarray(ji)))
    assert (ti.numpy() >= 10_000).any()  # the new rows come back under their ids


def test_extend_adaptive_centers_match_jax(indexes):
    jb, _ = indexes["sqeuclidean"]
    jb = jfl.Index(jfl.IndexParams(n_lists=N_LISTS, adaptive_centers=True), jb.centers,
                   jb.list_data, jb.slot_rows, jb.list_sizes, jb.source_ids)
    tb = _carry(jb, "sqeuclidean", adaptive=True)
    nv = _new_rows(2000)
    je = jfl.extend(jb, nv)
    te = tfl.extend(tb, torch.tensor(nv))
    assert not np.array_equal(np.asarray(je.centers), np.asarray(jb.centers))
    np.testing.assert_allclose(te.centers.numpy(), np.asarray(je.centers), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_array_equal(te.list_sizes.numpy(), np.asarray(je.list_sizes))


def test_auto_engine_matches_jax_without_a_tuned_value(monkeypatch):
    monkeypatch.setattr(jtuned, "get", lambda key, default=None: default)
    for nq in (1, 8, 100, 4096):
        for n_probes in (1, 4, 20, 64):
            for n_lists in (16, 256, 1024):
                want = jfl.resolve_auto_engine(nq, n_probes, n_lists, pallas_ok=lambda: True)
                assert tfl.resolve_auto_engine(nq, n_probes, n_lists,
                                               pallas_ok=lambda: True) == want


def test_auto_engine_search_matches_the_engine_it_names(data, indexes):
    x, q = data
    tidx = indexes["sqeuclidean"][1]
    for nq in (2, NQ):  # 2 * 4 / 16 < 4: "query"; 48 * 4 / 16 >= 4: "list"
        eng = tfl.resolve_auto_engine(nq, N_PROBES, N_LISTS)
        a = tfl.search(tfl.SearchParams(n_probes=N_PROBES, engine="auto"), tidx,
                       torch.tensor(q[:nq]), K)
        b = tfl.search(tfl.SearchParams(n_probes=N_PROBES, engine=eng), tidx,
                       torch.tensor(q[:nq]), K)
        np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    assert tfl.resolve_auto_engine(2, N_PROBES, N_LISTS) == "query"
    assert tfl.resolve_auto_engine(NQ, N_PROBES, N_LISTS) == "list"


def test_own_build_reaches_the_jax_recall(data):
    x, q = data
    truth = np.asarray(jbf.knn(x, q, K)[1])

    def recall(ids):
        return np.mean([len(set(ids[r]) & set(truth[r])) / K for r in range(NQ)])

    jidx = jfl.build(jfl.IndexParams(n_lists=N_LISTS, kmeans_n_iters=5), x)
    tidx = tfl.build(tfl.IndexParams(n_lists=N_LISTS, kmeans_n_iters=5), x, device="cpu")
    assert tidx.size == N and int(tidx.list_sizes.sum()) == N
    np.testing.assert_array_equal(np.sort(tidx.dataset.numpy(), axis=0), np.sort(x, axis=0))
    for n_probes in (2, 4):
        jr = recall(np.asarray(jfl.search(jfl.SearchParams(n_probes=n_probes), jidx, q, K)[1]))
        for engine in ("query", "list", "fused"):
            tr = recall(tfl.search(tfl.SearchParams(n_probes=n_probes, engine=engine), tidx,
                                   torch.tensor(q), K)[1].numpy())
            assert tr >= jr - 0.03, (n_probes, engine, tr, jr)


def test_build_past_1024_lists_reaches_the_jax_recall():
    """n_lists 1025 on 10,000 x 8 blob rows: both packages train the
    coarse centers with fit_hierarchical; recall@10 of the port's engines
    within 0.03 of the JAX default engine's."""
    rng = np.random.default_rng(32)
    blobs = rng.uniform(-5, 5, (64, 8)).astype(np.float32)
    x = (blobs[rng.integers(0, 64, 10_000)] + rng.standard_normal((10_000, 8))).astype(np.float32)
    q = (blobs[rng.integers(0, 64, 64)] + rng.standard_normal((64, 8))).astype(np.float32)
    truth = np.asarray(jbf.knn(x, q, K)[1])

    def recall(ids):
        return np.mean([len(set(ids[r]) & set(truth[r])) / K for r in range(len(q))])

    params = dict(n_lists=1025, kmeans_n_iters=5)
    jidx = jfl.build(jfl.IndexParams(**params), x)
    tidx = tfl.build(tfl.IndexParams(**params), x, device="cpu")
    assert tidx.centers.shape == (1025, 8) and int(tidx.list_sizes.sum()) == 10_000
    jr = recall(np.asarray(jfl.search(jfl.SearchParams(n_probes=32), jidx, q, K)[1]))
    for engine in ("query", "fused"):
        tr = recall(tfl.search(tfl.SearchParams(n_probes=32, engine=engine), tidx,
                               torch.tensor(q), K)[1].numpy())
        assert tr >= jr - 0.03, (engine, tr, jr)


def test_probes_raise(tmp_path, data, indexes):
    _, q = data
    jidx, tidx = indexes["sqeuclidean"]
    fresh = _carry(jidx, "sqeuclidean")
    width = fresh.list_data.shape[1]
    with pytest.raises(ValueError, match="caps per-list candidates at 256"):
        tfl.search(tfl.SearchParams(engine="pallas"), fresh, torch.tensor(q), 257)
    assert fresh.resid_bf16 is None and fresh.list_data.shape[1] == width  # untouched
    qt = torch.tensor(q)
    # adaptive probing is ported: a saturated plan is the fixed search
    fixed = tfl.search(tfl.SearchParams(n_probes=N_PROBES), tidx, qt, K)
    sat = tfl.search(tfl.SearchParams(n_probes=N_PROBES, recall_target=1.0), tidx, qt, K)
    for a, b in zip(fixed, sat):
        assert torch.equal(a, b)
    with pytest.raises(ValueError):
        tfl.search(tfl.SearchParams(recall_target="high"), tidx, qt, K)
    tfl.save(str(tmp_path / "x.ckpt"), tidx)  # save/load are ported: a round trip
    loaded = tfl.load(str(tmp_path / "x.ckpt"), device="cpu")
    for a, b in zip(fixed, tfl.search(tfl.SearchParams(n_probes=N_PROBES), loaded, qt, K)):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        tfl.load(str(tmp_path / "missing.ckpt"), device="cpu")
    assert tidx.list_radii.shape == (N_LISTS,) and torch.isfinite(tidx.list_radii).all()
    # past 1024 lists the build trains hierarchically (Queue A item 5 is
    # ported): 2000 equal rows still give 1025 finite centers
    wide = tfl.build(tfl.IndexParams(n_lists=1025), np.zeros((2000, 4), np.float32),
                     device="cpu")
    assert wide.centers.shape == (1025, 4) and torch.isfinite(wide.centers).all()
    assert int(wide.list_sizes.sum()) == 2000
    with pytest.raises(ValueError, match="unknown engine"):
        tfl.search(tfl.SearchParams(engine="nope"), tidx, qt, K)
    with pytest.raises(ValueError, match="query dim"):
        tfl.search(tfl.SearchParams(), tidx, qt[:, :5], K)
    with pytest.raises(ValueError, match="missing fields"):
        tfl.index_from_arrays({}, tfl.IndexParams(), device="cpu")
