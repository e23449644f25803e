"""PyTorch port: the IVF-RaBitQ slice against the JAX package.

The slice: build -> search(scan_engine "xla" or "fused") -> exact rerank
through neighbors/refine. The JAX fused engine runs its Pallas kernel in
interpret mode; the port runs its plain versions on the CPU.

The two packages draw their rotations from different generators, so
parity goes through one index: a JAX index over 3000 x 32 grid rows,
n_lists 16 (as test_fused_int_scan.py:263-282), carried across with
`index_from_arrays`. Its rotation is a signed permutation (the JAX coarse
centers mapped into that basis, the rows placed by the JAX extend): a
random rotation's `queries @ rotation.T` is summed in another order by
torch's and XLA's matmuls, and those ulps reach every score. With an
exact rotation, on that index:
- without rerank, both engines against the JAX engine of the same name,
  L2, L2Sqrt and inner product, k 1, 10, 100: ids exact and values bit for
  bit (the port quantizes, sums and rounds the estimator as the compiled
  reference does, and takes a correctly rounded sqrt). One exception:
  the JAX fused engine takes inner product's q . center as a dot product
  (its "xla" engine and the port as a reduction), so there values agree
  to rtol 1e-5 of the row's largest magnitude;
- k past the probed width: ids exact, the tail (worst, -1) in both;
- the port's two engines agree bit for bit with each other;
- with rerank (rerank_mult 4, the rows as refine_dataset): ids exact,
  values bit for bit (grid rows: exact distances);
- extend with custom indices: the same slot tables as the JAX extend
  (codes and aux bit for bit), and the same search answers.
The port's own build reaches the JAX tests' recall (test_ivf_rabitq.py:65),
and past 1024 lists (the hierarchical coarse trainer) the JAX build's
recall within 0.03.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch

from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_rabitq as jr
from raft_tpu.random import make_blobs
from raft_tpu_torch.neighbors import ivf_rabitq as tr
from raft_tpu_torch.ops.pq_list_scan import lane_padded

N_LISTS, NQ = 16, 16
METRICS = ("sqeuclidean", "euclidean", "inner_product")


def _grid(rng, shape, lo=-8, hi=8):
    return rng.integers(lo, hi, shape).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(3)
    return _grid(rng, (3000, 32)), _grid(rng, (NQ, 32))


@pytest.fixture(scope="module")
def indexes(data):
    """{metric: (JAX index, the port's copy of it)}, both without rows."""
    x, _ = data
    prng = np.random.default_rng(11)
    perm = np.zeros((32, 32), np.float32)
    perm[np.arange(32), prng.permutation(32)] = prng.choice([-1.0, 1.0], 32)
    out = {}
    for metric in METRICS:
        jb = jr.build(jr.IndexParams(n_lists=N_LISTS, kmeans_n_iters=4, store_dataset=False,
                                     metric=metric, add_data_on_build=False), x)
        # the trained centers, mapped from the build's basis into perm's
        cent = (np.asarray(jb.centers) @ np.asarray(jb.rotation) @ perm.T).astype(np.float32)
        jidx = jr.extend(jr.Index(jb.params, jnp.asarray(perm), jnp.asarray(cent), jb.codes,
                                  jb.aux, jb.slot_rows, jb.list_sizes, jb.source_ids), x)
        arrays = {f: np.asarray(getattr(jidx, f)) for f in tr.INDEX_FIELDS}
        tidx = tr.index_from_arrays(arrays, tr.IndexParams(n_lists=N_LISTS, metric=metric,
                                                           store_dataset=False), device="cpu")
        out[metric] = (jidx, tidx)
    return out


def _bitwise(port, ref):
    (tv, ti), (jv, ji) = port, ref
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))


def _close_rows(t, j, rtol=1e-5):
    fin = np.isfinite(j)
    np.testing.assert_array_equal(np.isfinite(t), fin)
    np.testing.assert_array_equal(t[~fin], j[~fin])
    scale = np.maximum(np.where(fin, np.abs(j), 0).max(axis=-1, keepdims=True), 1.0)
    err = np.where(fin, np.abs(t - j), 0)
    assert (err <= rtol * scale).all(), float(err.max())


def _search_pair(indexes, metric, engine, q, k, n_probes=N_LISTS, rerank_mult=0, ds=None):
    jidx, tidx = indexes[metric]
    extra_j = {} if ds is None else {"refine_dataset": ds}
    extra_t = {} if ds is None else {"refine_dataset": torch.tensor(ds)}
    jv, ji = jr.search(jr.SearchParams(n_probes=n_probes, scan_engine=engine,
                                       rerank_mult=rerank_mult), jidx, q, k, **extra_j)
    tv, ti = tr.search(tr.SearchParams(n_probes=n_probes, scan_engine=engine,
                                       rerank_mult=rerank_mult), tidx, torch.tensor(q), k,
                       **extra_t)
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("engine", ["xla", "fused"])
@pytest.mark.parametrize("metric", METRICS)
def test_engines_match_jax_without_rerank(data, indexes, metric, engine, k):
    _, q = data
    (jv, ji), (tv, ti) = _search_pair(indexes, metric, engine, q, k)
    assert ti.shape == (NQ, k) and ti.dtype == np.int32 and tv.dtype == np.float32
    np.testing.assert_array_equal(ti, ji)
    if metric == "inner_product" and engine == "fused":
        _close_rows(tv, jv)  # the JAX fused engine's q . center is a dot product
    else:
        _bitwise((tv, ti), (jv, ji))


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_k_past_the_probed_width(data, indexes, metric):
    _, q = data
    (jv, ji), (tv, ti) = _search_pair(indexes, metric, "xla", q, 1500, n_probes=2)
    _bitwise((tv, ti), (jv, ji))
    assert (ti[:, -1] == -1).all()


@pytest.mark.parametrize("metric", METRICS)
def test_port_engines_agree_bit_for_bit(data, indexes, metric):
    _, q = data
    tidx = indexes[metric][1]
    out = [tr.search(tr.SearchParams(n_probes=8, scan_engine=e), tidx, torch.tensor(q), 40)
           for e in ("xla", "fused")]
    np.testing.assert_array_equal(out[0][1].numpy(), out[1][1].numpy())
    np.testing.assert_array_equal(out[0][0].numpy().view(np.int32),
                                  out[1][0].numpy().view(np.int32))


@pytest.mark.parametrize("engine", ["xla", "fused"])
@pytest.mark.parametrize("metric", METRICS)
def test_rerank_matches_jax(data, indexes, metric, engine):
    x, q = data
    (jv, ji), (tv, ti) = _search_pair(indexes, metric, engine, q, 10, n_probes=8, rerank_mult=4,
                                      ds=x)
    _bitwise((tv, ti), (jv, ji))


def test_extend_with_custom_indices(data, indexes):
    x, q = data
    jidx, tidx = indexes["sqeuclidean"]
    ids = np.arange(3000, 3500, dtype=np.int32)[::-1].copy()
    new = _grid(np.random.default_rng(9), (500, 32))
    jext = jr.extend(jidx, new, ids)
    text = tr.extend(tidx, torch.tensor(new), torch.tensor(ids))
    assert text.size == jext.size == 3500
    for f in ("slot_rows", "list_sizes", "source_ids"):
        np.testing.assert_array_equal(getattr(text, f).numpy(), np.asarray(getattr(jext, f)))
    np.testing.assert_array_equal(text.codes.numpy(), np.asarray(jext.codes).view(np.int32))
    np.testing.assert_array_equal(text.aux.numpy().view(np.int32),
                                  np.asarray(jext.aux).view(np.int32))
    sp_j = jr.SearchParams(n_probes=8, scan_engine="fused")
    _, ji = jr.search(sp_j, jext, q, 10)
    _, ti = tr.search(tr.SearchParams(n_probes=8, scan_engine="fused"), text, torch.tensor(q), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    assert tidx.size == 3000  # extend returns a new index


def test_derived_store_matches_jax(indexes):
    jidx, tidx = indexes["sqeuclidean"]
    lpad = lane_padded(int(tidx.codes.shape[1]))
    jc, jm, js = (np.asarray(a) for a in jr.derive_bitplane_tables(
        jidx.codes, jidx.aux, jidx.slot_rows, lpad))
    tc, tm, ts = tr.derive_bitplane_tables(tidx.codes, tidx.aux, tidx.slot_rows, lpad)
    np.testing.assert_array_equal(tc.numpy(), jc.view(np.int32))
    np.testing.assert_array_equal(tm.numpy(), jm)
    np.testing.assert_array_equal(ts.numpy(), js)
    tr.build_bitplane_store(tidx, 40)
    assert tidx.fused_kb == 128 and tidx.codes_t.shape == (N_LISTS, 1, lpad)
    tr.build_bitplane_store(tidx, 200)
    tr.build_bitplane_store(tidx, 10)  # the buffer width only grows
    assert tidx.fused_kb == 256


def test_own_build_reaches_the_jax_recall():
    """test_ivf_rabitq.py:65: recall@10 >= 0.9 at n_probes 16,
    rerank_mult 8 on 4000 x 48 blobs (the rows stored on the index)."""
    blobs, _ = make_blobs(4000, 48, n_clusters=24, cluster_std=0.8, seed=21)
    blobs = np.asarray(blobs, np.float32)
    exact = np.asarray(jbf.knn(blobs, blobs[:50], 10)[1])
    idx = tr.build(tr.IndexParams(n_lists=32, kmeans_n_iters=6), blobs, device="cpu")
    assert idx.rot_dim == 64 and idx.words == 2 and idx.codes.dtype == torch.int32
    rot = idx.rotation.numpy()
    np.testing.assert_allclose(rot.T @ rot, np.eye(48), atol=1e-5)
    for engine in ("xla", "fused"):
        v, i = tr.search(tr.SearchParams(n_probes=16, rerank_mult=8, scan_engine=engine), idx,
                         torch.tensor(blobs[:50]), 10)
        i = i.numpy()
        rec = np.mean([len(set(i[r]) & set(exact[r])) / 10 for r in range(50)])
        assert rec >= 0.9, (engine, rec)
        d0 = ((blobs[:50] - blobs[i[:, 0]]) ** 2).sum(1)  # exact after the rerank
        np.testing.assert_allclose(v.numpy()[:, 0], d0, rtol=1e-4, atol=1e-3)


def test_build_past_1024_lists_reaches_the_jax_recall():
    rng = np.random.default_rng(33)
    blobs = rng.uniform(-5, 5, (64, 32)).astype(np.float32)
    x = (blobs[rng.integers(0, 64, 10_000)] + rng.standard_normal((10_000, 32))).astype(np.float32)
    q = (blobs[rng.integers(0, 64, 32)] + rng.standard_normal((32, 32))).astype(np.float32)
    truth = np.asarray(jbf.knn(x, q, 10)[1])

    def recall(ids):
        return np.mean([len(set(ids[r]) & set(truth[r])) / 10 for r in range(len(q))])

    params = dict(n_lists=1025, kmeans_n_iters=5)
    sp = dict(n_probes=32, rerank_mult=8, scan_engine="xla")
    jidx = jr.build(jr.IndexParams(**params), x)
    tidx = tr.build(tr.IndexParams(**params), x, device="cpu")
    assert tidx.centers.shape == (1025, 32) and int(tidx.list_sizes.sum()) == 10_000
    jrec = recall(np.asarray(jr.search(jr.SearchParams(**sp), jidx, q, 10)[1]))
    trec = recall(tr.search(tr.SearchParams(**sp), tidx, torch.tensor(q), 10)[1].numpy())
    assert trec >= jrec - 0.03, (trec, jrec)


def test_not_ported_and_bad_requests(tmp_path, data, indexes):
    _, q = data
    jidx, tidx = indexes["sqeuclidean"]
    qt = torch.tensor(q)
    # a prefilter is ported now: held to the JAX search on the same mask
    keep = np.random.default_rng(5).random(3000) < 0.5
    sp = dict(n_probes=N_LISTS, scan_engine="xla")
    jv, ji = jr.search(jr.SearchParams(**sp), jidx, q, 10, prefilter=keep)
    tv, ti = tr.search(tr.SearchParams(**sp), tidx, qt, 10, prefilter=keep)
    _bitwise((tv.numpy(), ti.numpy()), (np.asarray(jv), np.asarray(ji)))
    assert keep[ti.numpy()].all()
    with pytest.raises(ValueError):  # adaptive probing is ported; JAX raises alike
        tr.search(tr.SearchParams(recall_target="high"), tidx, qt, 10)
    tr.save(str(tmp_path / "x.ckpt"), tidx)  # save/load are ported: a round trip
    loaded = tr.load(str(tmp_path / "x.ckpt"), device="cpu")
    _bitwise(tuple(t.numpy() for t in tr.search(tr.SearchParams(**sp), loaded, qt, 10)),
             tuple(t.numpy() for t in tr.search(tr.SearchParams(**sp), tidx, qt, 10)))
    np.testing.assert_array_equal(tidx.list_radii.numpy(), np.asarray(jidx.list_radii))
    with pytest.raises(ValueError, match=r"\[1, 8\]"):
        tr.search(tr.SearchParams(query_bits=9), tidx, qt, 10)
    with pytest.raises(ValueError, match="unknown scan_engine"):
        tr.search(tr.SearchParams(scan_engine="nope"), tidx, qt, 10)
    with pytest.raises(ValueError, match="k must be positive"):
        tr.search(tr.SearchParams(), tidx, qt, 0)
    fresh = tr.Index(tidx.params, tidx.rotation, tidx.centers, tidx.codes, tidx.aux,
                     tidx.slot_rows, tidx.list_sizes, tidx.source_ids)
    with pytest.raises(ValueError, match="caps scan candidates at 256"):
        tr.search(tr.SearchParams(scan_engine="fused"), fresh, qt, 257)
    assert fresh.codes_t is None  # rejected before the fused store was derived
    with pytest.raises(ValueError, match="missing fields"):
        tr.index_from_arrays({}, tr.IndexParams(), device="cpu")
    assert tr.resolve_rerank_mult(0) == 4 and tr.resolve_query_bits(0) == 8
    assert tr.rerank_depth(10, 4) == 40 and tr.rerank_depth(100, 4) == 256
    assert tr.rerank_depth(300, 4) == 300
