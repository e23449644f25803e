"""PyTorch port: IVF-PQ's score modes, trims and per-cluster codebooks
against the JAX package.

Parity goes through JAX indexes (3000 x 32 blob rows, n_lists 16,
pq_dim 16) carried across with `index_from_arrays`; n_probes 4, k 40 (a
refine's shortlist). Every mode runs under L2, L2SqrtExpanded and inner
product on per-subspace codebooks, under L2 and inner product on
per-cluster ones, with and without a prefilter:

- f32 scores ("lut", "recon8", the "approx" and "exact" trims on bf16 and
  int8 rows): values within rtol 1e-5 of the row's scale (the port's
  matmuls sum in another order); ids equal, except between two
  candidates whose values are within that tolerance of each other;
- the bf16 LUT (`lut_dtype="bfloat16"`): the same, within 4e-3 (one bf16
  rounding of a table entry may differ);
- bf16 trim scores (`internal_distance_dtype="bfloat16"`): values equal
  bit for bit. The "exact" trim (`lax.top_k`, ties to the smaller slot)
  gives equal ids. The JAX "approx" trim is `lax.approx_min_k`, which its
  CPU backend computes with an unstable sort under a plain `<`: among
  equal scores its order is the sort's, where the port keeps the smaller
  slot first. So its ids are held per group of equal values: the same
  set of ids for every value but the row's last (the boundary group, of
  which each side keeps the same count).

Also: `_resolve_score_mode` and `SearchParams()` against the JAX
package's, a default search against the JAX default search, query blocks
of the lut and recon8 engines, per-cluster `_decode_quantize` and
`label_and_encode`, the per-cluster fused and pallas trims, and a
per-cluster build's recall against the JAX build's.
"""

import dataclasses

import numpy as np
import pytest

import torch

from raft_tpu.core import tuned as jtuned
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import refine as jax_refine
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors.refine import refine as torch_refine

N, DIM, NQ, K = 3000, 32, 48, 10
N_LISTS, PQ_DIM, N_PROBES = 16, 16, 4
SHORTLIST = 4 * K

MODES = {
    "lut": dict(score_mode="lut"),
    "lut_bf16": dict(score_mode="lut", lut_dtype="bfloat16"),
    "recon8": dict(score_mode="recon8"),
    "approx": dict(score_mode="recon8_list", trim_engine="approx"),
    "exact": dict(score_mode="recon8_list", trim_engine="exact"),
    "approx_int8": dict(score_mode="recon8_list", trim_engine="approx", score_dtype="int8"),
    "approx_bf16": dict(score_mode="recon8_list", trim_engine="approx",
                        internal_distance_dtype="bfloat16"),
    "exact_bf16": dict(score_mode="recon8_list", trim_engine="exact",
                       internal_distance_dtype="bfloat16"),
}
TOL = {"lut_bf16": 4e-3}
INDEXES = [("sqeuclidean", "per_subspace"), ("euclidean", "per_subspace"),
           ("inner_product", "per_subspace"), ("sqeuclidean", "per_cluster"),
           ("inner_product", "per_cluster")]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(17)
    centers = rng.uniform(-5, 5, (N_LISTS, DIM)).astype(np.float32)
    x = (centers[rng.integers(0, N_LISTS, N)] + rng.standard_normal((N, DIM))).astype(np.float32)
    q = (centers[rng.integers(0, N_LISTS, NQ)] + rng.standard_normal((NQ, DIM))).astype(np.float32)
    keep = rng.random(N) < 0.6
    return x, q, keep


def _carry(jidx, metric, kind):
    arrays = {f: np.asarray(getattr(jidx, f)) for f in tpq.INDEX_FIELDS}
    return tpq.index_from_arrays(arrays, tpq.IndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM,
                                                         metric=metric, codebook_kind=kind),
                                 device="cpu")


@pytest.fixture(scope="module")
def indexes(data):
    """{(metric, codebook_kind): (JAX index, the port's copy of it)},
    built on first use."""
    x, _, _ = data
    cache = {}

    def get(metric, kind):
        if (metric, kind) not in cache:
            jidx = jpq.build(jpq.IndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM, kmeans_n_iters=5,
                                             metric=metric, codebook_kind=kind), x)
            cache[(metric, kind)] = (jidx, _carry(jidx, metric, kind))
        return cache[(metric, kind)]

    return get


def _near_tie_parity(tv, ti, jv, ji, rtol):
    """Values within rtol of the row's scale; where the ids differ, JAX's
    value there is within that tolerance of another of its values in the
    row, or the position is the row's last (a near-tie at the edge)."""
    scale = np.maximum(np.nanmax(np.where(np.isfinite(jv), np.abs(jv), np.nan), axis=1,
                                 keepdims=True), 1.0)
    tol = rtol * scale
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    assert (np.abs(np.where(fin, tv - jv, 0.0)) <= tol).all()
    for r, c in zip(*np.nonzero(ti != ji)):
        others = np.delete(jv[r], c)
        tied = c == jv.shape[1] - 1 or (np.abs(others - jv[r, c]) <= tol[r, 0]).any()
        assert tied, f"row {r} slot {c}: ids {ti[r, c]} / {ji[r, c]} differ away from a near-tie"


def _tie_group_parity(tv, ti, jv, ji):
    """Values equal bit for bit; per row, every group of equal values but
    the last holds the same set of ids."""
    np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))
    for r in range(tv.shape[0]):
        for v in np.unique(jv[r]):
            if v == jv[r, -1]:
                continue
            m = jv[r] == v
            assert set(ti[r, m].tolist()) == set(ji[r, m].tolist()), (r, v)


@pytest.mark.parametrize("filtered", [False, True], ids=["all", "filtered"])
@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("metric,kind", INDEXES)
def test_modes_match_jax(data, indexes, metric, kind, mode, filtered):
    _, q, keep = data
    jidx, tidx = indexes(metric, kind)
    pf = keep if filtered else None
    jv, ji = jpq.search(jpq.SearchParams(n_probes=N_PROBES, **MODES[mode]), jidx, q, SHORTLIST,
                        prefilter=pf)
    tv, ti = tpq.search(tpq.SearchParams(n_probes=N_PROBES, **MODES[mode]), tidx,
                        torch.tensor(q), SHORTLIST, prefilter=pf)
    assert tv.dtype == torch.float32 and ti.dtype == torch.int32
    assert ti.shape == (NQ, SHORTLIST)
    jv, ji, tv, ti = np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()
    if filtered:
        assert keep[ti[ti >= 0]].all()
    if mode == "approx_bf16":
        _tie_group_parity(tv, ti, jv, ji)
    elif mode == "exact_bf16":
        np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))
        np.testing.assert_array_equal(ti, ji)
    else:
        _near_tie_parity(tv, ti, jv, ji, TOL.get(mode, 1e-5))


def _jax_resolve(params, nq, n_probes, n_lists):
    return jpq._resolve_score_mode(params, nq, n_probes, n_lists)


def test_resolve_score_mode_matches_jax(monkeypatch):
    monkeypatch.setattr(jtuned, "get", lambda key, default=None: default)
    for mode in ("auto", "lut", "recon8", "recon8_list"):
        for dtype in ("bf16", "int8"):
            for trim in ("auto", "approx", "exact", "pallas", "fused"):
                jp = jpq.SearchParams(score_mode=mode, score_dtype=dtype, trim_engine=trim)
                tp = tpq.SearchParams(score_mode=mode, score_dtype=dtype, trim_engine=trim)
                for nq in (1, 16, 128, 4096):
                    for n_probes in (1, 8, 20, 64):
                        for n_lists in (16, 1024, 4096):
                            assert (tpq._resolve_score_mode(tp, nq, n_probes, n_lists)
                                    == _jax_resolve(jp, nq, n_probes, n_lists))
    # the two sides of the duplication rule at the main path's geometry
    assert tpq._resolve_score_mode(tpq.SearchParams(), 4096, 8, 1024) == "recon8_list"
    assert tpq._resolve_score_mode(tpq.SearchParams(), 128, 20, 1024) == "lut"


def test_search_params_defaults_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(jpq.SearchParams)}
    tf = {f.name: f.default for f in dataclasses.fields(tpq.SearchParams)}
    assert tf == jf
    assert tpq.resolve_search(tpq.SearchParams(), 4096, 8, 1024) == ("recon8_list", "approx",
                                                                      "float32")


@pytest.mark.parametrize("nq", [8, NQ])
def test_default_search_is_the_jax_default_search(data, indexes, nq):
    """nq 8: 8 * 4 / 16 < 4 resolves to "lut"; nq 48 to "recon8_list"
    with the approx trim on f32 scores."""
    _, q, _ = data
    jidx, tidx = indexes("sqeuclidean", "per_subspace")
    mode = tpq.resolve_search(tpq.SearchParams(n_probes=N_PROBES), nq, N_PROBES, N_LISTS)[0]
    assert mode == ("lut" if nq == 8 else "recon8_list")
    jv, ji = jpq.search(jpq.SearchParams(n_probes=N_PROBES), jidx, q[:nq], SHORTLIST)
    tv, ti = tpq.search(tpq.SearchParams(n_probes=N_PROBES), tidx, torch.tensor(q[:nq]),
                        SHORTLIST)
    _near_tie_parity(tv.numpy(), ti.numpy(), np.asarray(jv), np.asarray(ji), 1e-5)


@pytest.mark.parametrize("kind", ["per_subspace", "per_cluster"])
def test_query_blocks_give_equal_answers(data, indexes, kind):
    """The lut and recon8 engines block their queries by memory; the
    select is exact, so every block size gives the same answer."""
    _, q, _ = data
    _, tidx = indexes("sqeuclidean", kind)
    tpq.build_reconstruction(tidx)
    qt = torch.tensor(q)
    per_cluster = kind == "per_cluster"

    def lut(qb):
        return tpq._search_impl(qt, tidx.rotation, tidx.centers, tidx.pq_centers, tidx.codes,
                                tidx.slot_rows, SHORTLIST, N_PROBES, tidx.metric, per_cluster,
                                query_block=qb)

    def recon8(qb):
        return tpq._search_impl_recon8(qt, tidx.rotation, tidx.centers, tidx.recon8,
                                       tidx.recon_scale, tidx.recon_norm, tidx.slot_rows_pad,
                                       SHORTLIST, N_PROBES, tidx.metric, query_block=qb)

    for engine in (lut, recon8):
        v0, r0 = engine(None)
        for qb in (1, 5, NQ):
            v, r = engine(qb)
            assert torch.equal(v, v0) and torch.equal(r, r0), (engine.__name__, qb)


def test_per_cluster_decode_quantize_matches_jax(indexes):
    jidx, _ = indexes("sqeuclidean", "per_cluster")
    assert jidx.pq_centers.shape == (N_LISTS, 256, DIM // PQ_DIM)
    j8, js, jn = (np.asarray(a) for a in jpq._decode_quantize(jidx.codes, jidx.pq_centers, True))
    t8, ts, tn = tpq._decode_quantize(torch.tensor(np.asarray(jidx.codes)),
                                      torch.tensor(np.asarray(jidx.pq_centers)), True)
    np.testing.assert_array_equal(t8.numpy(), j8)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_allclose(tn.numpy(), jn, rtol=1e-6)


def test_per_cluster_label_and_encode_matches_jax(data, indexes):
    x, _, _ = data
    jidx, _ = indexes("sqeuclidean", "per_cluster")
    jl, jc = (np.asarray(a) for a in jpq.label_and_encode(
        x, jidx.rotation, jidx.centers, jidx.pq_centers, jidx.metric, True))
    tl, tc = tpq.label_and_encode(torch.tensor(x), *(torch.tensor(np.asarray(a)) for a in (
        jidx.rotation, jidx.centers, jidx.pq_centers)), tpq.DistanceType.L2Expanded, True)
    np.testing.assert_array_equal(tl.numpy(), jl)
    assert (tc.numpy() == jc).all(axis=1).mean() >= 0.999
    assert tc.dtype == torch.uint8


@pytest.mark.parametrize("trim,dtype", [("fused", "bf16"), ("fused", "int8"), ("pallas", "bf16")])
def test_per_cluster_kernel_trims_match_jax(data, indexes, trim, dtype):
    """The fused and pallas trims over a store decoded from per-cluster
    codebooks (the JAX kernels in interpret mode)."""
    _, q, _ = data
    jidx, tidx = indexes("sqeuclidean", "per_cluster")
    sp = dict(n_probes=N_PROBES, score_mode="recon8_list", trim_engine=trim, score_dtype=dtype)
    jv, ji = (np.asarray(a) for a in jpq.search(jpq.SearchParams(**sp), jidx, q, SHORTLIST))
    tv, ti = (a.numpy() for a in tpq.search(tpq.SearchParams(**sp), tidx, torch.tensor(q),
                                            SHORTLIST))
    same = ti == ji
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(tv[same], jv[same], rtol=1e-4, atol=1e-4)


def _recall(ids, truth):
    return float(np.mean([len(set(ids[i]) & set(truth[i])) / K for i in range(len(truth))]))


def test_per_cluster_build_recall_within_three_points_of_jax(data):
    x, q, _ = data
    truth = np.asarray(jbf.knn(x, q, K)[1])
    params = dict(n_lists=N_LISTS, pq_dim=PQ_DIM, kmeans_n_iters=5, codebook_kind="per_cluster")
    jidx = jpq.build(jpq.IndexParams(**params), x)
    tidx = tpq.build(tpq.IndexParams(**params), x, device="cpu")
    assert tidx.pq_centers.shape == (N_LISTS, 256, DIM // PQ_DIM)
    assert tidx.size == N and int(tidx.list_sizes.sum()) == N
    _, jc = jpq.search(jpq.SearchParams(n_probes=N_PROBES), jidx, q, SHORTLIST)
    _, ji = jax_refine(x, q, jc, K)
    _, tc = tpq.search(tpq.SearchParams(n_probes=N_PROBES), tidx, torch.tensor(q), SHORTLIST)
    _, ti = torch_refine(torch.tensor(x), torch.tensor(q), tc, K, device="cpu")
    r_jax, r_port = _recall(np.asarray(ji), truth), _recall(ti.numpy(), truth)
    assert r_port >= r_jax - 0.03, (r_port, r_jax)


def test_bad_requests_raise(data, indexes):
    _, q, _ = data
    _, tidx = indexes("sqeuclidean", "per_subspace")
    qt = torch.tensor(q)
    bad = [(dict(internal_distance_dtype="float64"), "internal_distance_dtype"),
           (dict(lut_dtype="int8"), "lut_dtype"),
           (dict(score_mode="lut", trim_engine="exact"), "requires score_mode"),
           (dict(score_mode="recon8", trim_engine="fused"), "requires score_mode"),
           (dict(score_mode="recon8", score_dtype="int8"), "score_dtype='int8'"),
           (dict(score_mode="nope"), "unknown score_mode")]
    for params, match in bad:
        with pytest.raises(ValueError, match=match):
            tpq.search(tpq.SearchParams(**params), tidx, qt, K)
    # adaptive probing is ported: a malformed target raises as in JAX
    with pytest.raises(ValueError):
        tpq.search(tpq.SearchParams(recall_target="high"), tidx, qt, K)
