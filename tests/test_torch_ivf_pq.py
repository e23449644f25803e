"""PyTorch port: the IVF-PQ slice against the JAX package.

The slice: build -> search(score_mode="recon8_list") for a 4k shortlist
-> refine(strategy="fused") to k, through four engines: trim_engine
"fused" or "pallas" (the bin fold), each on bf16 or int8 query rows. The
JAX kernels run in interpret mode; the port runs its plain versions on
the CPU.

- `_decode_quantize` from identical codes and codebooks: the int8 store
  and the scales are equal; the decoded norms agree to rtol 1e-6 (sums
  in another order).
- `label_and_encode` from identical rotation, centers and codebooks:
  labels and codes agree on at least 99.9% of rows (the rest near-ties).
- Slice parity, for each engine: a JAX-built index carried across with
  `index_from_arrays`; the final ids agree in at least 99% of slots and
  the values to rtol 1e-4 where they agree (bf16 store scoring with sums
  in another order can swap near-tie candidates at the shortlist edge).
- The two int8 trims score the same f32 values: with lists of at most
  512 slots the bin fold loses nothing, so their shortlists are equal.
- The port's own build reaches recall@10 within 0.03 of the JAX build's
  on the same data (the builds draw from different generators), and so
  does a build past 1024 lists (the hierarchical coarse trainer).

The other score modes, trims and per-cluster codebooks are held in
tests/test_torch_ivf_pq_modes.py.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import refine as jax_refine
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import probe_invert
from raft_tpu_torch.neighbors.refine import refine as torch_refine
from raft_tpu_torch.ops import fused_scan
from raft_tpu_torch.ops.pq_list_scan import lane_padded

N, DIM, NQ, K = 4000, 32, 64, 10
N_LISTS, PQ_DIM, N_PROBES = 16, 16, 4


def _blobs(rng, n, centers):
    return (centers[rng.integers(0, len(centers), n)]
            + rng.standard_normal((n, centers.shape[1]))).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    centers = rng.uniform(-5, 5, (N_LISTS, DIM)).astype(np.float32)
    x, q = _blobs(rng, N, centers), _blobs(rng, NQ, centers)
    truth = np.asarray(jbf.knn(x, q, K)[1])
    return x, q, truth


@pytest.fixture(scope="module")
def jax_index(data):
    x, _, _ = data
    return jpq.build(jpq.IndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM, kmeans_n_iters=5), x)


def _arrays(jindex):
    return {f: np.asarray(getattr(jindex, f)) for f in tpq.INDEX_FIELDS}


def _port_index(jindex):
    return tpq.index_from_arrays(_arrays(jindex), tpq.IndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM),
                                 device="cpu")


def _recall(ids, truth):
    return float(np.mean([len(set(ids[i]) & set(truth[i])) / K for i in range(len(truth))]))


def _jax_slice(jindex, x, q, trim="fused", dtype="bf16"):
    sp = jpq.SearchParams(n_probes=N_PROBES, score_mode="recon8_list", trim_engine=trim,
                          score_dtype=dtype)
    _, cand = jpq.search(sp, jindex, q, 4 * K)
    v, i = jax_refine(x, q, cand, K, strategy="fused")
    return np.asarray(v), np.asarray(i), np.asarray(cand)


def _port_slice(tindex, x, q, trim="fused", dtype="bf16"):
    sp = tpq.SearchParams(n_probes=N_PROBES, trim_engine=trim, score_dtype=dtype)
    _, cand = tpq.search(sp, tindex, torch.tensor(q), 4 * K)
    v, i = torch_refine(torch.tensor(x), torch.tensor(q), cand, K, strategy="fused",
                        device="cpu")
    return v.numpy(), i.numpy(), cand.numpy()


def test_decode_quantize_matches_jax(jax_index):
    j8, js, jn = (np.asarray(a) for a in jpq._decode_quantize(
        jax_index.codes, jax_index.pq_centers, False))
    t8, ts, tn = tpq._decode_quantize(torch.tensor(np.asarray(jax_index.codes)),
                                      torch.tensor(np.asarray(jax_index.pq_centers)))
    np.testing.assert_array_equal(t8.numpy(), j8)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_allclose(tn.numpy(), jn, rtol=1e-6)


def test_label_and_encode_matches_jax(data, jax_index):
    x, _, _ = data
    jl, jc = (np.asarray(a) for a in jpq.label_and_encode(
        x, jax_index.rotation, jax_index.centers, jax_index.pq_centers,
        jax_index.metric, False))
    tl, tc = tpq.label_and_encode(torch.tensor(x), *(torch.tensor(np.asarray(a)) for a in (
        jax_index.rotation, jax_index.centers, jax_index.pq_centers)), tpq.DistanceType.L2Expanded)
    assert (tl.numpy() == jl).mean() >= 0.999
    assert (tc.numpy() == jc).all(axis=1).mean() >= 0.999
    assert tc.dtype == torch.uint8


def test_reconstruction_store_pads_to_lanes(jax_index):
    t = tpq.build_reconstruction(_port_index(jax_index))
    max_list = int(jax_index.codes.shape[1])
    lpad = lane_padded(max_list)
    assert t.recon8.shape == (N_LISTS, lpad, DIM) and t.recon8.dtype == torch.int8
    assert torch.all(t.slot_rows_pad[:, max_list:] == -1)
    assert torch.all(torch.isinf(t.recon_norm[:, max_list:]))
    tpq.build_reconstruction(t)  # idempotent
    assert t.recon8.shape[1] == lpad


def test_slice_parity_on_a_carried_index(data, jax_index):
    x, q, truth = data
    jv, ji, jcand = _jax_slice(jax_index, x, q)
    tv, ti, tcand = _port_slice(_port_index(jax_index), x, q)
    assert ti.shape == (NQ, K) and ti.dtype == np.int32
    shortlist = np.mean([len(set(tcand[r]) & set(jcand[r])) / (4 * K) for r in range(NQ)])
    assert shortlist >= 0.99, shortlist
    same = ti == ji
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(tv[same], jv[same], rtol=1e-4)
    assert abs(_recall(ti, truth) - _recall(ji, truth)) <= 0.01


ENGINES = [("fused", "int8"), ("pallas", "bf16"), ("pallas", "int8")]


@pytest.mark.parametrize("trim,dtype", ENGINES)
def test_slice_parity_other_engines(data, jax_index, trim, dtype):
    x, q, truth = data
    jv, ji, jcand = _jax_slice(jax_index, x, q, trim, dtype)
    tv, ti, tcand = _port_slice(_port_index(jax_index), x, q, trim, dtype)
    assert ti.shape == (NQ, K) and ti.dtype == np.int32
    shortlist = np.mean([len(set(tcand[r]) & set(jcand[r])) / (4 * K) for r in range(NQ)])
    assert shortlist >= 0.99, shortlist
    same = ti == ji
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(tv[same], jv[same], rtol=1e-4)
    assert abs(_recall(ti, truth) - _recall(ji, truth)) <= 0.01


def test_int8_trims_score_the_same_values(data):
    """Both int8 trims quantize through one `_quantize_query_rows` and
    score through one rounding, so with lists of at most 512 slots (the
    bin fold keeps every slot) their shortlists are the same values and
    ids."""
    x, _, _ = data
    tindex = tpq.build(tpq.IndexParams(n_lists=2 * N_LISTS, pq_dim=PQ_DIM, kmeans_n_iters=5), x,
                       device="cpu")
    assert lane_padded(int(tindex.codes.shape[1])) <= 512
    q = torch.tensor(np.random.default_rng(11).standard_normal((40, DIM)).astype(np.float32))
    out = [tpq.search(tpq.SearchParams(n_probes=N_PROBES, trim_engine=t, score_dtype="int8"),
                      tindex, q, 4 * K) for t in ("fused", "pallas")]
    (vf, i_f), (vp, i_p) = out
    assert torch.equal(vf, vp)
    for r in range(q.shape[0]):
        assert set(i_f[r].tolist()) == set(i_p[r].tolist())


def test_pallas_trim_caps_k_before_building_the_store(jax_index):
    tindex = _port_index(jax_index)
    for dtype in ("bf16", "int8"):
        with pytest.raises(ValueError, match="256"):
            tpq.search(tpq.SearchParams(trim_engine="pallas", score_dtype=dtype), tindex,
                       torch.zeros((2, DIM)), 257)
    with pytest.raises(ValueError, match="256"):
        tpq.search(tpq.SearchParams(trim_engine="fused", score_dtype="int8"), tindex,
                   torch.zeros((2, DIM)), 257)
    assert tindex.recon8 is None and tindex.fused_kb is None


@pytest.mark.parametrize("mode", ["lut", "recon8"])
def test_int8_rows_need_the_list_major_mode(jax_index, mode):
    with pytest.raises(ValueError, match="score_dtype='int8'"):
        tpq.search(tpq.SearchParams(score_mode=mode, score_dtype="int8"), _port_index(jax_index),
                   torch.zeros((2, DIM)), 5)
    with pytest.raises(ValueError, match="score_dtype"):
        tpq.search(tpq.SearchParams(score_dtype="fp8"), _port_index(jax_index),
                   torch.zeros((2, DIM)), 5)
    with pytest.raises(ValueError, match="trim_engine"):
        tpq.search(tpq.SearchParams(trim_engine="warpsort"), _port_index(jax_index),
                   torch.zeros((2, DIM)), 5)


def test_port_build_recall_within_three_points_of_jax(data, jax_index):
    x, q, truth = data
    _, ji, _ = _jax_slice(jax_index, x, q)
    tindex = tpq.build(tpq.IndexParams(n_lists=N_LISTS, pq_dim=PQ_DIM, kmeans_n_iters=5), x,
                       device="cpu")
    assert tindex.size == N and int(tindex.list_sizes.sum()) == N
    _, ti, _ = _port_slice(tindex, x, q)
    r_jax, r_port = _recall(ji, truth), _recall(ti, truth)
    assert r_port >= r_jax - 0.03, (r_port, r_jax)


def test_macro_batched_pad_rows_never_change_real_rows(data, jax_index):
    """Pad rows are zero queries appended to the batch; they probe lists
    and take chunk slots, but the real rows' results must not move,
    whether the batch is padded, split into several macro-batches, or
    both."""
    _, q, _ = data
    tindex = tpq.build_reconstruction(_port_index(jax_index))

    def slice_fn(sl):
        return tpq._search_impl_recon8_listmajor_fused(
            sl, tindex.rotation, tindex.centers, tindex.recon8, tindex.recon_scale,
            tindex.recon_norm, tindex.slot_rows_pad, 4 * K, N_PROBES, tindex.metric)

    qt = torch.tensor(q)
    v1, r1 = probe_invert.macro_batched(slice_fn, qt, 4 * K)
    for mb, n_pad in ((4096, 192), (24, 0), (24, 8), (40, 24)):
        q_pad = torch.cat([qt, qt.new_zeros((n_pad, DIM))])
        v2, r2 = probe_invert.macro_batched(slice_fn, q_pad, 4 * K, mb=mb)
        assert r2.shape[0] == NQ + n_pad
        assert torch.equal(r1, r2[:NQ]) and torch.equal(v1, v2[:NQ]), (mb, n_pad)
    sp = tpq.SearchParams(n_probes=N_PROBES, score_mode="recon8_list", trim_engine="fused")
    _, r3 = tpq.search(sp, tindex, qt, 4 * K)
    assert torch.equal(r3, torch.where(r1 >= 0, tindex.source_ids[r1.clamp_min(0).long()], -1))
    _, r4 = tpq.search(sp, tindex, torch.cat([qt, qt.new_zeros((40, DIM))]), 4 * K)
    assert torch.equal(r3, r4[:NQ])


def test_quantize_query_rows_matches_jax(rng):
    u = rng.standard_normal((3, 5, 16)).astype(np.float32)
    j8, js = (np.asarray(a) for a in jpq._quantize_query_rows(jnp.asarray(u)))
    t8, ts = tpq._quantize_query_rows(torch.tensor(u))
    np.testing.assert_array_equal(t8.numpy(), j8)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-7)


def test_chunk_tables_match_jax():
    from raft_tpu.neighbors.probe_invert import invert_probes_sort as jax_invert

    rng = np.random.default_rng(3)
    probes = np.stack([rng.choice(12, 5, replace=False) for _ in range(70)]).astype(np.int32)
    jt = jax_invert(jnp.asarray(probes), 12, 8)
    tt = probe_invert.invert_probes_sort(torch.tensor(probes), 12, 8)
    for name in ("lof", "qid_tbl", "g0", "s0"):
        np.testing.assert_array_equal(getattr(tt, name).numpy(), np.asarray(getattr(jt, name)))
    assert tt.lof.shape[0] == probe_invert.chunk_count(70, 5, 12, 8)
    from raft_tpu.neighbors.probe_invert import chunk_validity as jax_validity

    valid = probe_invert.chunk_validity(tt.qid_tbl, 70)
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jax_validity(jt.qid_tbl, 70)))
    rows = probe_invert.chunk_live_rows(tt.qid_tbl, 70)
    assert torch.equal(rows > 0, valid > 0)
    prefix = torch.arange(8)[None, :] < rows[:, None]  # live pairs lead each chunk
    assert torch.equal(prefix, tt.qid_tbl != 70)


def test_kernel_wrappers_check_dtype_and_contiguity():
    """A bad operand raises ValueError in the wrapper; it never takes a
    quiet path to some other computation."""
    lof = torch.zeros((2,), dtype=torch.int32)
    q = torch.zeros((2, 4, 8))
    store = torch.zeros((1, 128, 8))
    base = torch.zeros((1, 1, 128))
    bad = [
        (lof.long(), q, store, base),                           # lof dtype
        (lof, q.double(), store, base),                         # qres dtype
        (lof, q, store.to(torch.int16), base),                  # store dtype
        (lof, q.transpose(1, 2).contiguous().transpose(1, 2), store, base),  # strided
        (lof, q, store, torch.zeros((1, 1, 64))),               # base shape
        (lof, q, torch.zeros((1, 100, 8)), torch.zeros((1, 1, 100))),  # L % 128
        (lof, q, torch.zeros(1 + 128 * 8)[1:].view(1, 128, 8), base),  # misaligned view
    ]
    for args in bad:
        with pytest.raises(ValueError):
            fused_scan.fused_list_topk(*args, 4)
    x = torch.zeros((8, 4))
    with pytest.raises(ValueError):
        fused_scan.fused_topk(x.T, x.T, 2)  # non-contiguous
    with pytest.raises(ValueError):
        fused_scan.fused_topk(x.half(), x, 2)
    with pytest.raises(ValueError):
        fused_scan.fused_list_topk(lof, q, store, base, 200, kbuf=128)


@pytest.mark.parametrize("change", [{"adaptive": True, "recall_target": "high"}])
def test_search_paths_outside_the_slice_raise(jax_index, change):
    # adaptive probing is in the slice now; a malformed request raises
    # ValueError, as the JAX search does
    with pytest.raises(ValueError):
        jpq.search(jpq.SearchParams(**change), jax_index, np.zeros((2, DIM), np.float32), 5)
    with pytest.raises(ValueError):
        tpq.search(tpq.SearchParams(**change), _port_index(jax_index),
                   torch.zeros((2, DIM)), 5)


def _narrow_blobs(seed, n, nq, dim=8, n_blobs=64):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-5, 5, (n_blobs, dim)).astype(np.float32)
    x = (centers[rng.integers(0, n_blobs, n)] + rng.standard_normal((n, dim))).astype(np.float32)
    q = (centers[rng.integers(0, n_blobs, nq)] + rng.standard_normal((nq, dim))).astype(np.float32)
    return x, q


def test_build_past_1024_lists_reaches_the_jax_recall():
    """n_lists 1025 routes the coarse fit through fit_hierarchical (32
    mesoclusters of 33 fine clusters, 31 surplus dropped) in both
    packages; recall@10 of a refined 4k shortlist within 0.03 of JAX's."""
    x, q = _narrow_blobs(31, 10_000, 64)
    truth = np.asarray(jbf.knn(x, q, K)[1])
    params = dict(n_lists=1025, pq_dim=4, kmeans_n_iters=5)
    jindex = jpq.build(jpq.IndexParams(**params), x)
    tindex = tpq.build(tpq.IndexParams(**params), x, device="cpu")
    assert tindex.centers.shape == (1025, 8) and torch.isfinite(tindex.centers).all()
    assert tindex.size == 10_000 and int(tindex.list_sizes.sum()) == 10_000
    _, jc = jpq.search(jpq.SearchParams(n_probes=64), jindex, q, 4 * K)
    _, ji = jax_refine(x, q, jc, K)
    _, tc = tpq.search(tpq.SearchParams(n_probes=64), tindex, torch.tensor(q), 4 * K)
    _, ti = torch_refine(torch.tensor(x), torch.tensor(q), tc, K, device="cpu")
    r_jax, r_port = _recall(np.asarray(ji), truth), _recall(ti.numpy(), truth)
    assert r_port >= r_jax - 0.03, (r_port, r_jax)
