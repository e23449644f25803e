"""PyTorch port: adaptive probing (`raft_tpu_torch.neighbors.probe_budget`)
and the list radii of the three IVF indexes, against the JAX package's
`raft_tpu.neighbors.probe_budget`, on the same seeded numpy inputs.

- `resolve_tau` on targets below, between, at and above the banked ones,
  on None, and on malformed policies (skipped entries, a non-list); the
  tuned policy read for CUDA only; `resolve_params` over the adaptive
  fields;
- `assign_budgets`, `early_term_keep` and `probe_plan` (with and without
  rotation, bounds, inner product): masks and counts equal to JAX's. A
  budget may differ only where a gap-profile value lies within 1e-6 of
  tau; the test counts those rows (none at these inputs);
- radii within f32 tolerance (rtol 1e-5) of JAX's after build and after
  extend, for IVF-Flat (from the store, and by extend), IVF-PQ (by
  extend) and IVF-RaBitQ (from `aux`: bit for bit on one aux table);
- adaptive search on each family on one index carried across: the
  search's plan equal to JAX's, recall@10 within 0.01 of JAX's search,
  and `recall_target=1.0` bit for bit the port's fixed search on every
  engine (fused ones through their plain kernel versions);
- masked searches (budget_tau 0.3, with and without the bounds) on every
  engine against the JAX search of the same name, with the same params,
  on one index carried across with its radii, on data where the masks
  change the answer (overlapping blobs; the fixtures check that they
  do), held as that engine's
  fixed search is held: IVF-PQ's f32-score engines (lut, recon8, the
  approx and exact trims) values within rtol 1e-5 of the row's scale and
  ids equal but at near-ties; its fused and pallas trims (JAX in
  interpret mode) through refine, shortlists and ids equal in 99% of
  slots, values to rtol 1e-4 where the ids agree; IVF-Flat's query and
  list engines values within 1e-5 and ids equal but at float64 near-ties,
  its fused engine as IVF-PQ's fused trim; IVF-RaBitQ's xla and fused
  engines on the exact-rotation grid index of test_torch_ivf_rabitq.py,
  with rerank, bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import tuned as jtuned
from raft_tpu.distance.distance_types import DistanceType as JD
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import ivf_rabitq as jrb
from raft_tpu.neighbors import probe_budget as jpb
from raft_tpu.neighbors import refine as jax_refine
from raft_tpu_torch.core import tuned
from raft_tpu_torch.distance.distance_types import DistanceType as TD
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import ivf_rabitq as trb
from raft_tpu_torch.neighbors import probe_budget as tpb
from raft_tpu_torch.neighbors.refine import refine as torch_refine

N, DIM, NQ, N_LISTS, N_PROBES, K = 3000, 32, 80, 16, 8, 10


def _blobs(seed, n, nq, dim=DIM, n_blobs=12):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-4, 4, (n_blobs, dim)).astype(np.float32)
    x = (centers[rng.integers(0, n_blobs, n)] + rng.standard_normal((n, dim))).astype(np.float32)
    q = (centers[rng.integers(0, n_blobs, nq)] + rng.standard_normal((nq, dim))).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def data():
    x, q = _blobs(0, N, NQ)
    d2 = (q.astype(np.float64) ** 2).sum(1)[:, None] + (x.astype(np.float64) ** 2).sum(1)[None]
    d2 -= 2.0 * q.astype(np.float64) @ x.astype(np.float64).T
    truth = np.argsort(d2, axis=1, kind="stable")[:, :K]
    return x, q, truth


def _recall(ids, truth):
    ids = np.asarray(ids)
    return float(np.mean([len(set(ids[i]) & set(truth[i])) / K for i in range(len(truth))]))


# ---------------------------------------------------------------------------
# resolution
# ---------------------------------------------------------------------------

POLICIES = [
    None,
    {"default_tau": 0.3, "targets": [[0.8, 0.2], [0.9, 0.4], [0.97, 0.7]]},
    {"default_tau": "x", "targets": [[0.9, 0.5], ["bad"], [0.95], None, [0.99, 1.5]]},
    {"default_tau": 0.5, "targets": "not a list"},
    {"targets": [[0.95, -0.2]]},
]


@pytest.mark.parametrize("policy", range(len(POLICIES)))
def test_resolve_tau_and_params_match_jax(monkeypatch, policy):
    table = {} if POLICIES[policy] is None else {"adaptive_probe_policy": POLICIES[policy]}
    monkeypatch.setattr(jtuned, "_load", lambda: dict(table))
    monkeypatch.setattr(tuned, "_load", lambda: dict(table))
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    targets = (None, 0.5, 0.8, 0.85, 0.9, 0.93, 0.95, 0.97, 0.99, 0.995, 1.0, 1.2)
    for rt in targets:
        assert tpb.resolve_tau(rt, cuda) == jpb.resolve_tau(rt)
        # the table governs CUDA only: the CPU reads DEFAULT_POLICY
        monkeypatch.setattr(jtuned, "_load", lambda: {})
        assert tpb.resolve_tau(rt, cpu) == jpb.resolve_tau(rt)
        monkeypatch.setattr(jtuned, "_load", lambda: dict(table))
    assert tpb.DEFAULT_POLICY == jpb.DEFAULT_POLICY
    for kw in ({}, {"adaptive": True}, {"recall_target": 0.9}, {"recall_target": 1.0},
               {"budget_tau": 1.0}, {"budget_tau": 0.3, "early_term": False},
               {"adaptive": True, "min_probes": 0}, {"adaptive": True, "min_probes": 99},
               {"recall_target": 0.95, "min_probes": 3, "early_term": False}):
        want = jpb.resolve_params(jpq.SearchParams(n_probes=N_PROBES, **kw), N_PROBES)
        got = tpb.resolve_params(tpq.SearchParams(n_probes=N_PROBES, **kw), N_PROBES, cuda)
        assert (got is None) == (want is None)
        if want is not None:
            assert (got.tau, got.min_probes, got.early_term) == (
                want.tau, want.min_probes, want.early_term)
    with pytest.raises(ValueError):
        jpb.resolve_tau("high")
    with pytest.raises(ValueError):
        tpb.resolve_tau("high", cuda)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _near_tau_rows(cvals, select_min, tau):
    """Rows whose gap profile holds a value within 1e-6 of tau."""
    v = cvals.astype(np.float32)
    v0, vl = v[:, :1], v[:, -1:]
    g = (v - v0) / (vl - v0 + np.float32(1e-12)) if select_min else \
        (v0 - v) / (v0 - vl + np.float32(1e-12))
    return np.abs(g - np.float32(tau)).min(axis=1) <= 1e-6


def test_assign_budgets_and_early_term_match_jax():
    rng = np.random.default_rng(1)
    cvals = np.sort(rng.gamma(2.0, 3.0, (200, 24)).astype(np.float32), axis=1)
    cvals[:5] = cvals[:5, :1]  # flat rows: v_last == v_0
    near_total = 0
    for select_min in (True, False):
        c = cvals if select_min else -cvals
        for tau in (0.0, 0.1, 0.3, 0.5, 0.9, 1.0):
            for mp in (1, 3, 24):
                want = np.asarray(jpb.assign_budgets(c, select_min, tau, mp))
                got = tpb.assign_budgets(torch.tensor(c), select_min, tau, mp).numpy()
                diff = want != got
                near = _near_tau_rows(c, select_min, tau)
                assert not (diff & ~near).any(), (select_min, tau, mp)
                near_total += int(diff.sum())
    assert near_total == 0  # counted: no near-tau exception at these inputs
    radii = rng.uniform(0.5, 3.0, (200, 24)).astype(np.float32)
    sizes = rng.integers(0, 8, (200, 24)).astype(np.int32)
    base = rng.random((200, 24)) < 0.8
    base[:, 0] = True
    for k in (1, 10, 40, 10_000):
        want = np.asarray(jpb.early_term_keep(cvals, radii, sizes, k, base))
        got = tpb.early_term_keep(torch.tensor(cvals), torch.tensor(radii), torch.tensor(sizes),
                                  k, torch.tensor(base)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("metric,rotated,bounds", [
    ("sqeuclidean", False, False), ("sqeuclidean", False, True),
    ("sqeuclidean", True, True), ("inner_product", True, True),
    ("inner_product", False, False)])
def test_probe_plan_matches_jax(metric, rotated, bounds):
    rng = np.random.default_rng(2)
    q = rng.standard_normal((120, 24)).astype(np.float32)
    centers = (rng.standard_normal((40, 24)) * 2).astype(np.float32)
    rot = np.linalg.qr(rng.standard_normal((24, 24)))[0].astype(np.float32) if rotated else None
    radii = rng.uniform(0.5, 4.0, 40).astype(np.float32) if bounds else None
    sizes = rng.integers(0, 30, 40).astype(np.int32) if bounds else None
    jm = JD.InnerProduct if metric == "inner_product" else JD.L2Expanded
    tm = TD.InnerProduct if metric == "inner_product" else TD.L2Expanded
    for tau, mp, k in ((0.2, 1, 10), (0.5, 2, 40), (1.0, 1, 10), (0.05, 4, 200)):
        jk, jc = jpb.probe_plan(q, centers, n_probes=12, min_probes=mp, k=k, metric=jm, tau=tau,
                                rotation=rot, radii=radii, sizes=sizes)
        tk, tc = tpb.probe_plan(torch.tensor(q), torch.tensor(centers), n_probes=12,
                                min_probes=mp, k=k, metric=tm, tau=tau,
                                rotation=None if rot is None else torch.tensor(rot),
                                radii=None if radii is None else torch.tensor(radii),
                                sizes=None if sizes is None else torch.tensor(sizes))
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
        assert tc.dtype == torch.int32
        if tau >= 1.0 and not bounds:
            assert tk.all()


def test_search_plan_skips_only_the_plans_that_keep_every_probe():
    rng = np.random.default_rng(5)
    q = torch.tensor(rng.standard_normal((30, 16)).astype(np.float32))
    centers = torch.tensor((rng.standard_normal((20, 16)) * 2).astype(np.float32))
    rot = torch.tensor(np.linalg.qr(rng.standard_normal((16, 16)))[0].astype(np.float32))
    radii = torch.tensor(rng.uniform(0.5, 3.0, 20).astype(np.float32))
    sizes = torch.tensor(rng.integers(1, 30, 20).astype(np.int32))
    kw = dict(n_probes=8, k=10, metric=TD.L2Expanded, radii=radii, sizes=sizes)
    res = tpb.AdaptiveResolved
    assert tpb.search_plan(None, q, centers, **kw) is None
    # saturated without the bounds (off, no radii, inner product): the fixed search
    assert tpb.search_plan(res(1.0, 1, False), q, centers, **kw) is None
    assert tpb.search_plan(res(1.0, 1, True), q, centers, **{**kw, "radii": None}) is None
    assert tpb.search_plan(res(1.0, 1, True), q, centers,
                           **{**kw, "metric": TD.InnerProduct}) is None
    # and the plan itself keeps every probe there
    keep, _ = tpb.probe_plan(q, centers, n_probes=8, min_probes=1, k=10, metric=TD.L2Expanded,
                             tau=1.0)
    assert keep.all()
    # otherwise probe_plan's mask, over the probes of the engines' coarse select
    for rotation in (None, rot):
        for ap in (res(1.0, 1, True), res(0.3, 1, False), res(0.3, 2, True)):
            want, _ = tpb.probe_plan(q, centers, n_probes=8, min_probes=ap.min_probes, k=10,
                                     metric=TD.L2Expanded, tau=ap.tau, rotation=rotation,
                                     radii=radii if ap.early_term else None, sizes=sizes)
            keep, probes = tpb.search_plan(ap, q, centers, rotation=rotation, **kw)
            assert torch.equal(keep, want)
            if rotation is None:
                assert torch.equal(probes, tfl._probes(q, centers, 8, TD.L2Expanded))
            else:
                assert torch.equal(probes, tpq._coarse_select(q, rotation, centers, 8,
                                                              TD.L2Expanded)[1])


def test_account_is_the_mean_of_scanned_lists():
    """With obs enabled `account` returns the mean of the scanned lists
    (and lands them in the registry); disabled it returns None and reads
    nothing, as the JAX function does."""
    from raft_tpu_torch import obs

    counts = torch.tensor([3, 5, 8, 0], dtype=torch.int32)
    assert tpb.account("ivf_pq", counts, 4, 8) is None
    obs.reset()
    obs.enable()
    try:
        assert tpb.account("ivf_pq", counts, 4, 8) == 4.0
        assert tpb.account("ivf_pq", counts[:0], 0, 8) == 0.0
        assert obs.registry().snapshot()["counters"]["ivf.scanned_lists"] == 16
    finally:
        obs.disable()
        obs.reset()


# ---------------------------------------------------------------------------
# radii and adaptive search on each family
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def flat(data):
    x, _, _ = data
    jidx = jfl.build(jfl.IndexParams(n_lists=N_LISTS, kmeans_n_iters=5), x[:2000])
    tidx = tfl.index_from_arrays({f: np.asarray(getattr(jidx, f)) for f in tfl.INDEX_FIELDS},
                                 tfl.IndexParams(n_lists=N_LISTS), device="cpu")
    return jfl.extend(jidx, x[2000:]), tfl.extend(tidx, x[2000:]), jidx, tidx


@pytest.fixture(scope="module")
def pq(data):
    x, _, _ = data
    params = dict(n_lists=N_LISTS, pq_dim=16, kmeans_n_iters=5, add_data_on_build=False)
    jidx = jpq.build(jpq.IndexParams(**params), x)
    arrays = {f: np.asarray(getattr(jidx, f)) for f in tpq.INDEX_FIELDS}
    arrays["list_radii"] = np.asarray(jidx.list_radii)
    tidx = tpq.index_from_arrays(arrays, tpq.IndexParams(**params), device="cpu")
    j1, t1 = jpq.extend(jidx, x[:2000]), tpq.extend(tidx, torch.tensor(x[:2000]))
    return jpq.extend(j1, x[2000:]), tpq.extend(t1, torch.tensor(x[2000:])), j1, t1


@pytest.fixture(scope="module")
def rabitq(data):
    x, _, _ = data
    jidx = jrb.build(jrb.IndexParams(n_lists=N_LISTS, kmeans_n_iters=5), x[:2000])
    arrays = {f: np.asarray(getattr(jidx, f)) for f in trb.INDEX_FIELDS}
    arrays["dataset"] = x[:2000]
    tidx = trb.index_from_arrays(arrays, trb.IndexParams(n_lists=N_LISTS), device="cpu")
    return jrb.extend(jidx, x[2000:]), trb.extend(tidx, torch.tensor(x[2000:])), jidx, tidx


def _radii_close(t, j):
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-5, atol=1e-6)


def test_radii_after_build_and_extend(flat, pq, rabitq):
    jf, tf, jf0, tf0 = flat
    _radii_close(tf0.list_radii, jf0.list_radii)     # the port: from the store
    _radii_close(tf.list_radii, jf.list_radii)       # then by extend
    np.testing.assert_allclose(
        tpb.list_radii_from_store(tf.list_data, tf.slot_rows, tf.centers).numpy(),
        np.asarray(jpb.list_radii_from_store(jf.list_data, jf.slot_rows, jf.centers)),
        rtol=1e-5, atol=1e-6)
    jp, tp, jp0, tp0 = pq
    _radii_close(tp0.list_radii, jp0.list_radii)
    _radii_close(tp.list_radii, jp.list_radii)
    jr, tr_, jr0, tr0 = rabitq
    np.testing.assert_array_equal(tr0.list_radii.numpy(), np.asarray(jr0.list_radii))
    _radii_close(tr_.list_radii, jr.list_radii)      # |r| of the port's own encode
    np.testing.assert_array_equal(                   # the same aux: bit for bit
        tpb.list_radii_from_aux(torch.tensor(np.asarray(jr.aux)),
                                torch.tensor(np.asarray(jr.slot_rows))).numpy(),
        np.asarray(jpb.list_radii_from_aux(jr.aux, jr.slot_rows)))
    # empty index: zero radii; an index without radii stays without
    assert tpb.updated_radii(None, np.array([0]), np.array([1.0]), 4) is None
    up = tpb.updated_radii(torch.zeros(4), np.array([1, 1, 3]), np.array([2.0, 5.0, 1.0]), 4)
    np.testing.assert_array_equal(up.numpy(), np.array([0, 5, 0, 1], np.float32))


def _plans_equal(jidx, tidx, q, k, rotated, **kw):
    rot = dict(rotation=np.asarray(jidx.rotation)) if rotated else {}
    jk, _ = jpb.probe_plan(q, jidx.centers, n_probes=N_PROBES, k=k, metric=jidx.metric,
                           radii=jidx.list_radii, sizes=jidx.list_sizes, **rot, **kw)
    tk, _ = tpb.probe_plan(torch.tensor(q), tidx.centers, n_probes=N_PROBES, k=k,
                           metric=tidx.metric, radii=tidx.list_radii, sizes=tidx.list_sizes,
                           rotation=tidx.rotation if rotated else None, **kw)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))


ADAPTIVE = ({"recall_target": 0.9}, {"budget_tau": 0.3}, {"budget_tau": 0.3, "early_term": False})


def test_adaptive_ivf_flat(data, flat):
    x, q, truth = data
    jidx, tidx = flat[0], flat[1]
    qt = torch.tensor(q)
    _plans_equal(jidx, tidx, q, K, False, min_probes=1, tau=0.3)
    for kw in ADAPTIVE:
        jv, ji = jfl.search(jfl.SearchParams(n_probes=N_PROBES, **kw), jidx, q, K)
        tv, ti = tfl.search(tfl.SearchParams(n_probes=N_PROBES, **kw), tidx, qt, K)
        assert abs(_recall(ti, truth) - _recall(ji, truth)) <= 0.01, kw
    for engine in ("query", "list", "fused"):
        fixed = tfl.search(tfl.SearchParams(n_probes=N_PROBES, engine=engine), tidx, qt, K)
        sat = tfl.search(tfl.SearchParams(n_probes=N_PROBES, engine=engine, recall_target=1.0),
                         tidx, qt, K)
        assert torch.equal(fixed[0], sat[0]) and torch.equal(fixed[1], sat[1]), engine
        ad = tfl.search(tfl.SearchParams(n_probes=N_PROBES, engine=engine, budget_tau=0.3),
                        tidx, qt, K)
        assert _recall(ad[1], truth) >= _recall(fixed[1], truth) - 0.05, engine


def test_adaptive_ivf_pq(data, pq):
    x, q, truth = data
    jidx, tidx = pq[0], pq[1]
    qt = torch.tensor(q)
    _plans_equal(jidx, tidx, q, 4 * K, True, min_probes=1, tau=0.3)
    for kw in ADAPTIVE:
        sp = dict(n_probes=N_PROBES, score_mode="recon8_list", trim_engine="exact", **kw)
        _, ji = jpq.search(jpq.SearchParams(**sp), jidx, q, K)
        _, ti = tpq.search(tpq.SearchParams(**sp), tidx, qt, K)
        assert abs(_recall(ti, truth) - _recall(ji, truth)) <= 0.01, kw
    for mode, trim in (("lut", "auto"), ("recon8", "auto"), ("recon8_list", "approx"),
                       ("recon8_list", "fused"), ("recon8_list", "pallas")):
        sp = dict(n_probes=N_PROBES, score_mode=mode, trim_engine=trim)
        fixed = tpq.search(tpq.SearchParams(**sp), tidx, qt, K)
        sat = tpq.search(tpq.SearchParams(recall_target=1.0, **sp), tidx, qt, K)
        assert torch.equal(fixed[0], sat[0]) and torch.equal(fixed[1], sat[1]), (mode, trim)
        ad = tpq.search(tpq.SearchParams(budget_tau=0.3, **sp), tidx, qt, K)
        assert ad[1].shape == (NQ, K) and torch.isfinite(ad[0]).all(), (mode, trim)


def test_adaptive_ivf_rabitq(data, rabitq):
    x, q, truth = data
    jidx, tidx = rabitq[0], rabitq[1]
    qt = torch.tensor(q)
    kk = trb.rerank_depth(K, 4)
    _plans_equal(jidx, tidx, q, kk, True, min_probes=1, tau=0.3)
    for kw in ADAPTIVE:
        sp = dict(n_probes=N_PROBES, scan_engine="xla", rerank_mult=4, **kw)
        _, ji = jrb.search(jrb.SearchParams(**sp), jidx, q, K)
        _, ti = trb.search(trb.SearchParams(**sp), tidx, qt, K)
        assert abs(_recall(ti, truth) - _recall(ji, truth)) <= 0.01, kw
    for engine in ("xla", "fused"):
        sp = dict(n_probes=N_PROBES, scan_engine=engine, rerank_mult=4)
        fixed = trb.search(trb.SearchParams(**sp), tidx, qt, K)
        sat = trb.search(trb.SearchParams(recall_target=1.0, **sp), tidx, qt, K)
        assert torch.equal(fixed[0], sat[0]) and torch.equal(fixed[1], sat[1]), engine


def test_prefilter_turns_the_bounds_off(data, flat):
    """Under a prefilter the plan keeps budgets only (the sizes count
    filtered members): the search equals one whose index has no radii."""
    x, q, _ = data
    tidx = flat[1]
    keep = np.random.default_rng(4).random(N) < 0.5
    sp = tfl.SearchParams(n_probes=N_PROBES, budget_tau=0.3, engine="list")
    a = tfl.search(sp, tidx, torch.tensor(q), K, prefilter=keep)
    radii, tidx.list_radii = tidx.list_radii, None
    try:
        b = tfl.search(sp, tidx, torch.tensor(q), K, prefilter=keep)
    finally:
        tidx.list_radii = radii
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


# ---------------------------------------------------------------------------
# masked searches, engine by engine, against the JAX search
# ---------------------------------------------------------------------------

#: budgets with the radius bounds, and budgets alone
MASKED = {"bounds": {"budget_tau": 0.3}, "budgets": {"budget_tau": 0.3, "early_term": False}}


def _carried(jidx, module, params):
    """The port's copy of a JAX index, its radii included."""
    arrays = {f: np.asarray(getattr(jidx, f)) for f in module.INDEX_FIELDS}
    arrays["list_radii"] = np.asarray(jidx.list_radii)
    return module.index_from_arrays(arrays, params, device="cpu")


def _masked_plan_equal(jidx, tidx, q, k, rotated, kw):
    bounds = kw.get("early_term", True)
    rot = dict(rotation=np.asarray(jidx.rotation)) if rotated else {}
    jk, _ = jpb.probe_plan(q, jidx.centers, n_probes=N_PROBES, min_probes=1, k=k,
                           metric=jidx.metric, tau=kw["budget_tau"],
                           radii=jidx.list_radii if bounds else None, sizes=jidx.list_sizes,
                           **rot)
    tk, _ = tpb.probe_plan(torch.tensor(q), tidx.centers, n_probes=N_PROBES, min_probes=1, k=k,
                           metric=tidx.metric, tau=kw["budget_tau"],
                           radii=tidx.list_radii if bounds else None, sizes=tidx.list_sizes,
                           rotation=tidx.rotation if rotated else None)
    np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
    assert not np.asarray(jk).all()  # the mask has holes
    return np.asarray(jk)


def _near_tie_parity(tv, ti, jv, ji, rtol):
    """Values within rtol of the row's scale (non-finite ones equal);
    where the ids differ, JAX's value there is within that tolerance of
    another of its values in the row, or the position is the row's last."""
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    scale = np.maximum(np.where(fin, np.abs(jv), 0.0).max(axis=1, keepdims=True), 1.0)
    tol = rtol * scale
    assert (np.abs(np.where(fin, tv - jv, 0.0)) <= tol).all()
    for r, c in zip(*np.nonzero(ti != ji)):
        others = np.delete(jv[r], c)
        tied = c == jv.shape[1] - 1 or (np.abs(others - jv[r, c]) <= tol[r, 0]).any()
        assert tied, f"row {r} slot {c}: ids {ti[r, c]} / {ji[r, c]} differ away from a near-tie"


def _kernel_parity(tv, ti, jv, ji):
    """As the fixed searches of the kernel engines are held: ids equal in
    99% of slots, values to rtol 1e-4 where they agree."""
    same = ti == ji
    assert same.mean() >= 0.99, same.mean()
    np.testing.assert_allclose(tv[same], jv[same], rtol=1e-4, atol=1e-4)


PQ_ENGINES = {
    "lut": dict(score_mode="lut"),
    "recon8": dict(score_mode="recon8"),
    "approx": dict(score_mode="recon8_list", trim_engine="approx"),
    "exact": dict(score_mode="recon8_list", trim_engine="exact"),
    "approx_int8": dict(score_mode="recon8_list", trim_engine="approx", score_dtype="int8"),
    "fused": dict(score_mode="recon8_list", trim_engine="fused"),
    "fused_int8": dict(score_mode="recon8_list", trim_engine="fused", score_dtype="int8"),
    "pallas": dict(score_mode="recon8_list", trim_engine="pallas"),
    "pallas_int8": dict(score_mode="recon8_list", trim_engine="pallas", score_dtype="int8"),
}


@pytest.fixture(scope="module")
def overlap():
    """Heavily overlapping blobs (32 centres in U(-2, 2)^32, unit noise,
    the queries from the same blobs), where a masked list holds true
    neighbours: on well-separated blobs the budgets cut only lists that
    hold none, and a search that ignored its mask would pass unseen.
    (x, q, the JAX IVF-PQ index and its copy, the JAX IVF-Flat index and
    its copy)."""
    rng = np.random.default_rng(0)
    c = rng.uniform(-2, 2, (32, DIM)).astype(np.float32)
    x = (c[rng.integers(0, 32, N)] + rng.standard_normal((N, DIM))).astype(np.float32)
    q = (c[rng.integers(0, 32, NQ)] + rng.standard_normal((NQ, DIM))).astype(np.float32)
    jp = jpq.build(jpq.IndexParams(n_lists=N_LISTS, pq_dim=16, kmeans_n_iters=5), x)
    jf = jfl.build(jfl.IndexParams(n_lists=N_LISTS, kmeans_n_iters=5), x)
    # the masks change the answer (JAX's own searches)
    for kw in MASKED.values():
        fixed = np.asarray(jfl.search(jfl.SearchParams(n_probes=N_PROBES, engine="list"),
                                      jf, q, K)[1])
        masked = np.asarray(jfl.search(jfl.SearchParams(n_probes=N_PROBES, engine="list", **kw),
                                       jf, q, K)[1])
        assert (fixed != masked).any(axis=1).sum() >= 5, kw
    return (x, q, jp, _carried(jp, tpq, tpq.IndexParams(n_lists=N_LISTS, pq_dim=16)),
            jf, _carried(jf, tfl, tfl.IndexParams(n_lists=N_LISTS)))


@pytest.mark.parametrize("mask", list(MASKED))
@pytest.mark.parametrize("engine", list(PQ_ENGINES))
def test_masked_ivf_pq_matches_jax(overlap, engine, mask):
    x, q, jidx, tidx = overlap[:4]
    kw = {**PQ_ENGINES[engine], **MASKED[mask]}
    _masked_plan_equal(jidx, tidx, q, 4 * K, True, MASKED[mask])
    jv, ji = jpq.search(jpq.SearchParams(n_probes=N_PROBES, **kw), jidx, q, 4 * K)
    tv, ti = tpq.search(tpq.SearchParams(n_probes=N_PROBES, **kw), tidx, torch.tensor(q), 4 * K)
    assert ti.shape == (NQ, 4 * K) and ti.dtype == torch.int32
    jv, ji, tv, ti = np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()
    if engine.startswith(("fused", "pallas")):
        overlap = np.mean([len(set(ti[r]) & set(ji[r])) / len(set(ji[r])) for r in range(NQ)])
        assert overlap >= 0.99, overlap
        jrv, jri = jax_refine(x, q, jnp.asarray(ji), K, strategy="fused")
        trv, tri = torch_refine(torch.tensor(x), torch.tensor(q), torch.tensor(ti), K,
                                strategy="fused", device="cpu")
        _kernel_parity(trv.numpy(), tri.numpy(), np.asarray(jrv), np.asarray(jri))
    else:
        _near_tie_parity(tv, ti, jv, ji, 1e-5)


@pytest.mark.parametrize("mask", list(MASKED))
@pytest.mark.parametrize("engine", ["query", "list", "pallas"])
def test_masked_ivf_flat_matches_jax(overlap, engine, mask):
    x, q, _, _, jidx, tidx = overlap
    kw = dict(engine=engine, **MASKED[mask])
    _masked_plan_equal(jidx, tidx, q, K, False, MASKED[mask])
    jv, ji = jfl.search(jfl.SearchParams(n_probes=N_PROBES, **kw), jidx, q, K)
    tv, ti = tfl.search(tfl.SearchParams(n_probes=N_PROBES, **kw), tidx, torch.tensor(q), K)
    assert ti.shape == (NQ, K) and ti.dtype == torch.int32
    jv, ji, tv, ti = np.asarray(jv), np.asarray(ji), tv.numpy(), ti.numpy()
    if engine == "pallas":
        _kernel_parity(tv, ti, jv, ji)
        return
    np.testing.assert_allclose(tv, jv, rtol=1e-5, atol=1e-5)
    diff = ti != ji
    if diff.any():  # float64 distances of the differing ids within 1e-5 of each other
        def f64(ids):
            d = ((x[np.maximum(ids, 0)].astype(np.float64) - q[:, None, :]) ** 2).sum(-1)
            return np.where(ids >= 0, d, np.nan)

        dt, dj = f64(ti), f64(ji)
        scale = np.maximum(np.nanmax(np.abs(dj), axis=1, keepdims=True), 1.0)
        assert (np.abs(dt - dj)[diff] <= 1e-5 * np.broadcast_to(scale, dt.shape)[diff]).all()


@pytest.fixture(scope="module")
def rabitq_grid():
    """{metric: (x, q, JAX index, the port's copy)}: grid rows and a
    signed-permutation rotation, as test_torch_ivf_rabitq.py builds them,
    so that the two packages' coarse products and estimators agree bit
    for bit."""
    rng = np.random.default_rng(3)
    x = rng.integers(-8, 8, (3000, 32)).astype(np.float32)
    q = rng.integers(-8, 8, (16, 32)).astype(np.float32)
    prng = np.random.default_rng(11)
    perm = np.zeros((32, 32), np.float32)
    perm[np.arange(32), prng.permutation(32)] = prng.choice([-1.0, 1.0], 32)
    out = {}
    for metric in ("sqeuclidean", "inner_product"):
        jb = jrb.build(jrb.IndexParams(n_lists=N_LISTS, kmeans_n_iters=4, store_dataset=False,
                                       metric=metric, add_data_on_build=False), x)
        cent = (np.asarray(jb.centers) @ np.asarray(jb.rotation) @ perm.T).astype(np.float32)
        jidx = jrb.extend(jrb.Index(jb.params, jnp.asarray(perm), jnp.asarray(cent), jb.codes,
                                    jb.aux, jb.slot_rows, jb.list_sizes, jb.source_ids), x)
        arrays = {f: np.asarray(getattr(jidx, f)) for f in trb.INDEX_FIELDS}
        tidx = trb.index_from_arrays(arrays, trb.IndexParams(n_lists=N_LISTS, metric=metric,
                                                             store_dataset=False), device="cpu")
        fixed = np.asarray(jrb.search(jrb.SearchParams(n_probes=N_PROBES, rerank_mult=4),
                                      jidx, q, K, refine_dataset=x)[1])
        for kw in MASKED.values():  # the masks change the answer
            masked = np.asarray(jrb.search(jrb.SearchParams(n_probes=N_PROBES, rerank_mult=4,
                                                            **kw), jidx, q, K,
                                           refine_dataset=x)[1])
            assert (fixed != masked).any(axis=1).sum() >= 5, kw
        out[metric] = (x, q, jidx, tidx)
    return out


@pytest.mark.parametrize("mask", list(MASKED))
@pytest.mark.parametrize("engine", ["xla", "fused"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_masked_ivf_rabitq_matches_jax(rabitq_grid, metric, engine, mask):
    x, q, jidx, tidx = rabitq_grid[metric]
    kw = dict(scan_engine=engine, rerank_mult=4, **MASKED[mask])
    _masked_plan_equal(jidx, tidx, q, trb.rerank_depth(K, 4), True, MASKED[mask])
    jv, ji = jrb.search(jrb.SearchParams(n_probes=N_PROBES, **kw), jidx, q, K, refine_dataset=x)
    tv, ti = trb.search(trb.SearchParams(n_probes=N_PROBES, **kw), tidx, torch.tensor(q), K,
                        refine_dataset=torch.tensor(x))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.int32), np.asarray(jv).view(np.int32))
