"""PyTorch port: the obs hooks of the ported modules against the JAX
package's, with obs enabled on both.

The same calls run on a JAX index and the port's copy of it (IVF-Flat,
1200 x 32 blob rows, 8 lists, carried across with `index_from_arrays`):
delete, upsert, compact, a rot and the scrub that finds it, an adaptive
search (`budget_tau`, the "query" engine: both packages charge the
lists it scanned), `refine_host`, and a `Mutator` whose log restores to
a point in time. After each, the counters, the histograms (counts for
the span timings, whole aggregates for the rest) and the events' kinds
and fields equal the JAX package's; times are dropped. With obs
disabled, `probe_budget.account` returns None and the hooks move
nothing.
"""

import importlib

import numpy as np
import pytest
import torch

from raft_tpu import integrity as jint
from raft_tpu import obs as jobs
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import mutation as jm
from raft_tpu.neighbors import probe_budget as jpb
from raft_tpu_torch import integrity as tint
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import mutation as tm
from raft_tpu_torch.neighbors import probe_budget as tpb

# the packages' `neighbors.refine` is the function: the modules by path
jrefine = importlib.import_module("raft_tpu.neighbors.refine")
trefine = importlib.import_module("raft_tpu_torch.neighbors.refine")

N, DIM, N_LISTS, NQ = 1200, 32, 8, 24
CENTERS = np.random.default_rng(21).uniform(-5, 5, (N_LISTS, DIM)).astype(np.float32)


@pytest.fixture
def both(pair):
    """Obs on for both packages, after the index pair is built."""
    for m in (tobs, jobs):
        m.flight.uninstall()
        m.reset()
        m.enable()
    yield
    for m in (tobs, jobs):
        m.reset()
        m.disable()
        m.flight.uninstall()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(22)
    x = (CENTERS[rng.integers(0, N_LISTS, N)]
         + rng.standard_normal((N, DIM))).astype(np.float32)
    q = (x[rng.choice(N, NQ, replace=False)]
         + 0.1 * rng.standard_normal((NQ, DIM))).astype(np.float32)
    return x, q


@pytest.fixture
def pair(data):
    """(JAX index, the port's copy), fresh for each test."""
    x, _ = data
    jidx = jfl.build(jfl.IndexParams(n_lists=N_LISTS, kmeans_n_iters=3), x)
    arrays = {f: np.asarray(getattr(jidx, f)) for f in tfl.INDEX_FIELDS}
    arrays["list_radii"] = np.asarray(jidx.list_radii)
    tidx = tfl.index_from_arrays(arrays, tfl.IndexParams(n_lists=N_LISTS), device="cpu")
    tint.attach(tidx, "ivf_flat")  # the JAX build attached its sidecar
    return jidx, tidx


def _state():
    out = []
    for m in (tobs, jobs):
        snap = m.registry().snapshot()
        hists = {}
        for name, agg in snap["histograms"].items():
            if agg["count"]:
                hists[name] = agg["count"] if name.startswith("span.") else agg
        events = [{k: v for k, v in e.items() if k not in ("t", "dur_s")}
                  for e in m.bus().events()]
        out.append(({n: v for n, v in snap["counters"].items() if v}, hists, events))
    return out


def _assert_equal_state():
    t, j = _state()
    assert t[0] == j[0], "counters"
    assert t[1] == j[1], "histograms"
    assert [e["kind"] for e in t[2]] == [e["kind"] for e in j[2]]
    assert t[2] == j[2], "events"
    return t


def test_delete_upsert_compact(both, pair, data):
    jidx, tidx = pair
    x, _ = data
    rng = np.random.default_rng(3)
    victims = rng.choice(N, 100, replace=False).astype(np.int32)
    up_ids = victims[:20]
    up_vecs = x[up_ids] + 0.01
    new_vecs = x[:7] + 0.5
    j = jm.delete(jidx, victims)
    t = tm.delete(tidx, torch.from_numpy(victims))
    j = jm.upsert(j, up_vecs, up_ids)
    t = tm.upsert(t, torch.from_numpy(up_vecs), torch.from_numpy(up_ids))
    j = jm.upsert(j, new_vecs)
    t = tm.upsert(t, torch.from_numpy(new_vecs))
    j = jm.compact(j)
    t = tm.compact(t)
    counters, _, events = _assert_equal_state()
    assert counters["mutation.tombstones"] == 100 + 0  # the upserted ids were dead already
    assert counters["mutation.upserts"] == 27 and counters["mutation.rebalances"] == 1
    ops = [e["op"] for e in events if e["kind"] == "mutation"]
    assert ops == ["delete", "upsert", "upsert", "rebalance"]


def test_scrub_of_rot(both, pair):
    jidx, tidx = pair
    jint.rot_list(jidx, 3, "list_data", frac=0.2, seed=1)
    tint.rot_list(tidx, 3, "list_data", frac=0.2, seed=1)
    jbad = jint.Scrubber(budget_lists=3).full_scan(jidx)
    tbad = tint.Scrubber(budget_lists=3).full_scan(tidx)
    assert tbad == jbad == [("list_data", 3)]
    counters, _, _ = _assert_equal_state()
    assert counters["integrity.mismatches"] == 1 and counters["integrity.rot_injected"] == 1
    assert counters["integrity.lists_scanned"] == N_LISTS
    jq = jint.quarantine(jidx, 3)
    tq = tint.quarantine(tidx, 3)
    assert int(tq.n_tombstones) == int(jq.n_tombstones)
    _assert_equal_state()


def test_adaptive_search_and_refine_host(both, pair, data):
    jidx, tidx = pair
    x, q = data
    params = dict(n_probes=6, engine="query", budget_tau=0.3)
    jv, ji = jfl.search(jfl.SearchParams(**params), jidx, q, 10)
    tv, ti = tfl.search(tfl.SearchParams(**params), tidx, torch.from_numpy(q), 10)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    cand = np.array(ji)
    jrefine.refine_host(x, q, cand, 5)
    trefine.refine_host(x, torch.from_numpy(q), torch.from_numpy(cand), 5, device="cpu")
    counters, hists, events = _assert_equal_state()
    assert counters["ivf.scanned_lists"] < counters["ivf.scanned_lists_worst_case"] == NQ * 6
    assert hists["ivf.budget_hist"]["count"] == NQ
    kinds = [(e["kind"], e.get("name")) for e in events]
    assert kinds == [("probe_budget", None), ("span", "neighbors.ivf_flat.search"),
                     ("span", "neighbors.refine")]
    assert counters["perf.neighbors.refine.flops.f32"] > 0


def test_adaptive_ivf_pq_search_charges_as_jax(both, data):
    """An adaptive IVF-PQ search at nq 24 (the default resolves to the
    query-major "lut" engine on both) lands the same scanned lists,
    budget histogram, span and charged cost; so does an explicit fused
    trim, which JAX and the port both charge at the probed lists."""
    from raft_tpu.neighbors import ivf_pq as jpq
    from raft_tpu_torch.neighbors import ivf_pq as tpq

    x, q = data
    for m in (tobs, jobs):
        m.disable()
    jidx = jpq.build(jpq.IndexParams(n_lists=N_LISTS, pq_dim=8, kmeans_n_iters=3,
                                     kmeans_trainset_fraction=1.0), x)
    arrays = {f: np.asarray(getattr(jidx, f)) for f in tpq.INDEX_FIELDS}
    arrays["list_radii"] = np.asarray(jidx.list_radii)
    tidx = tpq.index_from_arrays(arrays, tpq.IndexParams(n_lists=N_LISTS, pq_dim=8),
                                 device="cpu")
    for m in (tobs, jobs):
        m.reset()
        m.enable()
    for kw in (dict(n_probes=6, budget_tau=0.3),
               dict(n_probes=6, score_mode="recon8_list", trim_engine="fused")):
        jpq.search(jpq.SearchParams(**kw), jidx, q, 10)
        tpq.search(tpq.SearchParams(**kw), tidx, torch.from_numpy(q), 10)
    counters, hists, events = _assert_equal_state()
    assert hists["span.neighbors.ivf_pq.search"] == 2
    assert counters["perf.neighbors.ivf_pq.search.flops.bf16"] > 0


def test_mutator_commit_and_restore(both, pair, data, tmp_path):
    jidx, tidx = pair
    x, _ = data
    rng = np.random.default_rng(5)
    jmut = jm.Mutator(str(tmp_path / "j"), jidx, ckpt_every=2, retain=4, slack=8)
    tmut = tm.Mutator(str(tmp_path / "t"), tidx, ckpt_every=2, retain=4, slack=8)
    for step in range(4):
        ids = rng.choice(N, 10, replace=False).astype(np.int32)
        if step % 2:
            jmut.delete(ids)
            tmut.delete(torch.from_numpy(ids))
        else:
            jmut.upsert(x[ids] + 0.1, ids)
            tmut.upsert(torch.from_numpy(x[ids] + 0.1), torch.from_numpy(ids))
    jmut.commit()
    tmut.commit()
    jr, _ = jint.restore(str(tmp_path / "j"), 3)
    tr, _ = tint.restore(str(tmp_path / "t"), 3, device="cpu")
    assert int(tr.mut_cursor) == int(jr.mut_cursor) == 3
    counters, _, events = _assert_equal_state()
    assert counters["integrity.restores"] == 1
    commits = [e["cursor"] for e in events if e["kind"] == "mutation" and e["op"] == "commit"]
    assert commits == [2, 4]


def test_disabled_hooks_move_nothing(pair):
    for m in (tobs, jobs):
        m.disable()
        m.reset()
    _, tidx = pair
    scanned = torch.tensor([3, 4, 5])
    assert tpb.account("ivf_flat", scanned, 3, 6) is None
    assert jpb.account("ivf_flat", np.array([3, 4, 5]), 3, 6) is None
    tm.delete(tidx, torch.arange(10, dtype=torch.int32))
    tfl.search(tfl.SearchParams(n_probes=4, budget_tau=0.3), tidx, torch.zeros((2, DIM)), 3)
    assert tobs.bus().events() == []
    assert not any(tobs.registry().snapshot()["counters"].values())
