"""PyTorch port: the serving cases of the JAX suites outside
tests/test_serve.py, each run through the port's `serve` and against the
JAX package's run of the same case on the same numpy data.

- Live mutation (tests/test_mutation.py): a `MutationFeed` drains between
  batches — the batch in flight serves the old index bit for bit,
  coverage stays 1.0, no deleted id returns, queries the delete does not
  touch answer bit for bit before and after the swap (queries near data
  rows: the reference drill's gaussian queries far from its blobs share
  neighbours with the first query, so none is untouched there); upsert,
  delete and rebalance through the feed; an MNMG server defers the feed
  while its mask is degraded and applies it once healed.
- Integrity (tests/test_integrity.py): rot on a served index is
  quarantined between batches (degraded coverage, replies bit for bit an
  index without the list), then repaired from the checkpoint (replies
  bit for bit the pre-rot ones).
- Replication (tests/test_replication.py): a degraded mask on a
  replicated index with a poisoned primary answers at coverage 1.0 bit
  for bit the healthy answer, and the heal runs between batches.
- Adaptive probing (tests/test_probe_budget.py): per-request
  `recall_target`, its coalescing and its validation.
- Request tracing and the watchtower (tests/test_trace.py): stage sums
  telescope to the measured latency, terminal outcomes and their
  counters, a broken batcher or a failing dump never kills the worker, a
  corrupt stamp degrades to untraced with bit-identical replies, the
  watchtower breaches and recovers, a disabled obs records nothing.
  Traces, counters and histogram counts equal JAX's for the same run.
- The obs chaos drill (tests/test_obs.py): counters, histogram counts
  and the event sequence equal JAX's, except that the in-process comms
  world reports a dropped contribution once per rank visit where the
  JAX program reports it once at trace time (the drill compares the
  drop events as one); the drill replays identically; a server's
  metrics join the global snapshot.
"""

import gc
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs_obs
from raft_tpu import serve as jserve
from raft_tpu.core import faults as jfaults
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import mutation as jmut
from raft_tpu_torch import obs, serve
from raft_tpu_torch.core import faults
from raft_tpu_torch.neighbors import brute_force, ivf_flat, mutation

import _torch_serve_util as u

SEED = int(os.environ.get(faults.ENV_SEED, "1234"))
SP = dict(n_probes=4, engine="query")
BOTH = ("port", "jax")
PKG = {"port": (serve, faults, obs), "jax": (jserve, jfaults, jobs_obs)}


@pytest.fixture
def obs_on():
    """Both packages' obs enabled and reset; torn down disabled, reset, no
    flight recorder, trace mints at seed 0. Garbage is collected on the
    way in and out: a dropped server's finalizer removes its registry
    section, and run by a collection inside a registry's lock it would
    wait on that lock (the JAX package's registry still takes it there)."""
    gc.collect()
    for m in (obs, jobs_obs):
        m.flight.uninstall()
        m.reset()
        m.trace.reset(seed=0)
        m.enable()
    yield
    gc.collect()
    for m in (obs, jobs_obs):
        m.flight.uninstall()
        m.disable()
        m.reset()


@pytest.fixture(scope="module")
def blobs():
    return u.blobs(512)


@pytest.fixture(scope="module")
def flat(blobs):
    """(JAX IVF-Flat index, its port copy): 512 x 16 blobs, 8 lists."""
    j = u.jax_build("ivf_flat", blobs)
    return j, u.carry("ivf_flat", j)


def _near_queries(blobs, n=16, seed=7):
    rng = np.random.default_rng(seed)
    return (blobs[rng.choice(len(blobs), n, replace=False)]
            + 0.05 * rng.standard_normal((n, blobs.shape[1]))).astype(np.float32)


def _flat_server(idx, pkg, buckets=(16,)):
    sv = PKG[pkg][0]
    sp = (ivf_flat if pkg == "port" else jfl).SearchParams(**SP)
    return sv.SearchServer(idx, sv.ServerConfig(buckets=buckets), search_params=sp)


def _one(server, q, k=10):
    fut = server.submit(q, k=k)
    assert server.step() == 1
    return fut.result(timeout=10.0)


# -- live mutation (tests/test_mutation.py) ------------------------------

def _zero_dip(server, feed_mod, q):
    feed = feed_mod.MutationFeed()
    server.attach_mutations(feed)
    pre = _one(server, q)
    victims = np.unique(pre.ids[0])[:3]
    feed.publish(("delete", victims))
    mid = _one(server, q)
    post = _one(server, q)
    return pre, mid, post, victims


def test_serve_zero_dip_single_chip(blobs, flat):
    q = _near_queries(blobs)
    runs = {}
    for pkg, idx, fm in (("port", flat[1], mutation), ("jax", flat[0], jmut)):
        server = _flat_server(idx, pkg)
        pre, mid, post, victims = _zero_dip(server, fm, q)
        # the batch collected before the drain served the old object
        u.assert_bitwise(mid.values, mid.ids, pre.values, pre.ids)
        assert pre.coverage == mid.coverage == post.coverage == 1.0
        assert server.searcher.index is not idx  # the swap landed after
        assert not np.isin(post.ids, victims).any()
        untouched = ~np.isin(pre.ids, victims).any(axis=1)
        assert untouched.sum() > 0
        u.assert_bitwise(post.values[untouched], post.ids[untouched],
                         pre.values[untouched], pre.ids[untouched])
        assert idx.tombstones is None  # the served object never mutated
        runs[pkg] = (pre, post, victims)
    (tpre, tpost, tv), (jpre, jpost, jv) = runs["port"], runs["jax"]
    scale = u.norm_scale(blobs, q)
    u.assert_tie_equal(tpre.values, tpre.ids, jpre.values, jpre.ids, scale=scale)
    np.testing.assert_array_equal(tv, jv)
    u.assert_tie_equal(tpost.values, tpost.ids, jpost.values, jpost.ids, scale=scale)


def test_serve_upsert_and_rebalance_through_feed(blobs, flat):
    far = (blobs[3] + 40.0).astype(np.float32)
    for pkg, idx, fm in (("port", flat[1], mutation), ("jax", flat[0], jmut)):
        server = _flat_server(idx, pkg)
        feed = fm.MutationFeed()
        server.attach_mutations(feed)
        feed.publish(("upsert", far[None], np.array([3])))
        feed.publish(("delete", np.array([5])))
        feed.publish(("rebalance",))
        reply = server.search(np.zeros((1, 16), np.float32), k=5, timeout=5.0)
        assert reply.coverage == 1.0  # batch 1 served the old index
        reply = server.search(far[None], k=5, timeout=5.0)
        assert reply.ids[0][0] == 3
        live = server.searcher.index
        assert live.tombstones is None  # rebalance applied
        sr = u.as_np(live.slot_rows)
        assert 5 not in u.as_np(live.source_ids)[sr[sr >= 0]]
    with pytest.raises(ValueError, match="unknown"):
        mutation.MutationFeed().publish(("drop_table",))


WORLD = 4


@pytest.fixture(scope="module")
def worlds():
    from raft_tpu.comms import Comms as JComms

    from raft_tpu_torch.comms import Comms

    tc = Comms(n_devices=WORLD, device="cpu", timeout_s=60)
    yield JComms(n_devices=WORLD), tc
    tc.destroy()


def _dist_flat_r2(worlds, blobs):
    """(a replicated JAX distributed IVF-Flat, the port's carried copy
    replicated the same way)."""
    import _torch_mnmg_ivf_util as mu

    from raft_tpu.comms import mnmg as jm

    from raft_tpu_torch.comms import mnmg

    ji = jm.ivf_flat_build(worlds[0], jfl.IndexParams(n_lists=8, kmeans_n_iters=3), blobs)
    ti = mu.carry(worlds[1], ji, "ivf_flat", ivf_flat.IndexParams(n_lists=8))
    jm.replicate_index(ji, 2)
    mnmg.replicate_index(ti, 2)
    return ji, ti


def test_mnmg_serve_defers_mutations_while_degraded(worlds, blobs):
    from raft_tpu.comms.resilience import RankHealth as JRankHealth

    from raft_tpu_torch.comms.resilience import RankHealth

    q = _near_queries(blobs)
    out = {}
    for pkg, index in zip(BOTH, reversed(_dist_flat_r2(worlds, blobs))):
        sv = PKG[pkg][0]
        rh = RankHealth if pkg == "port" else JRankHealth
        fm = mutation if pkg == "port" else jmut
        server = sv.SearchServer(index, sv.ServerConfig(buckets=(16,)),
                                 health=rh.all_healthy(WORLD).mark_unhealthy(1), n_probes=4,
                                 engine="list", auto_heal=False)
        feed = fm.MutationFeed()
        server.attach_mutations(feed)
        pre = _one(server, q)
        assert pre.coverage == 1.0  # replicated failover, not a dip
        victims = np.unique(pre.ids[0])[:3]
        feed.publish(("delete", victims))
        _one(server, q)
        assert server.searcher.index is index  # degraded -> deferred
        pending = feed.drain()
        assert len(pending) == 1  # still queued, not dropped
        feed.publish(pending[0])
        server.set_health(rh.all_healthy(WORLD))
        _one(server, q)
        assert server.searcher.index is not index  # applied once healed
        post = _one(server, q)
        assert post.coverage == 1.0 and not np.isin(post.ids, victims).any()
        untouched = ~np.isin(pre.ids, victims).any(axis=1)
        u.assert_bitwise(post.values[untouched], post.ids[untouched],
                         pre.values[untouched], pre.ids[untouched])
        out[pkg] = (pre, post)
    for a, b in zip(out["port"], out["jax"]):
        u.assert_tie_equal(a.values, a.ids, b.values, b.ids, scale=u.norm_scale(blobs, q))


def _poison_primary(tc, index, rank):
    """Zero `rank`'s primary tables and drop its gids (the port's copy of
    tests/test_replication.py's poisoning)."""
    from raft_tpu_torch.comms import replication

    a = index.list_data.full().clone()
    a[rank] = 0
    index.list_data = tc.shard(a, axis=0)
    g = index.slot_gids.full().clone()
    g[rank] = -1
    index.slot_gids = tc.shard(g, axis=0)
    replication._reset_derived_stores(index)


def test_serve_heals_between_batches(worlds, blobs):
    from raft_tpu.comms import mnmg as jm

    from raft_tpu_torch.comms import mnmg
    from raft_tpu_torch.comms.resilience import RankHealth

    ji, ti = _dist_flat_r2(worlds, blobs)
    q = blobs[:8]
    v0, i0 = mnmg.ivf_flat_search(ti, q, 5, n_probes=8, query_mode="replicated",
                                  engine="list")
    jv0, ji0 = jm.ivf_flat_search(ji, q, 5, n_probes=8, query_mode="replicated",
                                  engine="list")
    u.assert_tie_equal(v0, i0, jv0, ji0, scale=u.norm_scale(blobs, q))
    _poison_primary(worlds[1], ti, 1)
    server = serve.SearchServer(ti, serve.ServerConfig(buckets=(8,), max_wait_ms=0.0),
                                health=RankHealth.all_healthy(WORLD).mark_unhealthy(1),
                                n_probes=8)
    reply = _one(server, q, k=5)
    assert reply.coverage == 1.0  # in-flight traffic never saw a dip
    u.assert_bitwise(reply.values, reply.ids, v0, i0)
    assert server.searcher.health.coverage() == 1.0  # healed between batches
    reply2 = _one(server, q, k=5)
    assert reply2.coverage == 1.0
    u.assert_bitwise(reply2.values, reply2.ids, v0, i0)
    server.stop()


# -- integrity (tests/test_integrity.py) ---------------------------------

def _member_ids(index, lid):
    rows = u.as_np(index.slot_rows)[int(lid)]
    return u.as_np(index.source_ids)[rows[rows >= 0]]


def test_serve_rot_quarantine_repair_zero_dip(tmp_path, blobs, flat):
    from raft_tpu import integrity as jint
    from raft_tpu.integrity import scrub as jscrub

    from raft_tpu_torch import integrity
    from raft_tpu_torch.integrity import scrub

    q = _near_queries(blobs)
    seen = {}
    for pkg in BOTH:
        sv = PKG[pkg][0]
        fm, im, sm = (mutation, integrity, scrub) if pkg == "port" else (jmut, jint, jscrub)
        base = flat[1] if pkg == "port" else flat[0]
        twin = u.carry("ivf_flat", flat[0]) if pkg == "port" else u.jax_build("ivf_flat", blobs)
        mut = fm.Mutator(str(tmp_path / pkg), base, kind="ivf_flat")
        seeded = _member_ids(base, 0)[:1]
        mut.delete(seeded)  # a no-op commit writes nothing to restore from
        mut.commit()
        idx = mut.index
        twin = fm.delete(twin, seeded)
        server = _flat_server(idx, pkg)
        wd = im.IntegrityWatchdog("ivf_flat", budget_lists=3)
        server.attach_integrity(wd)
        pre = server.search(q, k=10, timeout=5.0)
        assert pre.coverage == 1.0
        lid = 4
        victim_ids = _member_ids(idx, lid)
        sm.rot_list(idx, lid, "list_data", frac=1.0, seed=SEED)
        for _ in range(4):
            if wd.quarantined:
                break
            server.search(q[:1], k=10, timeout=5.0)
        assert wd.quarantined == {lid}
        mid = server.search(q, k=10, timeout=5.0)
        assert mid.coverage == pytest.approx(wd.coverage()) and mid.coverage < 1.0
        mod = ivf_flat if pkg == "port" else jfl
        rv, ri = mod.search(mod.SearchParams(**SP), fm.delete(twin, victim_ids), q, 10)
        u.assert_bitwise(mid.values, mid.ids, rv, ri)
        wd.repair = im.checkpoint_repairer(str(tmp_path / pkg))
        server.search(q[:1], k=10, timeout=5.0)  # the tick that repairs
        post = server.search(q, k=10, timeout=5.0)
        assert post.coverage == 1.0 and wd.repairs == 1
        u.assert_bitwise(post.values, post.ids, pre.values, pre.ids)
        seen[pkg] = (pre, mid, wd.coverage())
    for a, b in zip(seen["port"][:2], seen["jax"][:2]):
        u.assert_tie_equal(a.values, a.ids, b.values, b.ids, scale=u.norm_scale(blobs, q))
    assert seen["port"][1].coverage == seen["jax"][1].coverage


# -- adaptive probing (tests/test_probe_budget.py) -----------------------

@pytest.fixture(scope="module")
def clustered():
    rng = np.random.default_rng(SEED)
    cent = rng.normal(size=(16, 32)) * 8
    return (cent[rng.integers(0, 16, 4000)] + rng.normal(size=(4000, 32))).astype(np.float32)


@pytest.fixture(scope="module")
def flat16(clustered):
    j = jfl.build(jfl.IndexParams(n_lists=16, kmeans_n_iters=6), clustered)
    arrays = {f: np.asarray(getattr(j, f)) for f in ivf_flat.INDEX_FIELDS}
    arrays["list_radii"] = np.asarray(j.list_radii)
    return j, ivf_flat.index_from_arrays(arrays, ivf_flat.IndexParams(n_lists=16), device="cpu")


def test_serve_recall_target_end_to_end(flat16, clustered):
    q = clustered[:4]
    got = {}
    for pkg, idx in zip(BOTH, reversed(flat16)):
        sv = PKG[pkg][0]
        mod = ivf_flat if pkg == "port" else jfl
        server = sv.SearchServer(idx, sv.ServerConfig(buckets=(8,)),
                                 search_params=mod.SearchParams(n_probes=8, engine="query"))
        plain = server.submit(q, k=5)
        server.step()
        sat = server.submit(q, k=5, recall_target=1.0)
        server.step()
        tight = server.submit(q, k=5, recall_target=0.9)
        server.step()
        pv, sv_, tv = plain.result(1), sat.result(1), tight.result(1)
        u.assert_bitwise(sv_.values, sv_.ids, pv.values, pv.ids)
        assert tv.ids.shape == (4, 5)
        a = server.submit(q, k=5, recall_target=0.9)
        b = server.submit(q, k=5, recall_target=0.95)
        assert server.step() == 1  # only the first target's batch
        server.step()
        assert a.done() and b.done()
        got[pkg] = (pv, tv)
    for a, b in zip(got["port"], got["jax"]):
        u.assert_tie_equal(a.values, a.ids, b.values, b.ids, scale=u.norm_scale(clustered, q))


def test_serve_probe_key_folds_budget(flat16):
    keys = []
    for pkg, idx in zip(BOTH, reversed(flat16)):
        mod = ivf_flat if pkg == "port" else jfl
        s = PKG[pkg][0].IvfFlatSearcher(idx, mod.SearchParams(n_probes=8, engine="query"))
        keys.append((s.probe_key(1.0), s.probe_key(1.0, recall_target=0.9),
                     s.probe_key(1.0, recall_target=1.0), s.probe_key(0.25)))
    assert keys[0] == keys[1]
    fixed_key, ad_key, sat_key, low = keys[0]
    assert fixed_key != ad_key and low[0] == 2


def test_serve_recall_target_validation(flat16):
    for pkg, idx in zip(BOTH, reversed(flat16)):
        sv = PKG[pkg][0]
        mod = ivf_flat if pkg == "port" else jfl
        server = sv.SearchServer(idx, sv.ServerConfig(buckets=(8,)),
                                 search_params=mod.SearchParams(n_probes=8, engine="query"))
        with pytest.raises(ValueError, match="recall_target"):
            server.submit(np.zeros((1, 32), np.float32), k=3, recall_target=1.5)


# -- request tracing and the watchtower (tests/test_trace.py) ------------

@pytest.fixture(scope="module")
def dataset():
    return np.random.default_rng(0).standard_normal((64, 16)).astype(np.float32)


def _bf_server(pkg, dataset, **cfg):
    sv = PKG[pkg][0]
    kw = {"device": "cpu"} if pkg == "port" else {}
    return sv.SearchServer(dataset, sv.ServerConfig(buckets=(8,), max_wait_ms=0.0, **cfg), **kw)


def _traces(pkg):
    return [{k: v for k, v in e.items() if k not in ("seq", "t", "marks")}
            for e in PKG[pkg][2].snapshot()["events"] if e["kind"] == "trace"]


def _moved(pkg):
    """The counters and histogram counts a run moved."""
    m = PKG[pkg][2].snapshot()["metrics"]
    return ({k: v for k, v in m["counters"].items() if v},
            {k: a["count"] for k, a in m["histograms"].items() if a["count"]})


def test_three_batch_trace_pin_equals_jax(obs_on, dataset):
    rng = np.random.default_rng(1)
    reqs = [rng.standard_normal((2, 16)).astype(np.float32) for _ in range(3)]
    for pkg in BOTH:
        server = _bf_server(pkg, dataset)
        for q in reqs:
            fut = server.submit(q, k=3)
            assert server.step() == 1
            assert fut.result(timeout=1.0).ids.shape == (2, 3)
    tt, jt = _traces("port"), _traces("jax")
    assert tt == jt and len(tt) == 3
    assert [e["trace_id"] for e in tt] == [obs.trace.trace_id(0, n) for n in (1, 2, 3)]
    assert [e["cached"] for e in tt] == [False, True, True]
    assert _moved("port") == _moved("jax")


def test_stage_sum_covers_measured_e2e(obs_on, dataset):
    """Summed per-stage times >= 95% of each request's measured latency
    under an injected 80 ms slow dispatch; the deltas telescope."""
    server = _bf_server("port", dataset)
    plan = faults.FaultPlan(
        [faults.Fault(kind="slow_rank", site="serve.batch", latency_s=0.08)], seed=SEED)
    rng = np.random.default_rng(2)
    t_sub, futs = [], []
    for _ in range(4):
        t_sub.append(time.monotonic())
        futs.append(server.submit(rng.standard_normal((2, 16)).astype(np.float32), k=3))
    with plan.install():
        assert server.step() == 4
    t_done = time.monotonic()
    for fut in futs:
        assert fut.result(timeout=1.0).coverage == 1.0
    events = [e for e in obs.snapshot()["events"] if e["kind"] == "trace"]
    assert len(events) == 4
    for e, t0 in zip(events, t_sub):
        marks = e["marks"]
        stage_sum = sum(marks[b] - marks[a]
                        for (a, b) in zip(obs.trace.STAGES, obs.trace.STAGES[1:]))
        assert stage_sum == pytest.approx(marks["scattered"] - marks["admitted"])
        assert stage_sum >= 0.95 * (t_done - t0), (stage_sum, t_done - t0)


def test_outcome_counters_and_drop_wait(obs_on, dataset):
    for pkg in BOTH:
        sv = PKG[pkg][0]
        server = _bf_server(pkg, dataset)
        ok = server.submit(np.zeros((2, 16), np.float32), k=3)
        dead = server.submit(np.zeros((2, 16), np.float32), k=3, deadline_s=0.0)
        assert server.step() == 2
        assert ok.result(timeout=1.0).coverage == 1.0
        with pytest.raises(sv.DeadlineExceeded):
            dead.result(timeout=0.1)
    counters, hists = _moved("port")
    assert counters["serve.outcome.ok"] == 1 and counters["serve.outcome.expired"] == 1
    assert hists["serve.drop_wait_s"] == 1
    assert (counters, hists) == _moved("jax")
    traces = {e["outcome"]: e for e in _traces("port")}
    assert traces["expired"]["stages"] == ["admitted"]
    assert traces["ok"]["stages"][-1] == "scattered"
    assert _traces("port") == _traces("jax")


def test_rejected_request_closes_its_trace(obs_on, dataset):
    for pkg in BOTH:
        sv = PKG[pkg][0]
        server = _bf_server(pkg, dataset, admission=sv.AdmissionConfig(
            max_pending_rows=2, policy="reject"))
        server.submit(np.zeros((2, 16), np.float32), k=3)
        with pytest.raises(sv.RejectedError):
            server.submit(np.zeros((2, 16), np.float32), k=3)
    assert _moved("port")[0]["serve.outcome.rejected"] == 1
    assert [e["outcome"] for e in _traces("port")] == ["rejected"]
    assert _traces("port") == _traces("jax") and _moved("port") == _moved("jax")


def test_flaky_dump_never_kills_worker_loop(obs_on, dataset, tmp_path):
    """A batcher bug inside the threaded worker triggers a flight dump;
    with the dump failing too (injected), the worker survives both and
    keeps serving."""
    obs.flight.install(dump_dir=str(tmp_path))
    server = _bf_server("port", dataset)
    real_collect = server.batcher.collect
    boom = threading.Event()

    def collect_once_broken(timeout_s=None):
        if not boom.is_set():
            boom.set()
            raise ValueError("injected batcher bug")
        return real_collect(timeout_s=timeout_s)

    server.batcher.collect = collect_once_broken
    plan = faults.FaultPlan(
        [faults.Fault(kind="flaky_bootstrap", site="obs.flight.dump", count=1)], seed=SEED)
    with plan.install():
        server.start()
        try:
            fut = server.submit(np.zeros((2, 16), np.float32), k=3)
            assert fut.result(timeout=5.0).coverage == 1.0  # still serving
        finally:
            server.stop()
    events = obs.snapshot()["events"]
    assert any(e["kind"] == "serve_worker_error" for e in events)
    assert any(e["kind"] == "flight" and e["action"] == "dump_failed" for e in events)


def test_corrupt_stamp_degrades_to_untraced_bit_identical(obs_on, dataset):
    rng = np.random.default_rng(3)
    qs = [rng.standard_normal((2, 16)).astype(np.float32) for _ in range(2)]
    for pkg in BOTH:
        fl = PKG[pkg][1]
        server = _bf_server(pkg, dataset)
        plan = fl.FaultPlan(
            [fl.Fault(kind="flaky_bootstrap", site="serve.trace.stamp", count=1)], seed=SEED)
        with plan.install():
            for q in qs:
                fut = server.submit(q, k=3)
                server.step()
                got = fut.result(timeout=1.0)
                if pkg == "port":
                    want_v, want_i = brute_force.knn(dataset, q, 3, device="cpu")
                    u.assert_bitwise(got.values, got.ids, want_v, want_i)
    traces = _traces("port")
    assert [e["trace_id"] for e in traces] == [obs.trace.trace_id(0, 2)]
    assert traces == _traces("jax")
    faults_ev = [(e["site"], e["action"]) for e in obs.snapshot()["events"]
                 if e["kind"] == "fault"]
    assert faults_ev == [("serve.trace.stamp", "flaky")]


def test_watchtower_attached_to_server(obs_on, dataset):
    states = []
    for pkg in BOTH:
        sv, _, om = PKG[pkg]
        t_fake = [1000.0]
        wt = om.slo.Watchtower(om.slo.serve_objectives(), clock=lambda: t_fake[0])
        server = _bf_server(pkg, dataset)
        server.attach_watchtower(wt)
        futs = [server.submit(np.zeros((2, 16), np.float32), k=3, deadline_s=0.0)
                for _ in range(3)]
        assert server.step() == 3
        for fut in futs:
            with pytest.raises(sv.DeadlineExceeded):
                fut.result(timeout=0.1)
        assert wt.state()["error_rate"]["breached"]
        states.append(wt.state())
        t_fake[0] += 4000.0
        for _ in range(3):
            fut = server.submit(np.zeros((2, 16), np.float32), k=3)
            server.step()
            assert fut.result(timeout=1.0).coverage == 1.0
        assert not wt.state()["error_rate"]["breached"]
        states.append(wt.state())
    assert [s["error_rate"] for s in states[:2]] == [s["error_rate"] for s in states[2:]]
    counters = _moved("port")[0]
    assert counters["slo.breach"] == 1 and counters["slo.recover"] == 1
    assert _moved("port")[0] == _moved("jax")[0]


def test_disabled_serve_is_untraced(dataset):
    obs.reset()
    assert not obs.enabled()
    server = _bf_server("port", dataset)
    fut = server.submit(np.zeros((2, 16), np.float32), k=3)
    server.step()
    assert fut.result(timeout=1.0).coverage == 1.0
    obs.enable()
    try:
        snap = obs.snapshot()
        assert [e for e in snap["events"] if e["kind"] == "trace"] == []
        assert snap["metrics"]["counters"].get("serve.outcome.ok", 0) == 0
        device = snap["metrics"]["histograms"].get("serve.stage.device_s")
        assert device is None or device["count"] == 0
    finally:
        obs.disable()
        obs.reset()


# -- the obs chaos drill and the global snapshot (tests/test_obs.py) ----

def test_server_metrics_joins_global_snapshot(obs_on):
    for pkg in BOTH:
        m = PKG[pkg][0].ServerMetrics(latency_window=8)
        m.observe_submit()
        sections = PKG[pkg][2].snapshot()["metrics"]["collectors"]
        assert any(sec.get("submitted") == 1 for k, sec in sections.items()
                   if k.startswith("serve#"))


def _chaos_drill(pkg):
    """tests/test_obs.py's drill on one package: a healthy and a chaos
    allreduce on 8 ranks, a seeded host corruption, health flips, and a
    warmed two-bucket server answering hit / hit / miss. Returns the
    counters, histogram counts and events (clock fields dropped, the
    per-rank drop events of the port's in-process world as one, apart;
    the counters the drill moved)."""
    import jax.numpy as jnp

    sv, fl, om = PKG[pkg]
    if pkg == "port":
        from raft_tpu_torch.comms.comms import Comms
        from raft_tpu_torch.comms.resilience import RankHealth

        comms = Comms(n_devices=8, device="cpu", timeout_s=60)
        red, kw = (lambda xs: torch.sum(xs, 0)), {"device": "cpu"}
    else:
        from raft_tpu.comms.comms import Comms
        from raft_tpu.comms.resilience import RankHealth

        comms, red, kw = Comms(), (lambda xs: jnp.sum(xs, axis=0)), {}
    om.reset()
    plan = fl.FaultPlan([
        fl.Fault("drop_collective", site="comms.allreduce", rank=3),
        fl.Fault("slow_rank", site="serve.batch", latency_s=0.002),
        fl.Fault("flaky_bootstrap", site="serve.submit", count=1),
        fl.Fault("corrupt_shard", site="batch_loader.load", rank=-1, fraction=0.5),
    ], seed=77)
    x = np.ones((8, 4), np.float32)

    def prog(ac, xs):
        return ac.allreduce(red(xs))

    try:
        comms.run(prog, x, out_specs=None)
        with plan.install():
            comms.run(prog, x, out_specs=None)
            fl.corrupt_host("batch_loader.load", np.ones((16, 4), np.float32))
            health = RankHealth.all_healthy(8)
            health.mark_unhealthy(3)
            health.mark_unhealthy(3)
            health.mark_healthy(3)
            rng = np.random.default_rng(0)
            server = sv.SearchServer(rng.standard_normal((64, 16)).astype(np.float32),
                                     sv.ServerConfig(buckets=(4, 8), max_wait_ms=0.0), **kw)
            server.warmup(3)
            with pytest.raises(fl.FaultInjected):
                server.submit(rng.standard_normal((2, 16)).astype(np.float32), k=3)
            server.submit(rng.standard_normal((2, 16)).astype(np.float32), k=3)
            server.step()
            server.submit(rng.standard_normal((6, 16)).astype(np.float32), k=3)
            server.step()
            server.submit(rng.standard_normal((2, 16)).astype(np.float32), k=5)
            server.step()
    finally:
        if pkg == "port":
            comms.destroy()
    snap = om.snapshot()
    events, drops = [], []
    for e in snap["events"]:
        e = {k: v for k, v in e.items() if k not in ("t", "dur_s", "marks", "seq")}
        # the rank threads' drop events interleave with rank 0's
        # collective event: held apart, compared as one
        (drops if e["kind"] == "fault" and e.get("action") == "drop" else events).append(e)
    # the instruments the drill moved: a registry keeps the names other
    # tests defined in this process, at zero, across `reset()`
    return {"counters": {k: v for k, v in snap["metrics"]["counters"].items() if v},
            "events": events,
            "drops": [drops[0]] if drops and all(d == drops[0] for d in drops) else drops,
            "hist_counts": {n: a["count"] for n, a in snap["metrics"]["histograms"].items()
                            if a["count"]}}


def test_chaos_drill_snapshot_exact(obs_on):
    snap, jsnap = _chaos_drill("port"), _chaos_drill("jax")
    assert snap["counters"]["comms.allreduce.calls"] == 2
    assert snap["counters"]["comms.allreduce.bytes"] == 32
    assert snap["counters"]["serve.compile_cache.hit"] == 2
    assert snap["counters"]["serve.compile_cache.miss"] == 1
    assert snap["hist_counts"]["serve.warmup_compile_s"] == 2
    compile_evs = [(e["phase"], e["bucket"], e["k"], e.get("cached"))
                   for e in snap["events"] if e["kind"] == "compile"]
    assert compile_evs == [("warmup", 4, 3, None), ("warmup", 8, 3, None),
                           ("serve", 4, 3, True), ("serve", 8, 3, True),
                           ("serve", 4, 5, False)]
    knn_spans = [e for e in snap["events"]
                 if e["kind"] == "span" and e["name"] == "neighbors.brute_force.knn"]
    assert len(knn_spans) == 5
    assert {e["parent"] for e in knn_spans} == {"serve.warmup", "serve.batch"}
    assert snap["counters"] == jsnap["counters"]
    assert snap["hist_counts"] == jsnap["hist_counts"]
    assert snap["drops"] == jsnap["drops"] == [
        {"action": "drop", "kind": "fault", "rank": 3, "site": "comms.allreduce"}]
    assert json.dumps(snap["events"], sort_keys=True, default=str) == \
        json.dumps(jsnap["events"], sort_keys=True, default=str)


def test_chaos_drill_replays_identically(obs_on):
    assert _chaos_drill("port") == _chaos_drill("port")
