"""PyTorch port: the serving layer (raft_tpu_torch/serve) against the JAX
package's raft_tpu/serve — tests/test_serve.py's cases, each run through
both packages on the same numpy data and requests.

- Batching: the port's merged, padded replies are bit for bit its own
  unbatched search of each request's rows (the JAX contract, held on the
  CPU as JAX holds it), and tie-equal to the JAX server's replies on the
  same JAX index carried across with `index_from_arrays`: brute force
  IVF-Flat "query" and IVF-PQ "recon8" to 1e-5 of each row's largest
  value (f32 sums in another order), IVF-RaBitQ (signed-permutation
  rotation) bit for bit.
- A request's reply in a mixed batch equals its reply alone in a batch of
  the same bucket (batch-mate independence), on every searcher.
- Admission, expiry, shedding, the probe_scale curve and the one-shot
  lifecycle: the same outcomes, counters and error types as JAX.
- Metrics: the same snapshot keys and counters, Prometheus text of the
  same metric names; the registry collector leaves with a dropped server.
- Chaos: the `serve.batch` / `serve.submit` sites deliver through the
  futures as in JAX; a degraded MNMG world answers at coverage 0.75,
  the same as JAX's, and a healthy mask restores 1.0. An MNMG search runs
  `Comms.run` from the server's worker thread, which did not build the
  world.
"""

import gc
import os
import re
import threading
import time

import numpy as np
import pytest

import torch

from raft_tpu import obs as jobs_obs
from raft_tpu import serve as jserve
from raft_tpu.core import faults as jfaults
from raft_tpu.neighbors import brute_force as jbf
from raft_tpu_torch import obs as tobs
from raft_tpu_torch import serve
from raft_tpu_torch.core import faults
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq

import _torch_serve_util as u

SEED = int(os.environ.get(faults.ENV_SEED, "1234"))
SPARAMS = {"ivf_flat": dict(n_probes=4, engine="query"),
           "ivf_pq": dict(n_probes=4, score_mode="recon8"),
           "ivf_rabitq": dict(n_probes=4, rerank_mult=4)}
#: each family's single-device parity tolerance against JAX (relative to
#: a row's largest value; 0 is bit for bit)
RTOL = {"brute_force": 1e-5, "ivf_flat": 1e-5, "ivf_pq": 1e-5, "ivf_rabitq": 0.0}


@pytest.fixture(scope="module")
def blobs():
    return u.blobs()


@pytest.fixture(scope="module")
def queries():
    rng = np.random.default_rng(7)
    return [rng.standard_normal((n, 16)).astype(np.float32) for n in (3, 5, 7)]


@pytest.fixture(scope="module")
def indexes(blobs):
    """{kind: (JAX index, the port's copy)}, built once."""
    out = {}
    for kind in u.KINDS:
        j = u.jax_build(kind, blobs)
        out[kind] = (j, u.carry(kind, j))
    return out


def _server(index, *, mod="port", cfg=None, **kw):
    cfg = cfg or (serve.ServerConfig if mod == "port" else jserve.ServerConfig)(buckets=(8, 32))
    if mod == "port":
        if isinstance(index, np.ndarray):
            kw.setdefault("device", "cpu")
        return serve.SearchServer(index, cfg, **kw)
    return jserve.SearchServer(index, cfg, **kw)


def _served(server, queries, k):
    futs = [server.submit(q, k=k) for q in queries]
    while not all(f.done() for f in futs):
        assert server.step() > 0, "queued requests but nothing served"
    return [f.result(timeout=1.0) for f in futs]


class CountingSearcher(serve.Searcher):
    """Wraps a searcher and counts device executions (proves expired
    requests never reach the device)."""

    def __init__(self, inner):
        self.inner = inner
        self.dim = inner.dim
        self.device = inner.device
        self.calls = 0

    def search(self, queries, k, probe_scale=1.0, recall_target=None):
        self.calls += 1
        return self.inner.search(queries, k, probe_scale, recall_target)


def _counting(blobs):
    return CountingSearcher(serve.BruteForceSearcher(blobs, device="cpu"))


# -- batching / bit-identity -------------------------------------------

def test_bucket_ladder():
    for rows in (1, 8, 9, 32):
        assert serve.bucket_for(rows, (8, 32)) == jserve.bucket_for(rows, (8, 32))
    for mod in (serve, jserve):
        with pytest.raises(ValueError):
            mod.bucket_for(33, (8, 32))


def _check_family(kind, server, jserver, queries, reference, k=6):
    got = _served(server, queries, k)
    want = _served(jserver, queries, k)
    for q, g, w in zip(queries, got, want):
        rv, ri = reference(q, k)
        u.assert_bitwise(g.values, g.ids, rv, ri)  # batched == unbatched, the port
        assert g.coverage == 1.0 == w.coverage
        assert g.values.dtype == w.values.dtype and g.ids.dtype == w.ids.dtype
        if RTOL[kind]:
            u.assert_tie_equal(g.values, g.ids, w.values, w.ids, rtol=RTOL[kind])
        else:
            u.assert_bitwise(g.values, g.ids, w.values, w.ids)


def test_batched_equals_unbatched_brute_force(blobs, queries):
    _check_family("brute_force", _server(blobs), _server(blobs, mod="jax"), queries,
                  lambda q, k: brute_force.knn(blobs, q, k, device="cpu"))
    assert serve.BruteForceSearcher(blobs, device="cpu").dataset.device.type == "cpu"


@pytest.mark.parametrize("kind", u.KINDS)
def test_batched_equals_unbatched_ivf(indexes, queries, kind):
    jidx, tidx = indexes[kind]
    tsp = u.TMOD[kind].SearchParams(**SPARAMS[kind])
    jsp = u.JMOD[kind].SearchParams(**SPARAMS[kind])
    server = _server(tidx, search_params=tsp)
    want_cls = {"ivf_flat": serve.IvfFlatSearcher, "ivf_pq": serve.IvfPqSearcher,
                "ivf_rabitq": serve.IvfRabitqSearcher}[kind]
    assert isinstance(server.searcher, want_cls)
    assert server.searcher.device == tidx.device
    _check_family(kind, server, _server(jidx, mod="jax", search_params=jsp), queries,
                  lambda q, k: u.TMOD[kind].search(tsp, tidx, q, k))


@pytest.mark.parametrize("kind", ("brute_force",) + u.KINDS)
def test_batch_mates_never_change_a_reply(blobs, indexes, kind):
    """A request's reply in a mixed batch equals its reply alone in a
    batch of the same bucket, bit for bit (requests of 3, 5, 7 and 16
    rows against the 32-row bucket)."""
    rng = np.random.default_rng(5)
    reqs = [rng.standard_normal((n, 16)).astype(np.float32) for n in (3, 5, 7, 16)]
    if kind == "brute_force":
        server = _server(blobs)
    else:
        server = _server(indexes[kind][1],
                         search_params=u.TMOD[kind].SearchParams(**SPARAMS[kind]))
    mixed = _served(server, reqs, 10)
    assert server.metrics.batches == 1
    for q, m in zip(reqs, mixed):
        # alone, padded to the same 32-row bucket as the mixed batch
        alone = server.searcher.search(np.concatenate([q, np.zeros((32 - len(q), 16),
                                                                   np.float32)]), 10)
        u.assert_bitwise(m.values, m.ids, alone[0][:len(q)], alone[1][:len(q)])


def test_auto_modes_refused_for_serving(indexes):
    for mod, i in (("port", 1), ("jax", 0)):
        sv = serve if mod == "port" else jserve
        fl = ivf_flat if mod == "port" else u.jfl
        pq = ivf_pq if mod == "port" else u.jpq
        with pytest.raises(ValueError, match="auto"):
            sv.SearchServer(indexes["ivf_flat"][i],
                            search_params=fl.SearchParams(engine="auto"))
        with pytest.raises(ValueError, match="auto"):
            sv.SearchServer(indexes["ivf_pq"][i],
                            search_params=pq.SearchParams(score_mode="auto"))


def test_mixed_k_requests_split_batches(blobs, queries):
    outs = []
    for mod in ("port", "jax"):
        server = _server(blobs, mod=mod)
        f5 = server.submit(queries[0], k=5)
        f7 = server.submit(queries[1], k=7)
        assert server.step() == 1  # only the k=5 request merges
        assert f5.done() and not f7.done()
        assert server.step() == 1
        outs.append((f5.result(1.0), f7.result(1.0)))
    (t5, t7), (j5, j7) = outs
    assert t7.ids.shape == j7.ids.shape == (queries[1].shape[0], 7)
    assert t5.ids.shape == j5.ids.shape == (queries[0].shape[0], 5)
    u.assert_tie_equal(t5.values, t5.ids, j5.values, j5.ids)


def test_sync_search_and_1d_query(blobs):
    reply = _server(blobs, cfg=serve.ServerConfig(buckets=(8,))).search(
        np.zeros(16, np.float32), k=3, timeout=5.0)
    jreply = _server(blobs, mod="jax", cfg=jserve.ServerConfig(buckets=(8,))).search(
        np.zeros(16, np.float32), k=3, timeout=5.0)
    assert reply.ids.shape == jreply.ids.shape == (1, 3)
    u.assert_tie_equal(reply.values, reply.ids, jreply.values, jreply.ids)
    # a caller's tensor is merged on the host like an array
    tensor_reply = _server(blobs, cfg=serve.ServerConfig(buckets=(8,))).search(
        torch.zeros(16), k=3, timeout=5.0)
    u.assert_bitwise(tensor_reply.values, tensor_reply.ids, reply.values, reply.ids)


def test_submit_validation(blobs):
    for mod in ("port", "jax"):
        server = _server(blobs, mod=mod)
        with pytest.raises(ValueError, match="dim"):
            server.submit(np.zeros((2, 9), np.float32), k=3)
        with pytest.raises(ValueError, match="largest bucket"):
            server.submit(np.zeros((33, 16), np.float32), k=3)
        with pytest.raises(ValueError, match="k must be positive"):
            server.submit(np.zeros((2, 16), np.float32), k=0)


# -- admission ----------------------------------------------------------

def test_deadline_expired_rejected_without_executing(blobs):
    counting = _counting(blobs)
    server = serve.SearchServer(counting, serve.ServerConfig(buckets=(8,)))
    fut = server.submit(np.zeros((2, 16), np.float32), k=3, deadline_s=1e-3)
    time.sleep(5e-3)
    assert server.step() == 1  # the expiry counts as an answer
    with pytest.raises(serve.DeadlineExceeded):
        fut.result(timeout=0.1)
    assert counting.calls == 0
    assert server.metrics.snapshot()["expired"] == 1


def test_default_deadline_from_config(blobs):
    counting = _counting(blobs)
    cfg = serve.ServerConfig(
        buckets=(8,), admission=serve.AdmissionConfig(default_deadline_s=1e-3))
    server = serve.SearchServer(counting, cfg)
    fut = server.submit(np.zeros((1, 16), np.float32), k=3)
    time.sleep(5e-3)
    server.step()
    with pytest.raises(serve.DeadlineExceeded):
        fut.result(timeout=0.1)
    assert counting.calls == 0


def test_reject_policy_full_queue(blobs):
    snaps = []
    for mod, sv in (("port", serve), ("jax", jserve)):
        cfg = sv.ServerConfig(buckets=(8,), admission=sv.AdmissionConfig(
            max_pending_rows=8, policy="reject"))
        server = _server(blobs, mod=mod, cfg=cfg)
        server.submit(np.zeros((6, 16), np.float32), k=3)
        with pytest.raises(sv.RejectedError):
            server.submit(np.zeros((6, 16), np.float32), k=3)
        server.step()  # room frees after a batch drains
        server.submit(np.zeros((6, 16), np.float32), k=3)
        snaps.append(server.metrics.snapshot())
    keys = ("submitted", "completed", "rejected", "expired", "failed", "batches",
            "queue_depth")
    assert [snaps[0][k] for k in keys] == [snaps[1][k] for k in keys]
    assert snaps[0]["rejected"] == 1


def test_block_policy_timeout_and_unblock(blobs):
    cfg = serve.ServerConfig(buckets=(8,), admission=serve.AdmissionConfig(
        max_pending_rows=8, policy="block", block_timeout_s=0.05))
    server = _server(blobs, cfg=cfg)
    server.submit(np.zeros((8, 16), np.float32), k=3)
    # full queue + nobody draining -> the blocked submit times out
    t0 = time.monotonic()
    with pytest.raises(serve.RejectedError):
        server.submit(np.zeros((4, 16), np.float32), k=3)
    assert time.monotonic() - t0 >= 0.04
    # with a drainer running, the same submit unblocks instead
    done = threading.Event()

    def drain():
        while not done.is_set() and server.batcher.pending_rows:
            server.step()
        done.set()

    t = threading.Thread(target=drain)
    t.start()
    fut = server.submit(np.zeros((4, 16), np.float32), k=3)
    server.step()
    assert fut.result(timeout=5.0).ids.shape == (4, 3)
    done.set()
    t.join(timeout=5.0)


def test_oversized_request_always_rejected(blobs):
    for mod, sv in (("port", serve), ("jax", jserve)):
        server = _server(blobs, mod=mod, cfg=sv.ServerConfig(
            buckets=(8,), admission=sv.AdmissionConfig(max_pending_rows=4)))
        with pytest.raises(sv.RejectedError, match="split"):
            server.batcher.submit(np.zeros((6, 16), np.float32), k=3)


def test_probe_scale_degradation_curve():
    kw = dict(max_pending_rows=100, degrade_at=0.5, min_probe_scale=0.25)
    ctl = serve.AdmissionController(serve.AdmissionConfig(**kw))
    jctl = jserve.AdmissionController(jserve.AdmissionConfig(**kw))
    assert ctl.probe_scale(0) == 1.0 and np.isclose(ctl.probe_scale(75), 0.625)
    assert np.isclose(ctl.probe_scale(10_000), 0.25)  # clamped past full
    for rows in range(0, 10_001, 7):
        assert ctl.probe_scale(rows) == jctl.probe_scale(rows), rows
    for bad in (dict(policy="nope"), dict(max_pending_rows=0), dict(degrade_at=0.0),
                dict(min_probe_scale=1.5)):
        with pytest.raises(ValueError):
            serve.AdmissionConfig(**bad)
        with pytest.raises(ValueError):
            jserve.AdmissionConfig(**bad)


def test_scaled_probes_and_request_params_match_jax():
    from raft_tpu.serve import engine as jengine

    from raft_tpu_torch.serve import engine as tengine

    for n in (1, 6, 8, 20):
        for scale in (0.1, 0.25, 0.5, 0.99, 1.0):
            assert tengine._scaled_probes(n, scale) == jengine._scaled_probes(n, scale)
    p = tengine._request_params(ivf_flat.SearchParams(n_probes=8), 0.25, 0.9)
    jp = jengine._request_params(u.jfl.SearchParams(n_probes=8), 0.25, 0.9)
    assert (p.n_probes, p.recall_target) == (jp.n_probes, jp.recall_target) == (2, 0.9)


def test_overload_shrinks_probes(indexes):
    seen = []

    class ProbeSpy(serve.IvfFlatSearcher):
        def search(self, queries, k, probe_scale=1.0, recall_target=None):
            seen.append(probe_scale)
            return super().search(queries, k, probe_scale, recall_target)

    cfg = serve.ServerConfig(buckets=(8,), admission=serve.AdmissionConfig(
        max_pending_rows=16, degrade_at=0.25, min_probe_scale=0.25))
    spy = ProbeSpy(indexes["ivf_flat"][1], ivf_flat.SearchParams(n_probes=8, engine="query"))
    server = serve.SearchServer(spy, cfg)
    for _ in range(2):
        server.submit(np.zeros((8, 16), np.float32), k=3)
    server.step()  # 8 rows still queued when this batch dispatches
    assert seen and seen[0] < 1.0
    jctl = jserve.AdmissionController(jserve.AdmissionConfig(
        max_pending_rows=16, degrade_at=0.25, min_probe_scale=0.25))
    assert seen[0] == jctl.probe_scale(8)


def test_server_closed(blobs):
    for mod, sv in (("port", serve), ("jax", jserve)):
        server = _server(blobs, mod=mod, cfg=sv.ServerConfig(buckets=(8,)))
        fut = server.submit(np.zeros((2, 16), np.float32), k=3)
        server.stop()
        with pytest.raises(sv.ServerClosed):
            fut.result(timeout=0.1)
        with pytest.raises(sv.ServerClosed):
            server.submit(np.zeros((2, 16), np.float32), k=3)
        # the lifecycle is one-shot: a restart would silently serve nothing
        with pytest.raises(sv.ServerClosed, match="one-shot"):
            server.start()


def test_flaky_batch_fault_delivered_not_raised(blobs):
    """An injected flaky fault at the dispatch site fails the batch's
    futures, not the step caller, in both packages."""
    for mod, fl, sv in (("port", faults, serve), ("jax", jfaults, jserve)):
        server = _server(blobs, mod=mod, cfg=sv.ServerConfig(buckets=(8,)))
        plan = fl.FaultPlan(
            [fl.Fault(kind="flaky_bootstrap", site="serve.batch", count=1)], seed=SEED)
        fut = server.submit(np.zeros((1, 16), np.float32), k=3)
        with plan.install():
            assert server.step() == 1  # must not raise
        with pytest.raises(fl.FaultInjected):
            fut.result(timeout=0.1)
        assert server.metrics.snapshot()["failed"] == 1
        fut = server.submit(np.zeros((1, 16), np.float32), k=3)
        server.step()
        assert fut.result(timeout=1.0).ids.shape == (1, 3)


def test_all_expired_queue_wakes_blocked_submitter(blobs):
    """When every queued request expires at collect time, a blocked
    submitter is woken by the freed room, not left to sleep out its whole
    block_timeout_s."""
    cfg = serve.ServerConfig(buckets=(8,), admission=serve.AdmissionConfig(
        max_pending_rows=8, policy="block", block_timeout_s=30.0))
    server = _server(blobs, cfg=cfg)
    server.submit(np.zeros((8, 16), np.float32), k=3, deadline_s=1e-3)
    time.sleep(5e-3)  # the queued request is now expired
    worker = threading.Thread(target=lambda: (time.sleep(0.05), server.step()))
    worker.start()
    t0 = time.monotonic()
    fut = server.submit(np.zeros((4, 16), np.float32), k=3)  # blocks, then wakes
    blocked_s = time.monotonic() - t0
    worker.join(timeout=5.0)
    server.step()
    assert fut.result(timeout=5.0).ids.shape == (4, 3)
    assert blocked_s < 5.0


# -- metrics ------------------------------------------------------------

def test_metrics_after_1k_query_run(blobs):
    rng = np.random.default_rng(3)
    all_q = rng.standard_normal((1000, 16)).astype(np.float32)
    want_v, want_i = (u.as_np(a) for a in brute_force.knn(blobs, all_q, 10, device="cpu"))
    jv, ji = (np.asarray(a) for a in jbf.knn(blobs, all_q, 10))
    cfg = serve.ServerConfig(buckets=(16, 64, 256), max_wait_ms=1.0, warmup_k=10)
    with _server(blobs, cfg=cfg) as server:
        results = [None] * all_q.shape[0]

        def client(lo, hi):
            futs = [(i, server.submit(all_q[i], k=10)) for i in range(lo, hi)]
            for i, fut in futs:
                results[i] = fut.result(timeout=60.0)

        threads = [threading.Thread(target=client, args=(lo, lo + 250))
                   for lo in range(0, 1000, 250)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120.0)
        snap = server.metrics.snapshot()
    got_v = np.concatenate([r.values for r in results])
    got_i = np.concatenate([r.ids for r in results])
    u.assert_bitwise(got_v, got_i, want_v, want_i)
    u.assert_tie_equal(got_v, got_i, jv, ji)
    assert snap["completed"] == 1000
    assert snap["qps"] > 0.0
    assert np.isfinite(snap["latency_ms_p99"])
    assert snap["latency_ms_p50"] <= snap["latency_ms_p99"]
    assert 0.0 < snap["batch_occupancy"] <= 1.0
    assert snap["batches"] >= 4  # 1000 rows can't fit one 256 bucket
    assert snap["expired"] == 0 and snap["rejected"] == 0


def test_metrics_snapshot_and_render_empty():
    m, jm = serve.ServerMetrics(latency_window=16), jserve.ServerMetrics(latency_window=16)
    snap, jsnap = m.snapshot(), jm.snapshot()
    assert list(snap) == list(jsnap)
    assert snap["completed"] == 0 and np.isnan(snap["qps"])
    text = m.render_text()
    assert "raft_tpu_serve_qps" in text and text.endswith("\n")
    with pytest.raises(ValueError):
        serve.ServerMetrics(latency_window=0)


def test_render_text_is_prometheus_exposition():
    """`render_text` stays scrape-able and names the JAX package's metrics:
    every line `name value`, the same names and, but for uptime and the
    rates and latencies a clock moves, the same values."""
    texts = []
    for sv in (serve, jserve):
        m = sv.ServerMetrics(latency_window=16)
        m.observe_submit()
        m.observe_batch(n_requests=1, valid_rows=2, bucket_rows=8, latencies_s=[0.01],
                        coverage=0.75)
        texts.append(m.render_text())
    lines = [t.strip().split("\n") for t in texts]
    for line in lines[0]:
        match = re.fullmatch(r"[a-zA-Z_:][a-zA-Z0-9_:]* (\S+)", line)
        assert match, f"not exposition format: {line!r}"
        float(match.group(1))
    assert "raft_tpu_serve_coverage_min 0.75" in lines[0]
    clocked = ("uptime_s", "qps")
    keep = [[ln for ln in ls if not ln.split(" ")[0].endswith(clocked)] for ls in lines]
    assert keep[0] == keep[1]


def test_server_metrics_collector_leaves_with_the_server():
    """With obs on, a server's metrics join the global snapshot as a
    `serve#<n>` section (`ServerMetrics.__init__._collect`); the weakref
    finalizer removes it once the server is dropped."""
    tobs.reset()
    tobs.enable()
    try:
        gc.collect()  # servers of earlier tests in this process leave first
        before = set(tobs.snapshot()["metrics"].get("collectors", {}))
        m = serve.ServerMetrics(latency_window=8)
        m.observe_submit()
        sections = tobs.snapshot()["metrics"]["collectors"]
        mine = [k for k in sections if k not in before]
        assert len(mine) == 1 and mine[0].startswith("serve#")
        assert sections[mine[0]]["submitted"] == 1
        del m, sections
        gc.collect()
        assert mine[0] not in tobs.snapshot()["metrics"].get("collectors", {})
    finally:
        tobs.reset()
        tobs.disable()
        jobs_obs.reset()
        jobs_obs.disable()


def test_warmup_compiles_every_bucket(blobs):
    counting = _counting(blobs)
    server = serve.SearchServer(counting, serve.ServerConfig(buckets=(8, 32, 128)))
    assert server.warmup(k=5) == 3
    assert counting.calls == 3
    assert server.warmup(k=5, ks=(3,)) == 6  # both k, every bucket
    assert len(server._compiled) == 6


# -- chaos --------------------------------------------------------------

def test_slow_rank_fault_degrades_coverage_within_deadline(blobs):
    """A slow rank past the health deadline gets masked, and the server
    answers at coverage 0.75 WITHIN the request deadline (as JAX's does
    on the same world shape) instead of hanging on the straggler; the
    MNMG search runs from the server's worker thread."""
    from raft_tpu_torch.comms import Comms, mnmg, resilience

    comms = Comms(n_devices=4, device="cpu")
    try:
        idx = mnmg.ivf_flat_build(comms, ivf_flat.IndexParams(n_lists=8, kmeans_n_iters=3),
                                  blobs)
        plan = faults.FaultPlan([faults.Fault(kind="slow_rank", site="resilience.barrier",
                                              rank=2, latency_s=60.0)], seed=SEED)
        with plan.install():
            health = resilience.probe_health(comms, timeout_s=0.5)
        assert health.degraded and health.coverage() == 0.75
        server = serve.SearchServer(idx, serve.ServerConfig(buckets=(8,)), health=health,
                                    n_probes=4, engine="list")
        assert isinstance(server.searcher, serve.MnmgSearcher)
        assert server.searcher.device == comms.device
        fut = server.submit(np.zeros((4, 16), np.float32), k=5, deadline_s=120.0)
        server.step()
        reply = fut.result(timeout=60.0)
        assert reply.coverage == 0.75 and reply.ids.shape == (4, 5)
        assert server.metrics.snapshot()["coverage_min"] == 0.75
        server.set_health(resilience.RankHealth.all_healthy(4))
        # the threaded worker (not the thread that built the world) runs
        # Comms.run for every batch
        callers = []
        inner = server.searcher.search

        def spy(*a, **kw):
            callers.append(threading.current_thread().name)
            return inner(*a, **kw)

        server.searcher.search = spy
        with server:
            replies = [server.submit(blobs[i:i + 2], k=5).result(timeout=60.0)
                       for i in range(0, 8, 2)]
        assert all(r.coverage == 1.0 for r in replies)
        assert set(callers) == {"raft-tpu-serve-worker"}
        want_v, want_i = mnmg.ivf_flat_search(idx, blobs[:8], 5, n_probes=4, engine="list",
                                              query_mode="replicated")
        u.assert_bitwise(np.concatenate([r.values for r in replies]),
                         np.concatenate([r.ids for r in replies]), want_v, want_i)
    finally:
        comms.destroy()


def test_slow_batch_dispatch_expires_queued_requests(blobs):
    """An injected slow device dispatch ("serve.batch") burns the queued
    requests' budgets; they expire at dispatch time, before the searcher
    runs."""
    counting = _counting(blobs)
    server = serve.SearchServer(counting, serve.ServerConfig(buckets=(8,)))
    plan = faults.FaultPlan(
        [faults.Fault(kind="slow_rank", site="serve.batch", latency_s=0.05)], seed=SEED)
    futs = [server.submit(np.zeros((2, 16), np.float32), k=3, deadline_s=0.02)
            for _ in range(2)]
    with plan.install():
        assert server.step() == 2  # dispatch-time expiries still count as answered
    for fut in futs:
        with pytest.raises(serve.DeadlineExceeded):
            fut.result(timeout=0.1)
    assert counting.calls == 0
    assert server.metrics.snapshot()["expired"] == 2


def test_flaky_submit_site(blobs):
    for mod, fl, sv in (("port", faults, serve), ("jax", jfaults, jserve)):
        server = _server(blobs, mod=mod, cfg=sv.ServerConfig(buckets=(8,)))
        plan = fl.FaultPlan(
            [fl.Fault(kind="flaky_bootstrap", site="serve.submit", count=1)], seed=SEED)
        with plan.install():
            with pytest.raises(fl.FaultInjected):
                server.submit(np.zeros((1, 16), np.float32), k=3)
            fut = server.submit(np.zeros((1, 16), np.float32), k=3)  # retries fine
        server.step()
        assert fut.result(timeout=1.0).ids.shape == (1, 3)


def test_searcher_failure_delivered_not_raised():
    class Exploding(serve.Searcher):
        dim = 16

        def search(self, queries, k, probe_scale=1.0, recall_target=None):
            raise RuntimeError("boom")

    server = serve.SearchServer(Exploding(), serve.ServerConfig(buckets=(8,)))
    fut = server.submit(np.zeros((1, 16), np.float32), k=3)
    server.step()  # must not raise
    with pytest.raises(RuntimeError, match="boom"):
        fut.result(timeout=0.1)
    assert server.metrics.snapshot()["failed"] == 1


def test_serve_exports_the_jax_all():
    assert serve.__all__ == jserve.__all__
    from raft_tpu_torch.serve import engine

    assert engine.BATCH_SITE == "serve.batch"
    from raft_tpu_torch.serve import batcher

    assert batcher.SUBMIT_SITE == "serve.submit"
    with pytest.raises(TypeError, match="cannot serve"):
        serve.as_searcher("not an index")
    with pytest.raises(TypeError, match="no health mask"):
        serve.SearchServer(np.zeros((4, 16), np.float32), device="cpu").set_health(None)
