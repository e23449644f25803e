"""The port's resilience layer (raft_tpu_torch/comms/resilience.py,
replication.py) and the chaos drills of tests/test_resilience.py on the
port: a 4-rank in-process CPU world, held against the JAX package where
the two compute the same thing.

- `RankHealth` marks and coverage as JAX's; health transitions on the obs
  bus.
- Degraded k-NN (one of four ranks marked down) equals the survivors'
  merge (a prefilter dropping the dead rank's rows) bit for bit, and JAX's
  degraded answer; a "sharded" request degrades to replicated with a
  warning; a corrupted shard behind the mask changes nothing.
- Failover with `replication=2`: the healthy answer bit for bit, coverage
  1.0, the dead rank in `repaired_ranks`; a stale holder (`replica.stale`)
  falls back to the degraded path; `ReplicaPlacement` equals JAX's.
- `retry_with_backoff`: the policy, the seeded jitter (the same delays as
  JAX's for the same seed) with one obs event a retry, the cap on elapsed
  time, exhaustion chaining the last cause; the bootstrap retry's
  exhaustion.
- `health_barrier` / `probe_health`: latency (the obs histogram), a
  straggler under and past the deadline, a passed plan driving the
  barrier, cancellation from another thread, the timeout.
- Collective drills: a dropped allreduce degrades k-means without a crash,
  a dropped allgather contribution arrives as zeros, k-means partials
  corruption replays bit for bit, a straggling k-means step changes
  nothing, quantized-scale rot degrades the merge but serves finite
  values.
"""

import os
import threading
import time
import warnings

import numpy as np
import pytest
import torch

from raft_tpu.comms import Comms as JComms
from raft_tpu.comms import mnmg as jm
from raft_tpu.comms import replication as jrep
from raft_tpu.comms import resilience as jres
from raft_tpu_torch import obs
from raft_tpu_torch.comms import Comms, mnmg, replication, resilience
from raft_tpu_torch.comms import comms as comms_mod
from raft_tpu_torch.comms.comms import P
from raft_tpu_torch.comms.resilience import DegradedSearchResult, RankHealth
from raft_tpu_torch.core import faults

SEED = int(os.environ.get(faults.ENV_SEED, "1234"))
WORLD = 4


@pytest.fixture(scope="module")
def comms4():
    c = Comms(n_devices=WORLD, device="cpu", timeout_s=60)
    yield c
    c.destroy()


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(13)
    centers = rng.uniform(-10, 10, (6, 16)).astype(np.float32)
    lab = rng.integers(0, 6, 1600)
    return (centers[lab] + 0.4 * rng.standard_normal((1600, 16))).astype(np.float32)


def _survivor_mask(n, dead):
    per = -(-n // WORLD)
    mask = np.ones(n, bool)
    mask[dead * per: min((dead + 1) * per, n)] = False
    return mask


def test_rank_health_mask_and_events():
    h = RankHealth.all_healthy(WORLD)
    j = jres.RankHealth.all_healthy(WORLD)
    assert h.coverage() == j.coverage() == 1.0 and not h.degraded
    obs.enable()
    try:
        obs.reset()
        h.mark_unhealthy(3)
        h.mark_unhealthy(3)  # a repeated mark is no transition
        j.mark_unhealthy(3)
        assert h.coverage() == j.coverage() == 0.75 and h.degraded
        assert h.healthy_ranks() == j.healthy_ranks() == (0, 1, 2)
        np.testing.assert_array_equal(h.live_f32(), j.live_f32())
        h.mark_healthy(3)
        events = obs.bus().events("health")
        assert [(e["rank"], e["healthy"]) for e in events] == [(3, False), (3, True)]
    finally:
        obs.disable()
        obs.reset()
    assert h.coverage() == 1.0


def test_degraded_knn_matches_survivor_merge_and_jax(comms4, blobs):
    q = blobs[:17]
    health = RankHealth.all_healthy(WORLD).mark_unhealthy(2)
    res = mnmg.knn(comms4, blobs, q, 10, health=health)
    assert isinstance(res, DegradedSearchResult)
    assert res.coverage == 0.75 and res.repaired_ranks == ()
    rv, ri = mnmg.knn(comms4, blobs, q, 10, prefilter=_survivor_mask(len(blobs), 2))
    assert torch.equal(res.ids, ri) and torch.equal(res.values, rv)
    jres_ = jm.knn(JComms(n_devices=WORLD), blobs, q, 10,
                   health=jres.RankHealth.all_healthy(WORLD).mark_unhealthy(2))
    np.testing.assert_array_equal(res.ids.numpy(), np.asarray(jres_.ids))
    # expanded L2 (|x|^2 + |q|^2 - 2 x.q): the error scales with the norms
    scale = 2 * float((blobs ** 2).sum(1).max())
    np.testing.assert_allclose(res.values.numpy(), np.asarray(jres_.values), rtol=0,
                               atol=1e-5 * scale)


def test_degraded_sharded_request_degrades_to_replicated(comms4, blobs):
    q = blobs[:16]
    health = RankHealth.all_healthy(WORLD).mark_unhealthy(1)
    with pytest.warns(UserWarning, match="REPLICATED"):
        res = mnmg.knn(comms4, blobs, q, 10, health=health, query_mode="sharded")
    ref = mnmg.knn(comms4, blobs, q, 10, health=health, query_mode="replicated")
    assert torch.equal(res.ids, ref.ids) and res.coverage == 0.75


def test_corrupt_knn_shard_masked_by_degraded_mode(comms4, blobs):
    """A poisoned shard (mnmg.knn.scores) behind the liveness mask gives
    the survivors' merge bit for bit; unmasked, it visibly poisons."""
    q = blobs[:17]
    plan = faults.FaultPlan(
        [faults.Fault(kind="kill_rank", rank=2),
         faults.Fault(kind="corrupt_shard", site="mnmg.knn.scores", rank=2, fraction=1.0)],
        seed=SEED)
    with plan.install():
        health = resilience.probe_health(comms4, timeout_s=30)
        res = mnmg.knn(comms4, blobs, q, 10, health=health)
    assert res.coverage == 0.75
    rv, ri = mnmg.knn(comms4, blobs, q, 10, prefilter=_survivor_mask(len(blobs), 2))
    assert torch.equal(res.ids, ri) and torch.equal(res.values, rv)
    corrupt_only = faults.FaultPlan(
        [faults.Fault(kind="corrupt_shard", site="mnmg.knn.scores", rank=2, fraction=1.0)],
        seed=SEED)
    clean_v, _ = mnmg.knn(comms4, blobs, q, 10)
    with corrupt_only.install():
        bad_v, _ = mnmg.knn(comms4, blobs, q, 10)
    assert not torch.equal(bad_v, clean_v)


def test_replicated_failover_is_the_healthy_answer(comms4, blobs):
    q = blobs[:17]
    hv, hi = mnmg.knn(comms4, blobs, q, 10)
    health = RankHealth.all_healthy(WORLD).mark_unhealthy(1)
    obs.enable()
    try:
        obs.reset()
        res = mnmg.knn(comms4, blobs, q, 10, health=health, replication=2)
        events = obs.bus().events("failover")
    finally:
        obs.disable()
        obs.reset()
    assert res.coverage == 1.0 and res.repaired_ranks == (1,)
    assert torch.equal(res.ids, hi) and torch.equal(res.values, hv)
    assert [(e["rank"], e["holder"], e["slot"]) for e in events] == [(1, 2, 0)]
    # a stale holder: the election fails and the degraded path masks rank 1
    stale = faults.FaultPlan([faults.Fault(kind="kill_rank", site="replica.stale", rank=2)],
                             seed=SEED)
    with stale.install():
        assert replication.stale_holders() == (2,)
        res = mnmg.knn(comms4, blobs, q, 10, health=health, replication=2)
    assert res.coverage == 0.75 and res.repaired_ranks == ()
    # r - 1 = 1 of two adjacent dead ranks is coverable (rank 0 by rank 1 is not)
    two = RankHealth.all_healthy(WORLD).mark_unhealthy(0).mark_unhealthy(1)
    res = mnmg.knn(comms4, blobs, q, 10, health=two, replication=2)
    assert res.repaired_ranks == (1,) and res.coverage == 0.75


def test_replica_placement_equals_jax():
    for world, r in ((4, 2), (8, 3), (5, 5), (3, 1)):
        t, j = replication.ReplicaPlacement(world, r), jrep.ReplicaPlacement(world, r)
        for rank in range(world):
            assert t.holders(rank) == j.holders(rank) and t.hosted(rank) == j.hosted(rank)
            for h in t.holders(rank):
                assert t.slot(h, rank) == j.slot(h, rank)
        th = RankHealth.all_healthy(world)
        jh = jres.RankHealth.all_healthy(world)
        for u in range(0, world, 2):
            th.mark_unhealthy(u)
            jh.mark_unhealthy(u)
        assert t.assignment(th) == j.assignment(jh)
        assert t.assignment(th, stale=(1,)) == j.assignment(jh, stale=(1,))
    with pytest.raises(ValueError):
        replication.ReplicaPlacement(4, 5)
    with pytest.raises(ValueError):
        replication.ReplicaPlacement(4, 2).slot(3, 0)


# -- retry ----------------------------------------------------------------

def test_retry_with_backoff_policy():
    attempts = []

    def flaky():
        attempts.append(time.monotonic())
        if len(attempts) < 3:
            raise RuntimeError("transient")
        return "ok"

    assert resilience.retry_with_backoff(flaky, base_delay_s=0.01) == "ok"
    assert len(attempts) == 3
    with pytest.raises(ValueError):
        resilience.retry_with_backoff(lambda: (_ for _ in ()).throw(ValueError("genuine")),
                                      retry_on=(RuntimeError,), base_delay_s=0.01)


def test_retry_backoff_seeded_jitter_matches_jax():
    """Same seed, same describe, process 0: the delays equal JAX's; one
    obs event a retry; exhaustion chains the last cause."""
    from raft_tpu import obs as jobs

    def delays(mod, o, seed):
        o.reset()

        def always_fail():
            raise RuntimeError("transient")

        with pytest.raises(mod.RetryExhausted) as ei:
            mod.retry_with_backoff(always_fail, max_retries=3, base_delay_s=0.001,
                                   jitter=0.5, seed=seed, describe="op")
        assert isinstance(ei.value.__cause__, RuntimeError)
        return [e["delay_s"] for e in o.bus().events(kind="retry")]

    obs.enable()
    jobs.enable()
    try:
        a, b, c = (delays(resilience, obs, s) for s in (11, 11, 12))
        ja = delays(jres, jobs, 11)
        assert len(a) == 3 and a == b and a != c
        assert a == ja
        assert all(d >= 0.001 * 2 ** i for i, d in enumerate(a))
        ev = obs.bus().events(kind="retry")[-1]
        assert ev["attempt"] == 3 and "transient" in ev["error"]
    finally:
        for o in (obs, jobs):
            o.reset()
            o.disable()


def test_retry_backoff_max_elapsed_cap():
    attempts = []

    def always_fail():
        attempts.append(1)
        raise RuntimeError("still down")

    t0 = time.monotonic()
    with pytest.raises(resilience.RetryExhausted, match="budget spent"):
        resilience.retry_with_backoff(always_fail, max_retries=50, base_delay_s=10.0,
                                      max_elapsed_s=0.05)
    assert time.monotonic() - t0 < 5
    assert len(attempts) == 1


def test_bootstrap_retry_exhaustion_propagates(monkeypatch):
    def unreachable(**kw):
        raise RuntimeError("unreachable")

    monkeypatch.setattr(comms_mod, "_init_process_group", unreachable)
    monkeypatch.setattr(comms_mod, "_MULTIHOST_INITIALIZED", False)
    with pytest.raises(resilience.RetryExhausted, match="unreachable") as ei:
        comms_mod.bootstrap_multihost(max_retries=1, backoff_s=0.01, device="cpu")
    assert isinstance(ei.value.__cause__, RuntimeError)
    assert comms_mod._MULTIHOST_INITIALIZED is False


# -- the health barrier -------------------------------------------------------

def test_health_barrier_and_probe(comms4):
    obs.enable()
    try:
        obs.reset()
        elapsed = resilience.health_barrier(comms4, timeout_s=30)
        hist = obs.registry().snapshot()["histograms"]["comms.barrier.latency_s"]
        assert hist["count"] == 1
    finally:
        obs.disable()
        obs.reset()
    assert 0 <= elapsed < 30
    assert resilience.probe_health(comms4, timeout_s=30).coverage() == 1.0
    slow = faults.FaultPlan([faults.Fault(kind="slow_rank", site="resilience.barrier", rank=1,
                                          latency_s=0.15)], seed=SEED)
    with slow.install():
        assert resilience.health_barrier(comms4, timeout_s=30) >= 0.15
    # a straggler past the deadline is masked without sleeping it out
    for rank, want in ((2, 0.75), (-1, 0.0)):
        plan = faults.FaultPlan([faults.Fault(kind="slow_rank", site="resilience.barrier",
                                              rank=rank, latency_s=9999.0)], seed=SEED)
        t0 = time.monotonic()
        with plan.install():
            health = resilience.probe_health(comms4, timeout_s=5)
        assert time.monotonic() - t0 < 5
        assert health.coverage() == want
    killed = faults.FaultPlan([faults.Fault(kind="kill_rank", site="resilience.barrier",
                                            rank=3)], seed=SEED)
    assert resilience.probe_health(comms4, timeout_s=5, plan=killed).healthy_ranks() == (0, 1, 2)


def test_health_barrier_deadline_covers_injected_latency(comms4):
    slow = faults.FaultPlan([faults.Fault(kind="slow_rank", site="resilience.barrier",
                                          latency_s=0.2)], seed=SEED)
    with slow.install():
        with pytest.raises(resilience.HealthCheckTimeout):
            resilience.health_barrier(comms4, timeout_s=0.1)
    plan = faults.FaultPlan([faults.Fault(kind="slow_rank", site="resilience.barrier",
                                          latency_s=0.05)], seed=SEED)
    with plan.install():
        assert resilience.health_barrier(comms4, timeout_s=30) >= 0.05


def test_probe_health_passed_plan_drives_barrier(comms4):
    plan = faults.FaultPlan([faults.Fault(kind="slow_rank", site="resilience.barrier", rank=1,
                                          latency_s=0.1)], seed=SEED)
    t0 = time.monotonic()
    health = resilience.probe_health(comms4, timeout_s=30, plan=plan)
    assert time.monotonic() - t0 >= 0.1
    assert health.coverage() == 1.0


def test_health_barrier_cancellable(comms4):
    from raft_tpu_torch.core.interruptible import InterruptedException, cancel

    tid = threading.get_ident()
    t = threading.Timer(0.05, cancel, args=(tid,))
    slow = faults.FaultPlan([faults.Fault(kind="slow_rank", site="resilience.barrier",
                                          latency_s=0.2)], seed=SEED)
    t.start()
    try:
        with slow.install():
            with pytest.raises(InterruptedException):
                resilience.health_barrier(comms4, timeout_s=30)
    finally:
        t.join()
    assert resilience.health_barrier(comms4, timeout_s=30) >= 0


def test_barrier_deadline_on_a_missing_rank(comms4):
    """A collective one rank never joins ends at the barrier's deadline
    with HealthCheckTimeout, not a hang."""
    def body(ac):
        if ac.get_rank() == 2:
            return torch.zeros(())
        return ac.barrier()

    t0 = time.monotonic()
    with pytest.raises(resilience.HealthCheckTimeout):
        comms4.run(body, in_specs=(), out_specs=P(), timeout_s=0.2)
    assert time.monotonic() - t0 < 10


# -- collective drills -----------------------------------------------------

def test_drop_collective_degrades_kmeans_not_crashes(comms4, blobs):
    plan = faults.FaultPlan([faults.Fault(kind="drop_collective", site="comms.allreduce",
                                          rank=3)], seed=SEED)
    with plan.install():
        centers, inertia, _ = mnmg.kmeans_fit(comms4, blobs, 6, max_iter=5, seed=0)
    assert torch.isfinite(centers).all() and np.isfinite(inertia)


def test_drop_allgather_contribution(comms4):
    x = np.arange(WORLD * 3, dtype=np.float32).reshape(WORLD, 3) + 1.0

    def run():
        return comms4.run(lambda ac, s: ac.allgather(s[0])[None], x, in_specs=P("data"),
                          out_specs=P("data")).numpy()

    clean = run()
    np.testing.assert_array_equal(clean[0], x)
    plan = faults.FaultPlan([faults.Fault(kind="drop_collective", site="comms.allgather",
                                          rank=2)], seed=SEED)
    with plan.install():
        dropped = run()
    for r in range(WORLD):
        assert (dropped[r][2] == 0).all()
        np.testing.assert_array_equal(dropped[r][[0, 1, 3]], x[[0, 1, 3]])


def test_kmeans_partials_corruption_fires_and_replays(comms4, blobs):
    clean_c, _, _ = mnmg.kmeans_fit(comms4, blobs, 6, max_iter=5, seed=0)
    plan = faults.FaultPlan([faults.Fault(kind="corrupt_shard", site="mnmg.kmeans.partials",
                                          rank=1, fraction=0.5)], seed=SEED)
    with plan.install():
        c1, _, _ = mnmg.kmeans_fit(comms4, blobs, 6, max_iter=5, seed=0)
    with faults.FaultPlan(plan.faults, seed=SEED).install():
        c2, _, _ = mnmg.kmeans_fit(comms4, blobs, 6, max_iter=5, seed=0)
    assert not torch.equal(c1, clean_c)
    np.testing.assert_array_equal(c1.numpy(), c2.numpy())


def test_kmeans_step_straggler_slows_but_identical(comms4, blobs):
    clean_c, _, clean_it = mnmg.kmeans_fit(comms4, blobs, 6, max_iter=4, seed=0)
    plan = faults.FaultPlan([faults.Fault(kind="slow_rank", site="mnmg.kmeans.step",
                                          latency_s=0.02)], seed=SEED)
    t0 = time.monotonic()
    with plan.install():
        c, _, it = mnmg.kmeans_fit(comms4, blobs, 6, max_iter=4, seed=0)
    assert time.monotonic() - t0 >= it * 0.02
    assert it == clean_it and torch.equal(c, clean_c)


@pytest.mark.parametrize("site,rank", [("comms.quant.encode", 1), ("comms.quant.decode", 0)])
def test_corrupt_quant_scales_degrade_but_serve(comms4, blobs, site, rank):
    q = blobs[:19]
    cv, ci = mnmg.knn(comms4, blobs, q, 10, quantization="int8")
    plan = faults.FaultPlan([faults.Fault(kind="corrupt_shard", site=site, rank=rank,
                                          fraction=1.0)], seed=SEED)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        with plan.install():
            bv, bi = mnmg.knn(comms4, blobs, q, 10, quantization="int8")
    assert torch.isfinite(bv).all()
    assert not (torch.equal(bi, ci) and torch.equal(bv, cv))
    rv, ri = mnmg.knn(comms4, blobs, q, 10, quantization="int8")
    assert torch.equal(ri, ci) and torch.equal(rv, cv)
