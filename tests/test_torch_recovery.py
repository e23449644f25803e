"""Replication, recovery, the distributed half of the watchdog and
`rehydrate` (raft_tpu_torch/comms/replication.py, recovery.py,
resilience.py, integrity/watchdog.py) against the JAX package's, on JAX
distributed IVF-PQ and IVF-Flat indexes built once at 4 ranks (2,003 x 16
blob rows) and carried across.

- `replicate_index`: the mirror tables are JAX's bit for bit (r 2 and 3);
  int8 mirrors within the codec's rounding of JAX's.
- Failover: with a rank marked down, every engine's answer is the healthy
  one bit for bit at coverage 1.0 with the rank in `repaired_ranks`, and
  JAX's failover answer; the view is cached per failure pattern. A stale
  holder (`replica.stale`) or a second adjacent failure past r-1 falls
  back to the degraded path, as in JAX.
- `repair` + `rank_rejoin` and `heal`: the primaries re-materialize, the
  mask flips after a barrier, the answer is the healthy one bit for bit;
  the obs events "repair" and "rejoin" land. With no surviving copy and
  no checkpoint, `RecoveryError`; with a checkpoint, `rehydrate`.
- The watchdog: `mnmg_digests` are JAX's; `rot_rank` flips JAX's bytes;
  `verify_mnmg` names the rotted rank; `repair_ranks` restores it byte
  for byte; `maybe_rot_mnmg` picks JAX's victim.
- `rehydrate` retries flaky reads at "mnmg_ckpt.load", gives up with
  `RetryExhausted`, and refuses another kind of file at once.
"""

import copy

import numpy as np
import pytest
import torch

from raft_tpu.comms import Comms as JComms
from raft_tpu.comms import mnmg as jm
from raft_tpu.comms.resilience import RankHealth as JRankHealth
from raft_tpu.core import faults as jfaults
from raft_tpu.integrity import watchdog as jwd
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch import obs
from raft_tpu_torch.comms import Comms, RankHealth, RecoveryError, mnmg, recovery, resilience
from raft_tpu_torch.core import faults
from raft_tpu_torch.integrity import watchdog as twd
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq

import _torch_mnmg_ivf_util as u


def _pq_params(mod):
    return mod.IndexParams(n_lists=u.N_LISTS, pq_dim=u.PQ_DIM, kmeans_n_iters=10)


@pytest.fixture(scope="module")
def data():
    return u.blobs()


@pytest.fixture(scope="module")
def world4():
    jc, tc = JComms(n_devices=4), Comms(n_devices=4, device="cpu", timeout_s=60)
    yield jc, tc
    tc.destroy()


@pytest.fixture(scope="module")
def built(world4, data):
    jc, _ = world4
    return {"ivf_pq": jm.ivf_pq_build(jc, _pq_params(jpq), data[0]),
            "ivf_flat": jm.ivf_flat_build(jc, jflat.IndexParams(n_lists=u.N_LISTS,
                                                                kmeans_n_iters=10), data[0])}


def _pair(world4, built, kind, r=1):
    """(a replicated JAX copy, the port's replicated carried copy)."""
    ji = copy.copy(built[kind])
    params = _pq_params(tpq) if kind == "ivf_pq" else tflat.IndexParams(n_lists=u.N_LISTS)
    ti = u.carry(world4[1], ji, kind, params)
    if r > 1:
        jm.replicate_index(ji, r)
        mnmg.replicate_index(ti, r)
    return ji, ti


@pytest.mark.parametrize("kind", ["ivf_pq", "ivf_flat"])
@pytest.mark.parametrize("r", [2, 3])
def test_mirror_tables_equal_jax(world4, built, kind, r):
    ji, ti = _pair(world4, built, kind, r)
    assert ti.replicas.r == r and ti.replicas.placement.world == 4
    assert set(ti.replicas.tables) == set(ji.replicas.tables)
    for name, t in ti.replicas.tables.items():
        assert t.shape == tuple(ji.replicas.tables[name].shape)
        np.testing.assert_array_equal(t.full().numpy(), np.asarray(ji.replicas.tables[name]))
    # idempotent per r; r=1 detaches
    tables = ti.replicas.tables
    assert mnmg.replicate_index(ti, r).replicas.tables is tables
    assert mnmg.replicate_index(ti, 1).replicas is None


def test_int8_mirror_within_the_codec_of_jax(world4, built):
    from raft_tpu.comms.replication import mirror_table as jmirror
    from raft_tpu_torch.comms.replication import mirror_table as tmirror

    ji, ti = _pair(world4, built, "ivf_flat")
    jt = np.asarray(jmirror(world4[0], ji.list_data, 2, quantization="int8"))
    tt = tmirror(world4[1], ti.list_data, 2, quantization="int8").full().numpy()
    exact = ti.list_data.full().numpy()[[3, 0, 1, 2]]
    scale = np.abs(exact).max()
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-6 * scale)
    assert np.abs(tt[:, 0] - exact).max() <= scale / 127.0
    # integer tables stay exact under a quantized mirror
    np.testing.assert_array_equal(
        tmirror(world4[1], ti.slot_gids, 2, quantization="int8").full().numpy()[:, 0],
        ti.slot_gids.full().numpy()[[3, 0, 1, 2]])


PQ_RUNS = {"approx": dict(engine="recon8_list"), "fused": dict(trim_engine="fused"),
           "lut": dict(engine="lut"), "refined": "refine"}


@pytest.mark.parametrize("run", list(PQ_RUNS))
def test_pq_failover_is_the_healthy_answer_and_jax(world4, built, data, run):
    x, q, _ = data
    ji, ti = _pair(world4, built, "ivf_pq", 2)
    kw = PQ_RUNS[run]
    if kw == "refine":
        kw = dict(refine_dataset=x)
    healthy = mnmg.ivf_pq_search(ti, q, u.K, n_probes=u.N_PROBES, **kw)
    res = mnmg.ivf_pq_search(ti, q, u.K, n_probes=u.N_PROBES,
                             health=RankHealth.all_healthy(4).mark_unhealthy(1), **kw)
    assert res.coverage == 1.0 and res.repaired_ranks == (1,)
    assert torch.equal(res.values, healthy[0]) and torch.equal(res.ids, healthy[1])
    jres = jm.ivf_pq_search(ji, q, u.K, n_probes=u.N_PROBES,
                            health=JRankHealth.all_healthy(4).mark_unhealthy(1), **kw)
    assert jres.repaired_ranks == res.repaired_ranks
    u.assert_same(jres, res)
    # the view is cached per failure pattern
    assert len(ti.replicas._views) == 1
    again = mnmg.ivf_pq_search(ti, q, u.K, n_probes=u.N_PROBES,
                               health=RankHealth.all_healthy(4).mark_unhealthy(1), **kw)
    assert torch.equal(again.ids, res.ids) and len(ti.replicas._views) == 1


@pytest.mark.parametrize("engine", ["list", "pallas"])
def test_flat_failover_is_the_healthy_answer(world4, built, data, engine):
    _, q, _ = data
    _, ti = _pair(world4, built, "ivf_flat", 2)
    healthy = mnmg.ivf_flat_search(ti, q, u.K, n_probes=u.N_PROBES, engine=engine)
    res = mnmg.ivf_flat_search(ti, q, u.K, n_probes=u.N_PROBES, engine=engine,
                               health=RankHealth.all_healthy(4).mark_unhealthy(3))
    assert res.coverage == 1.0 and res.repaired_ranks == (3,)
    assert torch.equal(res.values, healthy[0]) and torch.equal(res.ids, healthy[1])


def test_stale_holders_and_failures_past_r_degrade_as_jax(world4, built, data):
    _, q, _ = data
    ji, ti = _pair(world4, built, "ivf_pq", 2)
    kw = dict(n_probes=u.N_PROBES, engine="lut")
    # ranks 1 and 2 down: 2's holder (3) serves it, 1's holder (2) is dead
    res = mnmg.ivf_pq_search(ti, q, u.K, health=RankHealth(np.array([1, 0, 0, 1], bool)), **kw)
    jres = jm.ivf_pq_search(ji, q, u.K, health=JRankHealth(np.array([1, 0, 0, 1], bool)), **kw)
    assert res.coverage == jres.coverage == 0.75 and res.repaired_ranks == (2,)
    u.assert_same(jres, res)
    assert recovery.lost_ranks(ti, RankHealth(np.array([1, 0, 0, 1], bool))) == (1,)
    # holder 2 of rank 1's shard is stale: no failover, the degraded path
    tplan = faults.FaultPlan([faults.Fault(kind="kill_rank", site="replica.stale", rank=2)])
    jplan = jfaults.FaultPlan([jfaults.Fault(kind="kill_rank", site="replica.stale", rank=2)])
    with tplan.install():
        res = mnmg.ivf_pq_search(ti, q, u.K, health=RankHealth.all_healthy(4).mark_unhealthy(1),
                                 **kw)
    with jplan.install():
        jres = jm.ivf_pq_search(ji, q, u.K,
                                health=JRankHealth.all_healthy(4).mark_unhealthy(1), **kw)
    assert res.coverage == jres.coverage == 0.75 and res.repaired_ranks == ()
    u.assert_same(jres, res)


@pytest.fixture
def obs_on():
    obs.reset()
    obs.enable()
    yield obs
    obs.reset()
    obs.disable()


def _events(kind):
    return obs.bus().events(kind)


def test_repair_and_rejoin_restore_the_healthy_answer(world4, built, data, obs_on):
    x, q, _ = data
    _, ti = _pair(world4, built, "ivf_pq", 2)
    tc = world4[1]
    healthy = mnmg.ivf_pq_search(ti, q, u.K, n_probes=u.N_PROBES, refine_dataset=x)
    before = {n: t.full().clone() for n, t in (("codes", ti.codes), ("slot_gids", ti.slot_gids))}
    health = RankHealth.all_healthy(4).mark_unhealthy(2)
    out = recovery.repair(tc, health, ti)
    assert out is ti and health.degraded  # repair leaves the mask alone
    for n, t in before.items():
        assert torch.equal(getattr(ti, n).full(), t)
    health = recovery.rank_rejoin(tc, health, 2, timeout_s=30)
    assert not health.degraded and ti.replicas.r == 2
    again = mnmg.ivf_pq_search(ti, q, u.K, n_probes=u.N_PROBES, refine_dataset=x, health=health)
    assert torch.equal(again.values, healthy[0]) and torch.equal(again.ids, healthy[1])
    assert [e["source"] for e in _events("repair")] == ["replica"]
    assert [e["rank"] for e in _events("rejoin")] == [2]
    # heal: two failures with r=3, one barrier
    _, t3 = _pair(world4, built, "ivf_pq", 3)
    idx, h = recovery.heal(tc, RankHealth(np.array([1, 0, 0, 1], bool)), t3)
    assert not h.degraded and idx is t3


def test_lost_shards_need_a_checkpoint(world4, built, data, tmp_path):
    x, q, _ = data
    _, ti = _pair(world4, built, "ivf_pq")
    tc = world4[1]
    health = RankHealth.all_healthy(4).mark_unhealthy(0)
    with pytest.raises(RecoveryError, match="no surviving replica"):
        recovery.repair(tc, health, ti)
    path = str(tmp_path / "pq.ckpt")
    mnmg.ivf_pq_save(path, ti)
    fresh = recovery.repair(tc, health, ti, checkpoint=path)
    assert fresh is not ti
    u.assert_same(mnmg.ivf_pq_search(ti, q, u.K, n_probes=u.N_PROBES),
                  mnmg.ivf_pq_search(fresh, q, u.K, n_probes=u.N_PROBES))


def test_watchdog_digests_rot_and_repair_equal_jax(world4, built):
    ji, ti = _pair(world4, built, "ivf_pq", 2)
    jd, td = jwd.mnmg_digests(ji), twd.mnmg_digests(ti)
    assert jd.keys() == td.keys()
    for k in jd:
        np.testing.assert_array_equal(td[k], jd[k])
    jwd.rot_rank(ji, 2, seed=5)
    twd.rot_rank(ti, 2, seed=5)
    np.testing.assert_array_equal(ti.codes.full().numpy(), np.asarray(ji.codes))
    assert twd.verify_mnmg(ti, td) == jwd.verify_mnmg(ji, jd) == [2]
    healed = twd.repair_ranks(ti, [2])
    assert twd.verify_mnmg(healed, td) == []
    # the FaultPlan-driven rot picks JAX's victim
    _, t2 = _pair(world4, built, "ivf_pq", 2)
    j2 = copy.copy(built["ivf_pq"])
    tplan = faults.FaultPlan([faults.Fault(kind="corrupt_shard", site="integrity.table.rot",
                                           fraction=0.01)], seed=9)
    jplan = jfaults.FaultPlan([jfaults.Fault(kind="corrupt_shard", site="integrity.table.rot",
                                             fraction=0.01)], seed=9)
    with tplan.install():
        t_rot = twd.maybe_rot_mnmg(t2)
    with jplan.install():
        j_rot = jwd.maybe_rot_mnmg(j2)
    assert t_rot == j_rot and len(t_rot) == 1
    np.testing.assert_array_equal(t2.codes.full().numpy(), np.asarray(j2.codes))


def test_rehydrate_retries_flaky_reads(world4, built, tmp_path, obs_on):
    _, ti = _pair(world4, built, "ivf_flat")
    tc = world4[1]
    path = str(tmp_path / "flat.ckpt")
    mnmg.ivf_flat_save(path, ti)
    flaky = faults.FaultPlan([faults.Fault(kind="flaky_bootstrap", site="mnmg_ckpt.load",
                                           count=2)])
    with flaky.install():
        index, health = resilience.rehydrate(tc, path)
    assert not health.degraded and health.world == 4
    assert torch.equal(index.list_data.full(), ti.list_data.full())
    assert len(_events("retry")) == 2
    stuck = faults.FaultPlan([faults.Fault(kind="flaky_bootstrap", site="mnmg_ckpt.load",
                                           count=10)])
    with stuck.install(), pytest.raises(resilience.RetryExhausted):
        resilience.rehydrate(tc, path, max_retries=1)
    single = str(tmp_path / "single.ckpt")
    tflat.save(single, tflat.build(tflat.IndexParams(n_lists=4), np.eye(8, dtype=np.float32),
                                   device="cpu"))
    with pytest.raises(ValueError, match="not a distributed index checkpoint"):
        resilience.rehydrate(tc, single)
