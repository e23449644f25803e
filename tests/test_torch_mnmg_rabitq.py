"""The port's distributed IVF-RaBitQ driver
(raft_tpu_torch/comms/mnmg_rabitq.py) against the JAX package's on the
same numpy inputs: in-process CPU worlds of 1, 2 and 4 ranks against JAX
`Comms(n_devices=R)`, 2,003 x 16 blob rows, 37 queries, 16 lists. The JAX
indexes are built once per world and carried across
(`mnmg_ivf_build.index_from_arrays`, uint32 codes as int32 words).

- `ivf_rabitq_search` on a carried index, scan engines "xla", "fused"
  and "auto", with and without the exact refine: JAX's ids outside ties,
  values within 1e-5 relative. At 4 ranks the sharded query mode, a
  prefilter, adaptive probing, a degraded mask and replica failover (bit
  for bit the healthy answer, repaired rank listed).
- The patched-init build (JAX's rotation and k-means++ seeding handed to
  the port): the centers within 1e-5 relative, the gid tables, list
  sizes and codes JAX's, the corrections within 1e-5.
- The port's own build (its own seeds): recall@10 within 0.03 of JAX's.
- The fused store derives once and serves both scan engines the same
  candidates; a fused request past the kernel's caps raises.
"""

import numpy as np
import pytest
import torch

from raft_tpu.comms import Comms as JComms
from raft_tpu.comms import mnmg as jm
from raft_tpu.comms.resilience import RankHealth as JRankHealth
from raft_tpu.neighbors import ivf_rabitq as jrq
from raft_tpu_torch.comms import Comms, RankHealth, mnmg
from raft_tpu_torch.neighbors import ivf_rabitq as trq

import _torch_mnmg_ivf_util as u


def _params(mod):
    return mod.IndexParams(n_lists=u.N_LISTS, kmeans_n_iters=10)


@pytest.fixture(scope="module")
def data():
    return u.blobs()


@pytest.fixture(scope="module")
def indexes(data):
    """{world: (JAX comms, port comms, JAX index, the port's carried copy)}."""
    x = data[0]
    out = {}
    for r in u.WORLDS:
        jc, tc = JComms(n_devices=r), Comms(n_devices=r, device="cpu", timeout_s=60)
        ji = jm.ivf_rabitq_build(jc, _params(jrq), x)
        out[r] = (jc, tc, ji, u.carry(tc, ji, "ivf_rabitq", _params(trq)))
    yield out
    for _, tc, _, _ in out.values():
        tc.destroy()


@pytest.mark.parametrize("world", u.WORLDS)
@pytest.mark.parametrize("engine", ["xla", "fused", "auto"])
@pytest.mark.parametrize("refine", [False, True])
def test_search_on_one_index_equals_jax(indexes, data, world, engine, refine):
    x, q, truth = data
    _, _, ji, ti = indexes[world]
    kw = dict(n_probes=u.N_PROBES, scan_engine=engine, refine_dataset=x if refine else None)
    jres = jm.ivf_rabitq_search(ji, q, u.K, **kw)
    tres = mnmg.ivf_rabitq_search(ti, q, u.K, **kw)
    u.assert_same(jres, tres)
    if refine:  # the exact re-rank of the estimator's shortlist
        assert u.recall(tres[1], truth) >= 0.9


@pytest.mark.parametrize("variant", ["sharded", "prefilter", "adaptive", "degraded"])
def test_search_variants_at_four_ranks_equal_jax(indexes, data, variant):
    _, q, _ = data
    _, _, ji, ti = indexes[4]
    jkw, tkw = {}, {}
    if variant == "sharded":
        jkw = tkw = dict(query_mode="sharded")
    elif variant == "prefilter":
        jkw = tkw = dict(prefilter=np.random.default_rng(8).random(u.N) < 0.5)
    elif variant == "adaptive":
        jkw = tkw = dict(adaptive=True, recall_target=0.9)
    else:
        jkw = dict(health=JRankHealth.all_healthy(4).mark_unhealthy(3))
        tkw = dict(health=RankHealth.all_healthy(4).mark_unhealthy(3))
    jres = jm.ivf_rabitq_search(ji, q, u.K, n_probes=u.N_PROBES, **jkw)
    tres = mnmg.ivf_rabitq_search(ti, q, u.K, n_probes=u.N_PROBES, **tkw)
    u.assert_same(jres, tres)
    if variant == "degraded":
        assert tres.coverage == jres.coverage == 0.75


def test_replica_failover_is_the_healthy_answer(indexes, data):
    x, q, _ = data
    _, tc, ji, _ = indexes[4]
    ti = u.carry(tc, ji, "ivf_rabitq", _params(trq))
    mnmg.replicate_index(ti, 2)
    assert set(ti.replicas.tables) == {"codes", "aux", "slot_gids"}
    for engine in ("xla", "fused"):
        want = mnmg.ivf_rabitq_search(ti, q, u.K, n_probes=u.N_PROBES, scan_engine=engine,
                                      refine_dataset=x)
        res = mnmg.ivf_rabitq_search(ti, q, u.K, n_probes=u.N_PROBES, scan_engine=engine,
                                     refine_dataset=x,
                                     health=RankHealth.all_healthy(4).mark_unhealthy(1))
        assert res.coverage == 1.0 and res.repaired_ranks == (1,)
        assert torch.equal(res.values, want[0]) and torch.equal(res.ids, want[1])


@pytest.mark.parametrize("world", (2, 4))
def test_patched_init_build_is_jax_structurally(indexes, data, world, monkeypatch):
    from raft_tpu_torch.cluster import kmeans as tkmeans
    from raft_tpu_torch.neighbors import ivf_pq as tpq

    x = data[0]
    _, tc, ji, _ = indexes[world]
    rot = torch.as_tensor(np.array(ji.rotation))
    monkeypatch.setattr(tpq, "_make_rotation", lambda gen, rot_dim, dim, force: rot.clone())
    monkeypatch.setattr(tkmeans, "_kmeans_plusplus", u.jax_plusplus(0))
    ti = mnmg.ivf_rabitq_build(tc, _params(trq), x)
    jc, tcent = np.asarray(ji.centers), ti.centers.full().numpy()
    assert np.abs(tcent - jc).max() <= 1e-5 * np.abs(jc).max()
    jg = np.asarray(ji.host_gids)
    if np.array_equal(ti.host_gids, jg):
        np.testing.assert_array_equal(ti.list_sizes, np.asarray(ji.list_sizes))
        np.testing.assert_array_equal(ti.codes.full().numpy().view(np.uint32),
                                      np.asarray(ji.codes))
        np.testing.assert_allclose(ti.aux.full().numpy(), np.asarray(ji.aux), rtol=1e-5,
                                   atol=1e-5)
    else:
        x_rot = x @ np.asarray(ji.rotation).T
        lab = [np.full(u.N, -1), np.full(u.N, -1)]
        for li, g in enumerate((jg, ti.host_gids)):
            r_, l_, s_ = np.nonzero(g >= 0)
            lab[li][g[r_, l_, s_]] = l_
        assert u.near_tie_rows(x_rot, jc.astype(np.float64), tcent.astype(np.float64), *lab)


def test_own_build_matches_jax_recall(indexes, data):
    x, q, truth = data
    _, tc, ji, _ = indexes[4]
    ti = mnmg.ivf_rabitq_build(tc, _params(trq), x, seed=1)
    for kw in (dict(), dict(refine_dataset=x)):
        j_rec = u.recall(jm.ivf_rabitq_search(ji, q, u.K, n_probes=4, **kw)[1], truth)
        t_rec = u.recall(mnmg.ivf_rabitq_search(ti, q, u.K, n_probes=4, **kw)[1], truth)
        assert t_rec >= j_rec - 0.03


def test_fused_store_derives_once_and_refuses_past_its_caps(indexes, data):
    from raft_tpu_torch.ops.pq_list_scan import lane_padded

    _, q, _ = data
    _, tc, ji, _ = indexes[2]
    ti = u.carry(tc, ji, "ivf_rabitq", _params(trq))
    mnmg.ivf_rabitq_search(ti, q, u.K, n_probes=u.N_PROBES, scan_engine="fused")
    store = ti.codes_t
    assert store.shape[3] == lane_padded(int(ti.codes.shape[2]))
    assert ti.slot_gids_pad.shape[2] == store.shape[3]
    mnmg.ivf_rabitq_search(ti, q, u.K, n_probes=u.N_PROBES, scan_engine="fused")
    assert ti.codes_t is store
    with pytest.raises(ValueError):
        mnmg.ivf_rabitq_search(ti, q, 300, n_probes=u.N_PROBES, scan_engine="fused")
    with pytest.raises(ValueError, match="scan_engine"):
        mnmg.ivf_rabitq_search(ti, q, u.K, scan_engine="nope")
