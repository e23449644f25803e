"""The port's distributed IVF-PQ and IVF-Flat drivers
(raft_tpu_torch/comms/mnmg_ivf_build.py, mnmg_ivf_search.py) against the
JAX package's on the same numpy inputs: in-process CPU worlds of 1, 2 and
4 ranks against JAX `Comms(n_devices=R)` on the virtual devices, 2,003 x
16 blob rows (no world divides them), 37 queries, 16 lists, pq_dim 8.
The JAX indexes are built once per world (module fixtures) and carried
across (`mnmg_ivf_build.index_from_arrays`), so both packages search one
index.

- Every IVF-PQ engine on a carried index: "lut", the "recon8_list" trims
  ("approx", "fused", bf16 and int8 rows) and the refined pipeline give
  JAX's ids outside ties and its values within 1e-5 relative; the bin
  trim ("pallas") the same or, past ties, recall within 0.005 (ROADMAP
  Queue C). At 4 ranks also the query modes, a prefilter, adaptive
  probing, a degraded mask, quantization "off" and the post-merge refine
  of an extended index.
- IVF-Flat "query", "list", "pallas" and "auto" on a carried index, the
  same rule.
- Patched-init builds (the port's k-means++ and codebook EM handed JAX's
  results for the same rows): centers within 1e-5 relative; the gid
  tables, list sizes and codes JAX's, labels allowed to differ only at
  near-ties (1e-6 relative).
- The port's own builds (their own seeds): recall@10 within 0.03 of the
  JAX builds'.
- `ivf_*_extend` on a carried index: JAX's tables; `distribute_index` of a
  single-device index: its ids; `io.extend_from_file_local`: the direct
  `extend_local` calls; `probe_budget.resolve` / `policy_token`: JAX's.
"""

import numpy as np
import pytest
import torch

from raft_tpu.comms import Comms as JComms
from raft_tpu.comms import mnmg as jm
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import probe_budget as jpb
from raft_tpu_torch.comms import Comms, RankHealth, mnmg
from raft_tpu_torch.comms import mnmg_ivf_build
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import probe_budget as tpb

import _torch_mnmg_ivf_util as u

PQ_ENGINES = {
    "lut": dict(engine="lut"),
    "approx": dict(engine="recon8_list"),
    "approx_int8": dict(engine="recon8_list", score_dtype="int8"),
    "fused": dict(engine="recon8_list", trim_engine="fused"),
    "fused_int8": dict(engine="recon8_list", trim_engine="fused", score_dtype="int8"),
    "pallas": dict(engine="recon8_list", trim_engine="pallas"),
}


def _pq_params():
    return dict(n_lists=u.N_LISTS, pq_dim=u.PQ_DIM, kmeans_n_iters=10)


@pytest.fixture(scope="module")
def data():
    return u.blobs()


@pytest.fixture(scope="module")
def worlds():
    out = {r: (JComms(n_devices=r), Comms(n_devices=r, device="cpu", timeout_s=60))
           for r in u.WORLDS}
    yield out
    for _, tc in out.values():
        tc.destroy()


@pytest.fixture(scope="module")
def pq(worlds, data):
    """{world: (JAX index, the port's carried copy)}."""
    x = data[0]
    out = {}
    for r, (jc, tc) in worlds.items():
        ji = jm.ivf_pq_build(jc, jpq.IndexParams(**_pq_params()), x)
        out[r] = (ji, u.carry(tc, ji, "ivf_pq", tpq.IndexParams(**_pq_params())))
    return out


@pytest.fixture(scope="module")
def flat(worlds, data):
    x = data[0]
    out = {}
    for r, (jc, tc) in worlds.items():
        ji = jm.ivf_flat_build(jc, jflat.IndexParams(n_lists=u.N_LISTS, kmeans_n_iters=10), x)
        out[r] = (ji, u.carry(tc, ji, "ivf_flat", tflat.IndexParams(n_lists=u.N_LISTS)))
    return out


@pytest.mark.parametrize("world", u.WORLDS)
@pytest.mark.parametrize("engine", list(PQ_ENGINES))
def test_pq_engines_on_one_index_equal_jax(pq, data, world, engine):
    _, q, truth = data
    ji, ti = pq[world]
    kw = PQ_ENGINES[engine]
    jres = jm.ivf_pq_search(ji, q, u.K, n_probes=u.N_PROBES, **kw)
    tres = mnmg.ivf_pq_search(ti, q, u.K, n_probes=u.N_PROBES, **kw)
    if engine == "pallas":
        u.assert_same_or_recall(jres, tres, truth)
    else:
        u.assert_same(jres, tres)


@pytest.mark.parametrize("world", u.WORLDS)
def test_pq_refined_pipeline_equals_jax(pq, data, world):
    x, q, truth = data
    ji, ti = pq[world]
    jres = jm.ivf_pq_search(ji, q, u.K, n_probes=u.N_PROBES, refine_dataset=x)
    tres = mnmg.ivf_pq_search(ti, q, u.K, n_probes=u.N_PROBES, refine_dataset=x)
    u.assert_same(jres, tres)
    assert u.recall(tres[1], truth) >= 0.95
    # the refine layout is cached by the dataset's identity, and released
    assert ti._refine_cache is not None and ti._refine_cache[0] is x
    ti.clear_refine_cache()
    assert ti._refine_cache is None


VARIANTS = {
    "sharded": dict(query_mode="sharded"),
    "auto": dict(query_mode="auto"),
    "prefilter": "prefilter",
    "adaptive": dict(adaptive=True, recall_target=0.9),
    "budget_tau": dict(budget_tau=0.3, min_probes=2),
    "quantization_off": dict(quantization="off"),
}


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_pq_search_variants_at_four_ranks_equal_jax(pq, data, variant):
    x, q, _ = data
    ji, ti = pq[4]
    kw = VARIANTS[variant]
    if kw == "prefilter":
        kw = dict(prefilter=np.random.default_rng(5).random(u.N) < 0.6)
    jres = jm.ivf_pq_search(ji, q, u.K, n_probes=u.N_PROBES, engine="recon8_list", **kw)
    tres = mnmg.ivf_pq_search(ti, q, u.K, n_probes=u.N_PROBES, engine="recon8_list", **kw)
    u.assert_same(jres, tres)
    if "prefilter" in kw:
        assert kw["prefilter"][u.as_np(tres)[1]].all()


def test_pq_degraded_mask_equals_jax(pq, data):
    from raft_tpu.comms.resilience import RankHealth as JRankHealth

    _, q, _ = data
    ji, ti = pq[4]
    jres = jm.ivf_pq_search(ji, q, u.K, n_probes=u.N_PROBES, engine="lut",
                            health=JRankHealth.all_healthy(4).mark_unhealthy(2))
    tres = mnmg.ivf_pq_search(ti, q, u.K, n_probes=u.N_PROBES, engine="lut",
                              health=RankHealth.all_healthy(4).mark_unhealthy(2))
    assert tres.coverage == jres.coverage == 0.75 and tres.repaired_ranks == ()
    u.assert_same(jres, tres)
    with pytest.warns(UserWarning, match="REPLICATED"):
        mnmg.ivf_pq_search(ti, q, u.K, n_probes=u.N_PROBES, engine="lut",
                           query_mode="sharded",
                           health=RankHealth.all_healthy(4).mark_unhealthy(2))


@pytest.mark.parametrize("world", (2, 4))
def test_pq_extend_and_post_merge_refine_equal_jax(pq, data, world):
    x, q, _ = data
    ji, ti = pq[world]
    new = x[:300] + np.float32(0.05)
    je = jm.ivf_pq_extend(ji, new)
    te = mnmg.ivf_pq_extend(ti, new)
    assert te.extended and te.n == je.n == u.N + 300
    np.testing.assert_array_equal(te.host_gids, np.asarray(je.host_gids))
    np.testing.assert_array_equal(te.list_sizes, np.asarray(je.list_sizes))
    np.testing.assert_array_equal(te.codes.full().numpy(), np.asarray(je.codes))
    full = np.concatenate([x, new])
    u.assert_same(jm.ivf_pq_search(je, q, u.K, n_probes=u.N_PROBES, refine_dataset=full),
                  mnmg.ivf_pq_search(te, q, u.K, n_probes=u.N_PROBES, refine_dataset=full))
    with pytest.raises(ValueError, match="degraded-mode refine"):
        mnmg.ivf_pq_search(te, q, u.K, refine_dataset=full,
                           health=RankHealth.all_healthy(world).mark_unhealthy(0))


@pytest.mark.parametrize("world", u.WORLDS)
@pytest.mark.parametrize("engine", ["query", "list", "pallas", "auto"])
def test_flat_engines_on_one_index_equal_jax(flat, data, world, engine):
    _, q, truth = data
    ji, ti = flat[world]
    jres = jm.ivf_flat_search(ji, q, u.K, n_probes=u.N_PROBES, engine=engine)
    tres = mnmg.ivf_flat_search(ti, q, u.K, n_probes=u.N_PROBES, engine=engine)
    if engine == "pallas":
        u.assert_same_or_recall(jres, tres, truth)
    else:
        u.assert_same(jres, tres)


def test_flat_sharded_prefilter_and_extend_equal_jax(flat, data):
    x, q, _ = data
    ji, ti = flat[4]
    keep = np.random.default_rng(6).random(u.N) < 0.5
    for kw in (dict(query_mode="sharded"), dict(prefilter=keep),
               dict(adaptive=True, recall_target=0.9)):
        u.assert_same(jm.ivf_flat_search(ji, q, u.K, n_probes=u.N_PROBES, engine="list", **kw),
                      mnmg.ivf_flat_search(ti, q, u.K, n_probes=u.N_PROBES, engine="list", **kw))
    new = x[:200] + np.float32(0.05)
    je, te = jm.ivf_flat_extend(ji, new), mnmg.ivf_flat_extend(ti, new)
    np.testing.assert_array_equal(te.host_gids, np.asarray(je.host_gids))
    np.testing.assert_array_equal(te.list_data.full().numpy(), np.asarray(je.list_data))
    u.assert_same(jm.ivf_flat_search(je, new[:20], u.K, n_probes=u.N_PROBES, engine="list"),
                  mnmg.ivf_flat_search(te, new[:20], u.K, n_probes=u.N_PROBES, engine="list"))


def _rank_labels(gids, n):
    """Each row's list from a (R, n_lists, max_list) gid table."""
    lab = np.full(n, -1, np.int64)
    r_, l_, s_ = np.nonzero(gids >= 0)
    lab[gids[r_, l_, s_]] = l_
    return lab


@pytest.mark.parametrize("world", (2, 4))
def test_patched_init_pq_build_is_jax_structurally(pq, worlds, data, world, monkeypatch):
    """With JAX's k-means++ seeding and codebooks handed to the port's
    build, the distributed EM lands on JAX's centers and the tables are
    JAX's (labels may move only at near-ties)."""
    from raft_tpu_torch.cluster import kmeans as tkmeans

    x = data[0]
    ji, _ = pq[world]
    monkeypatch.setattr(tkmeans, "_kmeans_plusplus", u.jax_plusplus(0))
    monkeypatch.setattr(mnmg_ivf_build, "_train_codebooks",
                        lambda *a, **k: torch.as_tensor(np.asarray(ji.pq_centers)))
    ti = mnmg.ivf_pq_build(worlds[world][1], tpq.IndexParams(**_pq_params()), x)
    jc, tcent = np.asarray(ji.centers), ti.centers.full().numpy()
    assert np.abs(tcent - jc).max() <= 1e-5 * np.abs(jc).max()
    jg, tg = np.asarray(ji.host_gids), ti.host_gids
    if not np.array_equal(tg, jg):
        assert u.near_tie_rows(x, jc.astype(np.float64), tcent.astype(np.float64),
                               _rank_labels(jg, u.N), _rank_labels(tg, u.N))
    else:
        np.testing.assert_array_equal(ti.list_sizes, np.asarray(ji.list_sizes))
        np.testing.assert_array_equal(ti.codes.full().numpy(), np.asarray(ji.codes))
    np.testing.assert_array_equal(ti.slot_gids.full().numpy(), tg)


@pytest.mark.parametrize("world", (2, 4))
def test_patched_init_flat_build_is_jax_structurally(flat, worlds, data, world, monkeypatch):
    from raft_tpu_torch.cluster import kmeans as tkmeans

    x = data[0]
    ji, _ = flat[world]
    monkeypatch.setattr(tkmeans, "_kmeans_plusplus", u.jax_plusplus(0))
    ti = mnmg.ivf_flat_build(worlds[world][1],
                             tflat.IndexParams(n_lists=u.N_LISTS, kmeans_n_iters=10), x)
    jc, tcent = np.asarray(ji.centers), ti.centers.full().numpy()
    assert np.abs(tcent - jc).max() <= 1e-5 * np.abs(jc).max()
    jg, tg = np.asarray(ji.host_gids), ti.host_gids
    if np.array_equal(tg, jg):
        np.testing.assert_array_equal(ti.list_data.full().numpy(), np.asarray(ji.list_data))
    else:
        assert u.near_tie_rows(x, jc.astype(np.float64), tcent.astype(np.float64),
                               _rank_labels(jg, u.N), _rank_labels(tg, u.N))


@pytest.mark.parametrize("world", (1, 4))
def test_own_builds_match_jax_recall(pq, flat, worlds, data, world):
    x, q, truth = data
    tc = worlds[world][1]
    ji, _ = pq[world]
    ti = mnmg.ivf_pq_build(tc, tpq.IndexParams(**_pq_params()), x, seed=1)
    j_rec = u.recall(jm.ivf_pq_search(ji, q, u.K, n_probes=u.N_PROBES, engine="lut")[1], truth)
    t_rec = u.recall(mnmg.ivf_pq_search(ti, q, u.K, n_probes=u.N_PROBES, engine="lut")[1], truth)
    assert t_rec >= j_rec - 0.03
    jf, _ = flat[world]
    tf = mnmg.ivf_flat_build(tc, tflat.IndexParams(n_lists=u.N_LISTS, kmeans_n_iters=10), x)
    j_rec = u.recall(jm.ivf_flat_search(jf, q, u.K, n_probes=4, engine="list")[1], truth)
    t_rec = u.recall(mnmg.ivf_flat_search(tf, q, u.K, n_probes=4, engine="list")[1], truth)
    assert t_rec >= j_rec - 0.03


def test_build_local_in_one_process_searches_like_the_driver_build(worlds, data):
    """In one process the *_local builds keep per-process mirrors; their
    indexes search like the driver builds' (the same recall), and the
    collective extend_local continues the id space."""
    x, q, truth = data
    tc = worlds[2][1]
    lp = mnmg.ivf_pq_build_local(tc, tpq.IndexParams(**_pq_params()), x)
    assert lp.host_gids is None and lp.local_gids.shape[0] == 2
    assert u.recall(mnmg.ivf_pq_search(lp, q, u.K, n_probes=u.N_PROBES, refine_dataset=x)[1],
                    truth) >= 0.95
    ext = mnmg.ivf_pq_extend_local(lp, x[:10] + np.float32(0.01))
    assert ext.n == u.N + 10 and int(ext.slot_gids.full().max()) == u.N + 9
    with pytest.raises(ValueError, match="extend_local"):
        mnmg.ivf_pq_extend(lp, x[:10])
    lf = mnmg.ivf_flat_build_local(tc, tflat.IndexParams(n_lists=u.N_LISTS), x)
    assert u.recall(mnmg.ivf_flat_search(lf, q, u.K, n_probes=u.N_PROBES)[1], truth) >= 0.9


def test_distribute_index_serves_the_single_device_ids(worlds, data):
    from raft_tpu_torch.comms import mnmg_ivf_search

    x, q, _ = data
    jc, tc = worlds[4]
    jsingle = jflat.build(jflat.IndexParams(n_lists=u.N_LISTS), x)
    tsingle = tflat.index_from_arrays(
        {f: np.asarray(getattr(jsingle, f)) for f in tflat.INDEX_FIELDS},
        tflat.IndexParams(n_lists=u.N_LISTS), device="cpu")
    jd = jm.distribute_index(jc, jsingle)
    td = mnmg.distribute_index(tc, tsingle)
    assert td.bridged and td.id_bound == jd.id_bound
    u.assert_same(jm.ivf_flat_search(jd, q, u.K, n_probes=u.N_PROBES, engine="list"),
                  mnmg.ivf_flat_search(td, q, u.K, n_probes=u.N_PROBES, engine="list"))
    _, sids = tflat.search(tflat.SearchParams(n_probes=u.N_PROBES), tsingle, q, u.K)
    np.testing.assert_array_equal(
        mnmg.ivf_flat_search(td, q, u.K, n_probes=u.N_PROBES, engine="list")[1].numpy(),
        sids.numpy())
    with pytest.raises(ValueError, match="bridged"):
        mnmg.ivf_flat_extend(td, x[:4])
    with pytest.raises(ValueError, match="bridged"):
        mnmg_ivf_search._refine_layout(mnmg.distribute_index(tc, tpq.index_from_arrays(
            {f: np.asarray(v) for f, v in _single_pq(x).items()},
            tpq.IndexParams(n_lists=u.N_LISTS, pq_dim=u.PQ_DIM), device="cpu")), x)


def _single_pq(x):
    ji = jpq.build(jpq.IndexParams(n_lists=u.N_LISTS, pq_dim=u.PQ_DIM), x)
    return {f: getattr(ji, f) for f in tpq.INDEX_FIELDS}


def test_extend_from_file_local_is_the_direct_extend_local(worlds, data, tmp_path):
    from raft_tpu_torch import io as tio

    x, q, _ = data
    tc = worlds[2][1]
    base = mnmg.ivf_pq_build_local(tc, tpq.IndexParams(**_pq_params()), x)
    new = x[:250] + np.float32(0.02)
    path = tmp_path / "new.fbin"
    with open(path, "wb") as f:
        np.asarray(new.shape, np.uint32).tofile(f)
        new.tofile(f)
    streamed = tio.extend_from_file_local(mnmg.ivf_pq_extend_local, base, str(path), 100)
    direct = base
    for s in range(0, 250, 100):
        direct = mnmg.ivf_pq_extend_local(direct, new[s:s + 100])
    assert streamed.n == direct.n == u.N + 250
    assert torch.equal(streamed.codes.full(), direct.codes.full())
    assert torch.equal(streamed.slot_gids.full(), direct.slot_gids.full())


@pytest.mark.parametrize("kw", [dict(), dict(adaptive=True), dict(recall_target=0.95),
                                dict(recall_target=1.0), dict(budget_tau=0.4, min_probes=3,
                                                              early_term=False)])
def test_probe_budget_resolve_and_policy_token_equal_jax(kw):
    import dataclasses
    import types

    t, j = tpb.resolve(20, **kw), jpb.resolve(20, **kw)
    assert (t is None) == (j is None)
    assert t is None or dataclasses.astuple(t) == dataclasses.astuple(j)
    params = types.SimpleNamespace(**{"adaptive": False, "recall_target": None,
                                      "budget_tau": None, "min_probes": 1,
                                      "early_term": True, **kw})
    assert tpb.policy_token(params, 20) == jpb.policy_token(params, 20)
