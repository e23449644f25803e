"""Distributed mutation (raft_tpu_torch/comms/mnmg_mutation.py) against
the JAX package's on the same indexes: JAX distributed IVF-Flat, IVF-PQ
and IVF-RaBitQ indexes built once at 4 ranks (2,003 x 16 blob rows),
carried across, replicated (r 2) on both sides.

- `delete`: the gid tables of every copy (primary, replica mirror, host
  mirrors) are JAX's after the same delete, no deleted id comes back from
  any engine or under failover, and the searches are JAX's; the input
  index is untouched.
- `upsert` with caller ids and without: the tables are JAX's (the extend
  and the tail remap), the searches are JAX's, and each upserted row
  finds itself first through the post-merge refine; RaBitQ refuses.
- `apply_batch`: a feed of batches equals the direct calls.
"""

import copy

import numpy as np
import pytest
import torch

from raft_tpu.comms import Comms as JComms
from raft_tpu.comms import mnmg as jm
from raft_tpu.comms import mnmg_mutation as jmut
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import ivf_rabitq as jrq
from raft_tpu_torch.comms import Comms, RankHealth, mnmg
from raft_tpu_torch.comms import mnmg_mutation as tmut
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import ivf_rabitq as trq

import _torch_mnmg_ivf_util as u

PARAMS = {"ivf_flat": (jflat, tflat, {}), "ivf_pq": (jpq, tpq, {"pq_dim": u.PQ_DIM}),
          "ivf_rabitq": (jrq, trq, {})}


def _params(kind, pkg):
    jmod, tmod, extra = PARAMS[kind]
    return (jmod if pkg == "jax" else tmod).IndexParams(n_lists=u.N_LISTS, kmeans_n_iters=10,
                                                        **extra)


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
    return {kind: getattr(jm, f"{kind}_build")(jc, _params(kind, "jax"), data[0])
            for kind in PARAMS}


def _pair(world4, built, kind):
    ji = copy.copy(built[kind])
    ti = u.carry(world4[1], ji, kind, _params(kind, "torch"))
    jm.replicate_index(ji, 2)
    mnmg.replicate_index(ti, 2)
    return ji, ti


def _search(kind, index, q, pkg, **kw):
    m = jm if pkg == "jax" else mnmg
    if kind == "ivf_flat":
        return m.ivf_flat_search(index, q, u.K, n_probes=u.N_PROBES, engine="list", **kw)
    if kind == "ivf_pq":
        return m.ivf_pq_search(index, q, u.K, n_probes=u.N_PROBES, engine="lut", **kw)
    return m.ivf_rabitq_search(index, q, u.K, n_probes=u.N_PROBES, scan_engine="xla", **kw)


def _gid_copies(index):
    """Every copy of the gid tables of either package, as numpy."""
    def host(a):
        return a.full().numpy() if hasattr(a, "full") else np.asarray(a)

    out = {"slot_gids": host(index.slot_gids), "host_gids": np.asarray(index.host_gids)}
    if index.replicas is not None:
        out["mirror"] = host(index.replicas.tables["slot_gids"])
    return out


@pytest.mark.parametrize("kind", list(PARAMS))
def test_delete_masks_every_copy_as_jax(world4, built, data, kind):
    _, q, _ = data
    ji, ti = _pair(world4, built, kind)
    pre = u.as_np(_search(kind, ti, q, "torch"))[1]
    victims = np.unique(pre[:, :2])[:25]
    jd, td = jmut.delete(ji, victims), tmut.delete(ti, victims)
    for name, arr in _gid_copies(td).items():
        np.testing.assert_array_equal(arr, _gid_copies(jd)[name], err_msg=name)
        assert not np.isin(arr, victims).any(), name
    assert np.isin(_gid_copies(ti)["slot_gids"], victims).any()  # the input stands
    u.assert_same(_search(kind, jd, q, "jax"), _search(kind, td, q, "torch"))
    for r in range(4):
        res = _search(kind, td, q, "torch", health=RankHealth.all_healthy(4).mark_unhealthy(r))
        assert res.coverage == 1.0 and not np.isin(u.as_np(res)[1], victims).any()


def test_deleted_ids_stay_dead_on_the_fused_engines(world4, built, data):
    _, q, _ = data
    for kind, kw in (("ivf_pq", dict(engine="recon8_list", trim_engine="fused")),
                     ("ivf_flat", dict(engine="pallas")),
                     ("ivf_rabitq", dict(scan_engine="fused"))):
        _, ti = _pair(world4, built, kind)
        search = getattr(mnmg, f"{kind}_search")
        pre = u.as_np(search(ti, q, u.K, n_probes=u.N_PROBES, **kw))[1]
        victims = np.unique(pre[:, 0])
        out = u.as_np(search(tmut.delete(ti, victims), q, u.K, n_probes=u.N_PROBES, **kw))[1]
        assert not np.isin(out, victims).any(), kind


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
@pytest.mark.parametrize("with_ids", [True, False])
def test_upsert_equals_jax(world4, built, data, kind, with_ids):
    x, q, _ = data
    ji, ti = _pair(world4, built, kind)
    rows = x[:40] + np.float32(0.25)
    ids = np.arange(40) * 3 if with_ids else None
    ju, tu = jmut.upsert(ji, kind, rows, ids), tmut.upsert(ti, kind, rows, ids)
    assert tu.n == ju.n
    for name, arr in _gid_copies(tu).items():
        np.testing.assert_array_equal(arr, _gid_copies(ju)[name], err_msg=name)
    u.assert_same(_search(kind, ju, rows, "jax"), _search(kind, tu, rows, "torch"))
    if kind == "ivf_pq" and not with_ids:
        # the fresh gids continue the row order: the post-merge refine over
        # the rows with the upserts appended finds each upserted row first
        full = np.concatenate([x, rows])
        ids_out = mnmg.ivf_pq_search(tu, rows, u.K, n_probes=u.N_PROBES, refine_dataset=full)[1]
        np.testing.assert_array_equal(ids_out[:, 0].numpy(), u.N + np.arange(40))


def test_rabitq_upsert_refuses_and_apply_batch_follows_the_feed(world4, built, data):
    x, q, _ = data
    _, tr = _pair(world4, built, "ivf_rabitq")
    with pytest.raises(NotImplementedError, match="no distributed extend"):
        tmut.upsert(tr, "ivf_rabitq", x[:3])
    ji, ti = _pair(world4, built, "ivf_pq")
    feed = [("delete", np.array([5, 6, 7])), ("upsert", x[:8] + np.float32(0.5), np.arange(8)),
            ("rebalance",)]
    out, jout = ti, ji
    for batch in feed:
        out = tmut.apply_batch(out, "ivf_pq", batch)
        jout = jmut.apply_batch(jout, "ivf_pq", batch)
    for name, arr in _gid_copies(out).items():
        np.testing.assert_array_equal(arr, _gid_copies(jout)[name], err_msg=name)
    with pytest.raises(ValueError, match="unknown mutation op"):
        tmut.apply_batch(out, "ivf_pq", ("compact",))
