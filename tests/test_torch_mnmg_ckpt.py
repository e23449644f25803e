"""The port's distributed checkpoints (raft_tpu_torch/comms/mnmg_ckpt.py)
against the JAX package's, on the same indexes: JAX distributed IVF-Flat,
IVF-PQ and IVF-RaBitQ indexes built once at 4 ranks (2,003 x 16 blob
rows) and carried across.

- Both directions: a file the JAX package writes, the port loads (its
  searches are JAX's on the same file), and the port's file holds the
  JAX package's fields, bytes and metadata, so the JAX package loads it.
- The fold-merge load onto 2 and 1 ranks: the port's tables are the JAX
  load's, bit for bit, and the searches agree.
- Sharded checkpoints (`*_save_local`: part files and a manifest), both
  directions, onto a smaller world.
- A replicated index's checkpoint heals a corrupt primary from its mirror
  slices (a byte flipped in the store, and the "ckpt.corrupt_file" fault
  site), loading the clean tables, as the JAX load of the same file does;
  without mirrors the corruption raises ChecksumError.
"""

import numpy as np
import pytest
import torch

from raft_tpu.comms import Comms as JComms
from raft_tpu.comms import mnmg as jm
from raft_tpu.core.serialize import deserialize_arrays as jdeserialize
from raft_tpu.neighbors import ivf_flat as jflat
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import ivf_rabitq as jrq
from raft_tpu_torch.comms import Comms, mnmg
from raft_tpu_torch.core import faults
from raft_tpu_torch.core.serialize import ChecksumError, field_byte_range
from raft_tpu_torch.neighbors import ivf_flat as tflat
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import ivf_rabitq as trq

import _torch_mnmg_ivf_util as u

KINDS = ("ivf_flat", "ivf_pq", "ivf_rabitq")
STORE = {"ivf_flat": "list_data", "ivf_pq": "codes", "ivf_rabitq": "codes"}


def _params(kind, pkg):
    mod = {"ivf_flat": (jflat, tflat), "ivf_pq": (jpq, tpq), "ivf_rabitq": (jrq, trq)}[kind]
    mod = mod[0] if pkg == "jax" else mod[1]
    kw = dict(n_lists=u.N_LISTS, kmeans_n_iters=10)
    if kind == "ivf_pq":
        kw["pq_dim"] = u.PQ_DIM
    return mod.IndexParams(**kw)


def _api(kind, pkg):
    m = jm if pkg == "jax" else mnmg
    return (getattr(m, f"{kind}_build"), getattr(m, f"{kind}_save"), getattr(m, f"{kind}_load"),
            getattr(m, f"{kind}_search"))


def _search(kind, pkg, index, q):
    search = _api(kind, pkg)[3]
    if kind == "ivf_flat":
        return search(index, q, u.K, n_probes=u.N_PROBES, engine="list")
    if kind == "ivf_pq":
        return search(index, q, u.K, n_probes=u.N_PROBES, engine="lut")
    return search(index, q, u.K, n_probes=u.N_PROBES, scan_engine="xla")


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
def indexes(worlds, data):
    """{kind: (JAX index at 4 ranks, the port's carried copy)}."""
    jc, tc = worlds[4]
    out = {}
    for kind in KINDS:
        ji = _api(kind, "jax")[0](jc, _params(kind, "jax"), data[0])
        out[kind] = (ji, u.carry(tc, ji, kind, _params(kind, "torch")))
    return out


def _tables(index):
    """The host rank-major tables of a Distributed* of either package."""
    store = STORE["ivf_flat" if hasattr(index, "list_data") else "ivf_pq"]
    out = {}
    for name in (store, "slot_gids") + (("aux",) if hasattr(index, "aux") else ()):
        a = getattr(index, name)
        a = a.full().numpy() if hasattr(a, "full") else np.asarray(a)
        out[name] = a.view(np.uint32) if a.dtype == np.int32 and name == "codes" else a
    return out


def _assert_tables_equal(a, b):
    ta, tb = _tables(a), _tables(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


@pytest.mark.parametrize("kind", KINDS)
def test_jax_file_loads_in_the_port(indexes, worlds, data, tmp_path, kind):
    _, q, _ = data
    ji, _ = indexes[kind]
    path = str(tmp_path / f"{kind}.ckpt")
    _api(kind, "jax")[1](path, ji)
    ti = _api(kind, "torch")[2](worlds[4][1], path)
    assert ti.n == ji.n
    _assert_tables_equal(ti, ji)
    u.assert_same(_search(kind, "jax", ji, q), _search(kind, "torch", ti, q))


@pytest.mark.parametrize("kind", KINDS)
def test_port_file_is_the_jax_file(indexes, worlds, data, tmp_path, kind):
    _, q, _ = data
    ji, ti = indexes[kind]
    tpath, jpath = str(tmp_path / "t.ckpt"), str(tmp_path / "j.ckpt")
    _api(kind, "torch")[1](tpath, ti)
    _api(kind, "jax")[1](jpath, ji)
    ta, tmeta = jdeserialize(tpath, to_device=False)
    ja, jmeta = jdeserialize(jpath, to_device=False)
    assert tmeta == jmeta and list(ta) == list(ja)
    for f in ja:
        assert ta[f].dtype == ja[f].dtype, f
        np.testing.assert_array_equal(ta[f], ja[f], err_msg=f)
    jl = _api(kind, "jax")[2](worlds[4][0], tpath)
    u.assert_same(_search(kind, "jax", jl, q), _search(kind, "torch", ti, q))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("world", (1, 2))
def test_fold_merge_load_is_the_jax_load(indexes, worlds, data, tmp_path, kind, world):
    _, q, _ = data
    ji, _ = indexes[kind]
    path = str(tmp_path / "f.ckpt")
    _api(kind, "jax")[1](path, ji)
    jc, tc = worlds[world]
    jl = _api(kind, "jax")[2](jc, path)
    tl = _api(kind, "torch")[2](tc, path)
    assert tl.slot_gids.shape[0] == world
    _assert_tables_equal(tl, jl)
    np.testing.assert_array_equal(tl.list_sizes, np.asarray(jl.list_sizes))
    u.assert_same(_search(kind, "jax", jl, q), _search(kind, "torch", tl, q))


@pytest.mark.parametrize("kind", ("ivf_flat", "ivf_pq"))
def test_sharded_checkpoints_both_ways(indexes, worlds, data, tmp_path, kind):
    _, q, _ = data
    ji, ti = indexes[kind]
    save_local = {"ivf_flat": (jm.ivf_flat_save_local, mnmg.ivf_flat_save_local),
                  "ivf_pq": (jm.ivf_pq_save_local, mnmg.ivf_pq_save_local)}[kind]
    tpath, jpath = str(tmp_path / "ts.ckpt"), str(tmp_path / "js.ckpt")
    save_local[1](tpath, ti)
    save_local[0](jpath, ji)
    for path in (tpath, jpath):
        jl = _api(kind, "jax")[2](worlds[2][0], path)
        tl = _api(kind, "torch")[2](worlds[2][1], path)
        _assert_tables_equal(tl, jl)
        assert tl.local_gids is not None and tl.host_gids is not None
        u.assert_same(_search(kind, "jax", jl, q), _search(kind, "torch", tl, q))


def _flip(path, field, offset=7):
    start, _ = field_byte_range(path, field)
    with open(path, "r+b") as fh:
        fh.seek(start + offset)
        b = fh.read(1)
        fh.seek(start + offset)
        fh.write(bytes([b[0] ^ 0xFF]))


@pytest.mark.parametrize("kind", KINDS)
def test_corrupt_primary_heals_from_the_mirrors(indexes, worlds, data, tmp_path, kind):
    _, q, _ = data
    ji, _ = indexes[kind]
    jc, tc = worlds[4]
    ti = u.carry(tc, ji, kind, _params(kind, "torch"))
    mnmg.replicate_index(ti, 2)
    path = str(tmp_path / "rep.ckpt")
    _api(kind, "torch")[1](path, ti)
    _flip(path, STORE[kind])
    tl = _api(kind, "torch")[2](tc, path)
    _assert_tables_equal(tl, ti)
    assert tl.replicas is not None and tl.replicas.r == 2
    _assert_tables_equal(_api(kind, "jax")[2](jc, path), ti)
    u.assert_same(_search(kind, "jax", ji, q), _search(kind, "torch", tl, q))


def test_corrupt_file_fault_site_heals_and_unmirrored_corruption_raises(indexes, worlds,
                                                                       tmp_path):
    from raft_tpu_torch.core.serialize import deserialize_arrays_checked

    ji, _ = indexes["ivf_pq"]
    tc = worlds[4][1]
    ti = u.carry(tc, ji, "ivf_pq", _params("ivf_pq", "torch"))
    mnmg.replicate_index(ti, 2)
    path = str(tmp_path / "drill.ckpt")
    plan = faults.FaultPlan([faults.Fault(kind="corrupt_shard", site="ckpt.corrupt_file",
                                          fraction=0.01)], seed=3)
    with plan.install():
        mnmg.ivf_pq_save(path, ti)
    assert deserialize_arrays_checked(path, to_device=False)[2]
    _assert_tables_equal(mnmg.ivf_pq_load(tc, path), ti)
    plain = str(tmp_path / "plain.ckpt")
    mnmg.ivf_pq_save(plain, u.carry(tc, ji, "ivf_pq", _params("ivf_pq", "torch")))
    _flip(plain, "codes")
    with pytest.raises(ChecksumError):
        mnmg.ivf_pq_load(tc, plain)


def test_sharded_part_heals_from_its_mirror_slices(indexes, worlds, tmp_path):
    ji, _ = indexes["ivf_pq"]
    tc = worlds[4][1]
    ti = u.carry(tc, ji, "ivf_pq", _params("ivf_pq", "torch"))
    mnmg.replicate_index(ti, 2)
    path = str(tmp_path / "sh.ckpt")
    mnmg.ivf_pq_save_local(path, ti)
    _flip(f"{path}.part0", "store")
    tl = mnmg.ivf_pq_load(tc, path)
    _assert_tables_equal(tl, ti)
    _assert_tables_equal(jm.ivf_pq_load(worlds[4][0], path), ti)


def test_saves_refuse_what_they_cannot_write(indexes, worlds, data, tmp_path):
    x = data[0]
    tc = worlds[2][1]
    local = mnmg.ivf_flat_build_local(tc, _params("ivf_flat", "torch"), x)
    with pytest.raises(ValueError, match="host mirrors"):
        mnmg.ivf_flat_save(str(tmp_path / "a.ckpt"), local)
    bridged = mnmg.distribute_index(tc, tflat.build(tflat.IndexParams(n_lists=u.N_LISTS), x,
                                                    device="cpu"))
    with pytest.raises(ValueError, match="bridged"):
        mnmg.ivf_flat_save_local(str(tmp_path / "b.ckpt"), bridged)
    # a *_local index saves sharded and loads back
    mnmg.ivf_flat_save_local(str(tmp_path / "c.ckpt"), local)
    _assert_tables_equal(mnmg.ivf_flat_load(tc, str(tmp_path / "c.ckpt")), local)
    gids = mnmg.ivf_flat_load(worlds[1][1], str(tmp_path / "c.ckpt")).slot_gids.full()
    assert torch.equal(gids[gids >= 0].sort().values, torch.arange(u.N, dtype=torch.int32))
