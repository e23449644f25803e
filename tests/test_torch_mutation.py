"""PyTorch port: live mutation (neighbors/mutation) against the JAX package.

Parity goes through JAX indexes (1200 x 32 blob rows, n_lists 8) carried
across with `index_from_arrays`; the RaBitQ index has a signed-permutation
rotation (as tests/test_torch_ivf_rabitq.py), so the two packages' scans
agree bit for bit. The JAX side runs as its own tests run it on the CPU.

- One seeded script (delete, upsert of existing ids, insert with
  ids=None, ensure_append_slack, an upsert into the slack, compact,
  more deletes, rebalance(min_dead_frac=)) runs on both packages:
  slot_rows, tombstones, list_sizes, source_ids, append_slack and
  live_rows equal bit for bit after every step, payload tables to the
  family's extend parity (IVF-Flat f32 rows to 1e-5; PQ and RaBitQ codes,
  RaBitQ aux bit for bit), and the search ids equal (IVF-Flat "query"
  engine, IVF-PQ bf16 "exact" trim, RaBitQ "xla" scan).
- On the port: delete equals the exclusion prefilter bit for bit on
  every engine; unaffected queries stay bit-identical (queries drawn near
  data rows: the reference's own drill draws gaussian queries far from
  its blobs, so every query shares neighbours with the first one and its
  victims, and no query is unaffected); idempotent delete and unknown
  ids; an upsert's id-count mismatch and a negative slack raise; the old
  index is untouched by every operation.
- Under tombstones adaptive probing turns its radius bounds off (the
  search equals one whose index has no radii) and returns the JAX
  adaptive search's ids.
- The lane-pad repair: delete -> IVF-Flat fused search -> delete ->
  compact works in the port; the JAX reference raises ValueError there
  (its lane pad widens `slot_rows` but not the mask: a stated reference
  fault).
- MutationLog: round trip and torn tail, CRC rot, a sequence gap, and a
  log written by either package reads in the other. Mutator: cold
  resume, a re-issued sequence deduped, an externally truncated log
  refused, index or checkpoint required, `retain` keeps snapshots; a
  directory written by the JAX Mutator (its checkpoint carries a digest
  sidecar) resumes in the port to the JAX tables and the JAX sidecar.
  MutationFeed and apply_batch.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import torch

from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import ivf_rabitq as jrb
from raft_tpu.neighbors import mutation as jm
from raft_tpu_torch.core.bitset import Bitset
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import ivf_rabitq as trb
from raft_tpu_torch.neighbors import mutation as tm

N, DIM, N_LISTS, NQ, K, N_PROBES = 1200, 32, 8, 24, 10, 4
KINDS = ("ivf_flat", "ivf_pq", "ivf_rabitq")
PAYLOAD = {"ivf_flat": ("list_data",), "ivf_pq": ("codes",), "ivf_rabitq": ("codes", "aux")}
TMOD = {"ivf_flat": tfl, "ivf_pq": tpq, "ivf_rabitq": trb}
JMOD = {"ivf_flat": jfl, "ivf_pq": jpq, "ivf_rabitq": jrb}
#: the search each family's parity holds bit for bit (or, IVF-Flat, with
#: f32 sums in another order) across the packages
PARITY = {"ivf_flat": dict(n_probes=N_PROBES, engine="query"),
          "ivf_pq": dict(n_probes=N_PROBES, score_mode="recon8_list", trim_engine="exact",
                         internal_distance_dtype="bfloat16"),
          "ivf_rabitq": dict(n_probes=N_PROBES, scan_engine="xla")}
CENTERS = np.random.default_rng(21).uniform(-5, 5, (N_LISTS, DIM)).astype(np.float32)


def _blobs(rng, n):
    return (CENTERS[rng.integers(0, N_LISTS, n)]
            + rng.standard_normal((n, DIM))).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(22)
    x = _blobs(rng, N)
    # queries near data rows, from every blob
    q = (x[rng.choice(N, NQ, replace=False)]
         + 0.1 * rng.standard_normal((NQ, DIM))).astype(np.float32)
    return x, q


def _jax_build(kind, x):
    if kind == "ivf_flat":
        return jfl.build(jfl.IndexParams(n_lists=N_LISTS, kmeans_n_iters=3), x)
    if kind == "ivf_pq":
        return jpq.build(jpq.IndexParams(n_lists=N_LISTS, pq_dim=8, kmeans_n_iters=3,
                                         kmeans_trainset_fraction=1.0), x)
    # a signed-permutation rotation: queries @ rotation.T is exact in both
    prng = np.random.default_rng(11)
    perm = np.zeros((DIM, DIM), np.float32)
    perm[np.arange(DIM), prng.permutation(DIM)] = prng.choice([-1.0, 1.0], DIM)
    jb = jrb.build(jrb.IndexParams(n_lists=N_LISTS, kmeans_n_iters=3, store_dataset=False,
                                   add_data_on_build=False), x)
    cent = (np.asarray(jb.centers) @ np.asarray(jb.rotation) @ perm.T).astype(np.float32)
    return jrb.extend(jrb.Index(jb.params, jnp.asarray(perm), jnp.asarray(cent), jb.codes,
                                jb.aux, jb.slot_rows, jb.list_sizes, jb.source_ids), x)


def _carry(kind, jidx):
    mod = TMOD[kind]
    arrays = {f: np.asarray(getattr(jidx, f)) for f in mod.INDEX_FIELDS}
    if kind == "ivf_flat":
        arrays["list_radii"] = np.asarray(jidx.list_radii)
        return tfl.index_from_arrays(arrays, tfl.IndexParams(n_lists=N_LISTS), device="cpu")
    if kind == "ivf_pq":
        arrays["list_radii"] = np.asarray(jidx.list_radii)
        return tpq.index_from_arrays(arrays, tpq.IndexParams(n_lists=N_LISTS, pq_dim=8),
                                     device="cpu")
    return trb.index_from_arrays(arrays, trb.IndexParams(n_lists=N_LISTS, store_dataset=False),
                                 device="cpu")


@pytest.fixture(scope="module")
def jax_indexes(data):
    x, _ = data
    return {kind: _jax_build(kind, x) for kind in KINDS}


def _port(jax_indexes, kind):
    return _carry(kind, jax_indexes[kind])


def _tsearch(kind, index, q, prefilter=None, params=None):
    mod = TMOD[kind]
    v, i = mod.search(mod.SearchParams(**(params or PARITY[kind])), index, torch.tensor(q), K,
                      prefilter=prefilter)
    return v.numpy(), i.numpy()


def _jsearch(kind, index, q, params=None):
    mod = JMOD[kind]
    v, i = mod.search(mod.SearchParams(**(params or PARITY[kind])), index, q, K)
    return np.asarray(v), np.asarray(i)


def _mask(index):
    t = index.tombstones
    if t is None:
        return None
    return (t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)).astype(bool)


def _same_state(kind, j, t):
    for f in ("slot_rows", "list_sizes", "source_ids"):
        np.testing.assert_array_equal(getattr(t, f).numpy(), np.asarray(getattr(j, f)), f)
    jt, tt = _mask(j), _mask(t)
    assert (jt is None) == (tt is None)
    if jt is not None:
        np.testing.assert_array_equal(tt, jt)
    assert t.append_slack == j.append_slack
    assert tm.live_rows(t) == jm.live_rows(j)
    for f in PAYLOAD[kind]:
        a, b = np.asarray(getattr(j, f)), getattr(t, f).numpy()
        if a.dtype.kind == "f":
            np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5)
        else:
            np.testing.assert_array_equal(b.view(a.dtype), a)


def _bits(v):
    return np.asarray(v, np.float32).view(np.int32)


@pytest.mark.parametrize("kind", KINDS)
def test_mutation_script_matches_jax(data, jax_indexes, kind):
    x, q = data
    j, t = jax_indexes[kind], _port(jax_indexes, kind)
    rng = np.random.default_rng(31)
    d1 = rng.choice(N, 90, replace=False)
    up = rng.choice(np.setdiff1d(np.arange(N), d1), 50, replace=False).astype(np.int32)
    v_up, v_new, v_slack = _blobs(rng, 50), _blobs(rng, 40), _blobs(rng, 30)
    ids_slack = np.arange(N + 40, N + 70, dtype=np.int32)
    steps = [
        ("delete", lambda m, i: m.delete(i, d1)),
        ("upsert", lambda m, i: m.upsert(i, v_up, up)),
        ("insert", lambda m, i: m.upsert(i, v_new)),
        ("slack", lambda m, i: m.ensure_append_slack(i, 40)),
        ("upsert into the slack", lambda m, i: m.upsert(i, v_slack, ids_slack)),
        ("compact", lambda m, i: m.compact(i)),
        ("delete more", lambda m, i: m.delete(i, rng_del)),
        ("rebalance", lambda m, i: m.rebalance(i, min_dead_frac=0.05)[0]),
    ]
    rng_del = np.random.default_rng(32).choice(N + 70, 150, replace=False)
    for name, step in steps:
        j, t = step(jm, j), step(tm, t)
        _same_state(kind, j, t)
        (jv, ji), (tv, ti) = _jsearch(kind, j, q), _tsearch(kind, t, q)
        np.testing.assert_array_equal(ti, ji, name)
        if kind == "ivf_flat":
            # |q|^2 + |v|^2 - 2 q.v in f32, summed in another order: within
            # 1e-5 of the row's scale (its largest value and |q|^2)
            scale = np.abs(jv).max(axis=1, keepdims=True) + (q * q).sum(1, keepdims=True)
            assert (np.abs(tv - jv) <= 1e-5 * scale).all(), name
        else:
            np.testing.assert_array_equal(_bits(tv), _bits(jv))
    assert t.tombstones is None and t.append_slack == 40
    # no deleted id comes back
    _, ti = _tsearch(kind, t, np.concatenate([q, v_up, x[d1[:20]]]))
    assert not np.isin(ti, np.concatenate([d1, rng_del])).any()


#: every engine of each family, by name
ENGINES = [("ivf_flat", dict(engine="query")), ("ivf_flat", dict(engine="list")),
           ("ivf_flat", dict(engine="fused")),
           ("ivf_pq", dict(score_mode="lut")), ("ivf_pq", dict(score_mode="recon8")),
           ("ivf_pq", dict(score_mode="recon8_list", trim_engine="exact")),
           ("ivf_pq", dict(score_mode="recon8_list", trim_engine="fused")),
           ("ivf_pq", dict(score_mode="recon8_list", trim_engine="pallas")),
           ("ivf_rabitq", dict(scan_engine="xla")),
           ("ivf_rabitq", dict(scan_engine="fused"))]
FUSED = {"ivf_flat": dict(n_probes=N_PROBES, engine="fused"),
         "ivf_pq": dict(n_probes=N_PROBES, score_mode="recon8_list", trim_engine="fused"),
         "ivf_rabitq": dict(n_probes=N_PROBES, scan_engine="fused")}


@pytest.mark.parametrize("kind,engine", ENGINES)
def test_delete_equals_exclusion_prefilter(data, jax_indexes, kind, engine):
    _, q = data
    idx = _port(jax_indexes, kind)
    victims = np.random.default_rng(33).choice(N, 150, replace=False)
    out = tm.delete(idx, victims)
    assert out is not idx and idx.tombstones is None
    assert out.n_tombstones == 150 and tm.live_rows(out) == N - 150
    params = dict(n_probes=N_PROBES, **engine)
    want = _tsearch(kind, idx, q, prefilter=Bitset.excluding(idx.id_bound, victims, device="cpu"),
                    params=params)
    got = _tsearch(kind, out, q, params=params)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    assert not np.isin(got[1], victims).any()


@pytest.mark.parametrize("kind", KINDS)
def test_unaffected_queries_stay_bit_identical(data, jax_indexes, kind):
    _, q = data
    idx = _port(jax_indexes, kind)
    pre_v, pre_i = _tsearch(kind, idx, q)
    victims = np.unique(pre_i[0])[:4]  # ids the first query returns
    out = tm.delete(idx, victims)
    post_v, post_i = _tsearch(kind, out, q)
    assert not np.isin(post_i, victims).any()
    untouched = ~np.isin(pre_i, victims).any(axis=1)
    assert 0 < untouched.sum() < NQ
    np.testing.assert_array_equal(post_i[untouched], pre_i[untouched])
    np.testing.assert_array_equal(_bits(post_v[untouched]), _bits(pre_v[untouched]))


def test_delete_is_idempotent_and_ignores_unknown_ids(jax_indexes):
    idx = _port(jax_indexes, "ivf_flat")
    out, n = tm.tombstone(idx, [3, 3, 10_000, -5])
    assert n == 1 and out.n_tombstones == 1
    again, n2 = tm.tombstone(out, [3])
    assert n2 == 0 and again is out
    assert tm.delete(idx, []) is idx


def test_upsert_id_count_mismatch_raises(jax_indexes):
    idx = _port(jax_indexes, "ivf_pq")
    with pytest.raises(ValueError, match="2 vectors but 1 ids"):
        tm.upsert(idx, np.zeros((2, DIM), np.float32), np.array([1]))
    assert idx.tombstones is None


def test_negative_slack_refused(jax_indexes):
    idx = _port(jax_indexes, "ivf_rabitq")
    with pytest.raises(ValueError, match="slack must be >= 0"):
        tm.ensure_append_slack(idx, -1)
    wide = tm.ensure_append_slack(idx, 64)
    assert wide.slot_rows.shape[1] % tm.GROUP == 0
    assert wide.slot_rows.shape[1] >= int(idx.list_sizes.max()) + 64
    assert tm.ensure_append_slack(wide, 64) is wide


def _snapshot(index):
    return {name: v.clone() for name, v in vars(index).items() if isinstance(v, torch.Tensor)}


@pytest.mark.parametrize("kind", KINDS)
def test_old_index_untouched(data, jax_indexes, kind):
    """Zero-dip: every operation returns a new object and writes into no
    tensor the old index holds (derived stores built by a search too)."""
    x, q = data
    idx = _port(jax_indexes, kind)
    rng = np.random.default_rng(34)
    ops = [lambda i: tm.delete(i, rng.choice(N, 60, replace=False)),
           lambda i: tm.upsert(i, _blobs(rng, 20), rng.choice(N, 20, replace=False)),
           lambda i: tm.upsert(i, _blobs(rng, 10)),
           lambda i: tm.ensure_append_slack(i, 48),
           lambda i: tm.delete(i, rng.choice(N, 60, replace=False)),
           lambda i: tm.compact(i),
           lambda i: tm.rebalance(tm.delete(i, np.arange(100)))[0]]
    for op in ops:
        _tsearch(kind, idx, q, params=FUSED[kind])  # derive the fused store first
        before = _snapshot(idx)
        mask = None if idx.tombstones is None else idx.tombstones.clone()
        out = op(idx)
        assert out is not idx
        for name, v in before.items():
            assert torch.equal(getattr(idx, name), v), name
        assert (idx.tombstones is None) == (mask is None)
        if mask is not None:
            assert torch.equal(idx.tombstones, mask)
        idx = out


@pytest.mark.parametrize("kind", KINDS)
def test_adaptive_bounds_off_under_tombstones(monkeypatch, data, jax_indexes, kind):
    """Under tombstones the plan gets no radii (the sizes count dead
    rows), and the adaptive search returns the JAX adaptive search's ids."""
    from raft_tpu_torch.neighbors import probe_budget

    _, q = data
    jidx, tidx = jax_indexes[kind], _port(jax_indexes, kind)
    victims = np.random.default_rng(35).choice(N, 200, replace=False)
    jd, td = jm.delete(jidx, victims), tm.delete(tidx, victims)
    seen = []
    plan = probe_budget.search_plan
    monkeypatch.setattr(probe_budget, "search_plan",
                        lambda *a, **kw: seen.append(kw["radii"]) or plan(*a, **kw))
    base = dict(PARITY[kind], n_probes=N_LISTS)
    for kw in (dict(budget_tau=0.3), dict(budget_tau=0.3, early_term=False),
               dict(recall_target=0.9)):
        params = dict(base, **kw)
        got = _tsearch(kind, td, q, params=params)
        np.testing.assert_array_equal(got[1], _jsearch(kind, jd, q, params=params)[1], str(kw))
        assert seen[-1] is None
        _tsearch(kind, tidx, q, params=params)
        assert seen[-1] is not None  # all live: the radii bound the plan
    assert not np.isin(got[1], victims).any()


def test_lane_pad_repair(data, jax_indexes):
    """delete -> fused search (the lane pad widens the store in place) ->
    delete -> compact. The port carries the mask to the padded width; the
    JAX reference widens slot_rows but not its mask and raises."""
    _, q = data
    jidx, tidx = jax_indexes["ivf_flat"], _port(jax_indexes, "ivf_flat")
    t1 = tm.delete(tidx, [1, 2])
    _tsearch("ivf_flat", t1, q, params=FUSED["ivf_flat"])
    assert t1.tombstones.shape == t1.slot_rows.shape
    t2 = tm.delete(t1, [3, 4])
    t3 = tm.compact(t2)
    assert t2.n_tombstones == 4 and t3.tombstones is None and tm.live_rows(t3) == N - 4
    _, ids = _tsearch("ivf_flat", t3, q, params=FUSED["ivf_flat"])
    assert not np.isin(ids, [1, 2, 3, 4]).any()
    j1 = jm.delete(jidx, [1, 2])
    jfl.search(jfl.SearchParams(n_probes=N_PROBES, engine="pallas"), j1, q, K)
    with pytest.raises(ValueError, match="broadcast"):
        jm.delete(j1, [3, 4])


# -- the crash-atomic log ------------------------------------------------

@pytest.mark.parametrize("mod", [tm, jm], ids=["port", "jax"])
def test_mutation_log_roundtrip_and_torn_tail(tmp_path, mod):
    log = mod.MutationLog(str(tmp_path))
    log.append("upsert", 0, "mut_000000.ckpt")
    log.append("delete", 1, "mut_000001.ckpt")
    with open(log.path, "ab") as fh:
        fh.write(b'{"v": 1, "seq": 2, "op": "delete"')  # torn by a kill mid-append
    other = (jm if mod is tm else tm).MutationLog(str(tmp_path))
    assert [e["op"] for e in other.entries()] == ["upsert", "delete"]
    other.append("rebalance", 2, None)  # terminates the torn line first
    assert [e["op"] for e in log.entries()] == ["upsert", "delete", "rebalance"]
    assert log.entries() == other.entries()


def test_mutation_log_crc_rot_ends_prefix(tmp_path):
    log = tm.MutationLog(str(tmp_path))
    for seq in range(3):
        log.append("delete", seq, f"mut_{seq:06d}.ckpt")
    lines = open(log.path, "rb").read().splitlines(keepends=True)
    rotted = lines[1].replace(b'"op": "delete"', b'"op": "upsert"')
    with open(log.path, "wb") as fh:
        fh.writelines([lines[0], rotted, lines[2]])
    assert [e["seq"] for e in log.entries()] == [0]
    assert jm.MutationLog(str(tmp_path)).entries() == log.entries()


def test_mutation_log_seq_gap_ends_prefix(tmp_path):
    log = tm.MutationLog(str(tmp_path))
    log.append("delete", 0, "mut_000000.ckpt")
    log.append("delete", 2, "mut_000002.ckpt")
    assert [e["seq"] for e in log.entries()] == [0]
    assert jm.MutationLog(str(tmp_path)).entries() == log.entries()


def test_batch_payloads_are_shared_with_the_jax_package(tmp_path):
    ids, vec = np.array([4, 5, 9], np.int32), np.arange(6, dtype=np.float32).reshape(3, 2)
    tm._save_batch(str(tmp_path / "t.ckpt"), "upsert", 7, torch.tensor(ids), vec)
    jm._save_batch(str(tmp_path / "j.ckpt"), "upsert", 7, ids, vec)
    assert (tmp_path / "t.ckpt").read_bytes() == (tmp_path / "j.ckpt").read_bytes()
    op, seq, got_ids, got_vec = tm._load_batch(str(tmp_path / "j.ckpt"))
    assert (op, seq) == ("upsert", 7)
    np.testing.assert_array_equal(got_ids, ids)
    np.testing.assert_array_equal(got_vec, vec)
    tm._save_batch(str(tmp_path / "d.ckpt"), "delete", 8, ids, None)
    assert jm._load_batch(str(tmp_path / "d.ckpt"))[3] is None


def _scripted(mut, seed=41):
    """A fixed mixed batch sequence: upserts over build ids, fresh ids,
    deletes including a just-upserted id, one logged rebalance."""
    rng = np.random.default_rng(seed)
    mut.upsert(_blobs(rng, 4), np.array([2, 3, 1600, 1601]))
    mut.delete(np.array([3, 10, 11]))
    mut.rebalance()
    mut.upsert(_blobs(rng, 2), np.array([3, 1602]))
    mut.delete(np.array([1600]))


@pytest.mark.parametrize("kind", KINDS)
def test_mutator_cold_resume(tmp_path, data, jax_indexes, kind):
    _, q = data
    mut = tm.Mutator(str(tmp_path / "m"), _port(jax_indexes, kind), ckpt_every=3, slack=8)
    _scripted(mut)
    assert mut.applied == 5 and mut.index.mut_cursor == 3  # the rebalance committed
    again = tm.Mutator(str(tmp_path / "m"), kind=kind, slack=8, device="cpu")
    assert again.applied == mut.applied and again.index.device.type == "cpu"
    for f in ("slot_rows", "list_sizes", "source_ids"):
        assert torch.equal(getattr(again.index, f), getattr(mut.index, f)), f
    assert torch.equal(again.index.tombstones, mut.index.tombstones)
    want, got = _tsearch(kind, mut.index, q), _tsearch(kind, again.index, q)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_array_equal(_bits(got[0]), _bits(want[0]))
    # superseded payloads are swept at each commit
    assert sorted(os.listdir(tmp_path / "m")) == ["index.ckpt", "mut_000003.ckpt",
                                                  "mut_000004.ckpt", "mutlog.jsonl"]


def test_mutator_reissued_sequence_dedupes(tmp_path, data, jax_indexes):
    _, q = data
    idx = _port(jax_indexes, "ivf_flat")
    mut = tm.Mutator(str(tmp_path / "m"), idx, ckpt_every=2, slack=8)
    _scripted(mut)
    mut.commit()
    again = tm.Mutator(str(tmp_path / "m"), idx, ckpt_every=2, slack=8)
    _scripted(again)  # every call dedupes by seq
    assert again.applied == mut.applied == 5
    np.testing.assert_array_equal(_tsearch("ivf_flat", again.index, q)[1],
                                  _tsearch("ivf_flat", mut.index, q)[1])
    assert len(tm.MutationLog(str(tmp_path / "m")).entries()) == 5


def test_mutator_refuses_externally_truncated_log(tmp_path, jax_indexes):
    mut = tm.Mutator(str(tmp_path / "m"), _port(jax_indexes, "ivf_flat"), ckpt_every=1)
    mut.delete(np.array([1]))
    mut.delete(np.array([2]))
    os.remove(mut.log.path)
    with pytest.raises(tm.MutationLogError, match="truncated"):
        tm.Mutator(str(tmp_path / "m"), kind="ivf_flat", device="cpu")


def test_mutator_requires_index_or_checkpoint(tmp_path, jax_indexes):
    with pytest.raises(ValueError, match="checkpoint"):
        tm.Mutator(str(tmp_path / "m"), kind="ivf_flat")
    # retain= keeps point-in-time snapshots (tests/test_torch_integrity.py)
    mut = tm.Mutator(str(tmp_path / "r"), _port(jax_indexes, "ivf_flat"), retain=2)
    mut.delete(np.array([1]))
    mut.commit()
    assert mut.retain == 2 and os.path.exists(str(tmp_path / "r" / "pitr_000001.ckpt"))


@pytest.mark.parametrize("kind", KINDS)
def test_jax_mutator_directory_resumes_in_the_port(tmp_path, jax_indexes, kind):
    """The JAX Mutator's directory (its commits carry a digest sidecar)
    resumes in the port: the checkpoint loads with its sidecar, and the
    log's tail replays to the JAX tables and the JAX sidecar."""
    from raft_tpu.core.serialize import deserialize_arrays
    from raft_tpu_torch.integrity import digest

    root = str(tmp_path / "m")
    jmut = jm.Mutator(root, jax_indexes[kind], ckpt_every=3, slack=8)
    _scripted(jmut)
    arrays, _ = deserialize_arrays(os.path.join(root, "index.ckpt"), to_device=False)
    assert "list_digests" in arrays
    tmut = tm.Mutator(root, kind=kind, slack=8, device="cpu")
    assert tmut.applied == jmut.applied == 5 and tmut.index.mut_cursor == 3  # 2 replayed
    assert sorted(tmut.index.list_digests) == sorted(jmut.index.list_digests)
    for f, d in jmut.index.list_digests.items():
        np.testing.assert_array_equal(tmut.index.list_digests[f], np.asarray(d), f)
    assert tmut.index.table_digests == {f: int(v) for f, v in jmut.index.table_digests.items()}
    digest.check_fresh(tmut.index)
    _same_state(kind, jmut.index, tmut.index)


def test_feed_and_apply_batch(data, jax_indexes):
    _, q = data
    idx = _port(jax_indexes, "ivf_flat")
    feed = tm.MutationFeed()
    with pytest.raises(ValueError, match="unknown"):
        feed.publish(("drop_table",))
    far = (_blobs(np.random.default_rng(3), 1) + 40.0).astype(np.float32)
    feed.publish(("upsert", far, np.array([3])))
    feed.publish(("delete", np.array([5])))
    feed.publish(("rebalance",))
    live = idx
    for batch in feed.drain():
        live = tm.apply_batch(live, batch)
    assert feed.drain() == []
    assert live.tombstones is None and tm.live_rows(live) == N - 1
    _, ids = _tsearch("ivf_flat", live, far)
    assert ids[0, 0] == 3
    assert not np.isin(_tsearch("ivf_flat", live, q)[1], [5]).any()
    with pytest.raises(ValueError, match="unknown mutation op"):
        tm.apply_batch(live, ("drop_table",))
    assert idx.tombstones is None  # the feed's batches left the first index as it was
