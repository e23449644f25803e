"""PyTorch port: integrity of the live index (raft_tpu_torch/integrity)
against the JAX package (raft_tpu/integrity).

Indexes: 1200 x 32 blob rows, 8 lists. JAX indexes are built by the JAX
package and carried into the port with `index_from_arrays` where both
must hold one identical index; the port's own builds serve the
port-to-JAX direction.

- Digests: the port's `compute` over a JAX-saved index loaded into the
  port equals the JAX sidecar (and JAX `compute`), for all three kinds.
- The sidecar crosses over both ways: JAX save -> port load ->
  `check_fresh` with the JAX sidecar, and port build + mutation -> port
  save -> JAX load -> JAX `check_fresh`, for all three kinds.
- `refresh` after extend, delete, upsert, compact and rebalance hashes
  again only the rows the op touched (the calls are counted: payload rows
  only where `slot_rows` changed, the whole sidecar only on a change of
  geometry) and leaves a fresh sidecar; an append copies only its new
  slots and `source_ids`' tail, and rot in a touched list stays named.
- Rot is named as the exact (field, list) pair, tables as list -1;
  `maybe_rot` picks the JAX victims for the same plan and rots the same
  bytes; the scrubber's cursor, laps and counters; a sidecar-less index
  gets one at the scrubber's first contact.
- Quarantine searches bit for bit like `mutation.delete(twin, ids of the
  list)` on every family (fused engines and one other each), with no id
  of the list; it is a clone; the watchdog quarantines, then repairs from
  the mutation root's checkpoint (coverage < 1.0, then 1.0, the search
  bit for bit the one before the rot); a failed repair keeps the
  quarantine.
- PITR: `Mutator(retain=K)` keeps the K newest snapshots and payloads
  from the oldest retained cursor; `restore(root, seq, out=...)` forced
  to replay writes the crash-free commit checkpoint byte for byte; a
  rotted base falls back to an older one; an out-of-range seq is refused.
- The lane-pad repair: after the port's fused IVF-Flat search widens the
  store (tombstones too), `full_scan` is [], a list rotted before the pad
  is still flagged after it, and the saved padded index passes the JAX
  `check_fresh`; the JAX reference, after its own fused
  search, flags every list of `list_data` and `slot_rows` (16 of 8
  lists), the reference fault the port does not copy.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest

import torch

from raft_tpu.core import faults as jfaults
from raft_tpu.integrity import digest as jdg
from raft_tpu.integrity import scrub as jscrub
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import ivf_rabitq as jrb
from raft_tpu.neighbors import mutation as jm
import raft_tpu_torch.integrity as integrity
from raft_tpu_torch.core import faults as tfaults
from raft_tpu_torch.integrity import digest, scrub, watchdog
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import ivf_rabitq as trb
from raft_tpu_torch.neighbors import mutation as tm

N, DIM, N_LISTS, NQ, K = 1200, 32, 8, 16, 10
SEED = 1234
KINDS = ("ivf_flat", "ivf_pq", "ivf_rabitq")
TMOD = {"ivf_flat": tfl, "ivf_pq": tpq, "ivf_rabitq": trb}
JMOD = {"ivf_flat": jfl, "ivf_pq": jpq, "ivf_rabitq": jrb}
PAYLOAD = {"ivf_flat": "list_data", "ivf_pq": "codes", "ivf_rabitq": "codes"}
#: the engines each family's quarantine is searched on
ENGINES = {"ivf_flat": ({"engine": "fused"}, {"engine": "query"}),
           "ivf_pq": ({"trim_engine": "fused"}, {"score_mode": "lut"}),
           "ivf_rabitq": ({"scan_engine": "fused"}, {"scan_engine": "xla"})}
CENTERS = np.random.default_rng(31).uniform(-5, 5, (N_LISTS, DIM)).astype(np.float32)


def _blobs(rng, n):
    return (CENTERS[rng.integers(0, N_LISTS, n)] + rng.standard_normal((n, DIM))).astype(np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(32)
    x = _blobs(rng, N)
    q = (x[rng.choice(N, NQ, replace=False)]
         + 0.1 * rng.standard_normal((NQ, DIM))).astype(np.float32)
    return x, q


def _tparams(kind):
    if kind == "ivf_flat":
        return tfl.IndexParams(n_lists=N_LISTS, kmeans_n_iters=3)
    if kind == "ivf_pq":
        return tpq.IndexParams(n_lists=N_LISTS, pq_dim=8, kmeans_n_iters=3)
    return trb.IndexParams(n_lists=N_LISTS, kmeans_n_iters=3, store_dataset=False)


def _jbuild(kind, x):
    if kind == "ivf_flat":
        return jfl.build(jfl.IndexParams(n_lists=N_LISTS, kmeans_n_iters=3), x)
    if kind == "ivf_pq":
        return jpq.build(jpq.IndexParams(n_lists=N_LISTS, pq_dim=8, kmeans_n_iters=3,
                                         kmeans_trainset_fraction=1.0), x)
    return jrb.build(jrb.IndexParams(n_lists=N_LISTS, kmeans_n_iters=3, store_dataset=False), x)


@pytest.fixture(scope="module")
def jax_indexes(data):
    x, _ = data
    return {kind: _jbuild(kind, x) for kind in KINDS}


@pytest.fixture(scope="module")
def port_indexes(data):
    x, _ = data
    return {kind: TMOD[kind].build(_tparams(kind), x, device="cpu") for kind in KINDS}


def _carry(kind, jidx):
    """The JAX index's tables as a port index (no sidecar: attach one)."""
    mod = TMOD[kind]
    arrays = {f: np.asarray(getattr(jidx, f)) for f in mod.INDEX_FIELDS}
    if kind != "ivf_rabitq":
        arrays["list_radii"] = np.asarray(jidx.list_radii)
    params = {"ivf_flat": tfl.IndexParams(n_lists=N_LISTS),
              "ivf_pq": tpq.IndexParams(n_lists=N_LISTS, pq_dim=8),
              "ivf_rabitq": trb.IndexParams(n_lists=N_LISTS, store_dataset=False)}[kind]
    idx = mod.index_from_arrays(arrays, params, device="cpu")
    digest.attach(idx)
    return idx


def _same_sidecar(lists, tables, jlists, jtables):
    assert sorted(lists) == sorted(jlists)
    for f, d in jlists.items():
        np.testing.assert_array_equal(np.asarray(lists[f]), np.asarray(d), f)
    assert {f: int(v) for f, v in tables.items()} == {f: int(v) for f, v in jtables.items()}


def _search(kind, idx, q, k=K, **over):
    mod = TMOD[kind]
    v, i = mod.search(mod.SearchParams(n_probes=4, **over), idx, torch.from_numpy(q), k)
    return v, i


def _members(idx, lid):
    rows = idx.slot_rows[int(lid)]
    return idx.source_ids[rows[rows >= 0].long()].numpy()


# -- digests and the sidecar across the packages --------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_digests_equal_the_jax_sidecar(tmp_path, data, jax_indexes, kind):
    jidx = jm.delete(jax_indexes[kind], np.arange(0, 60, 7))  # tombstones digested too
    path = str(tmp_path / "j.ckpt")
    JMOD[kind].save(path, jidx)
    tidx = TMOD[kind].load(path, device="cpu")
    lists, tables = digest.compute(tidx)
    _same_sidecar(lists, tables, jidx.list_digests, jidx.table_digests)
    _same_sidecar(lists, tables, *jdg.compute(jidx, kind))
    _same_sidecar(tidx.list_digests, tidx.table_digests, jidx.list_digests, jidx.table_digests)
    digest.check_fresh(tidx)  # JAX save -> port load -> check_fresh


@pytest.mark.parametrize("kind", KINDS)
def test_port_sidecar_passes_jax_check_fresh(tmp_path, data, port_indexes, kind):
    x, _ = data
    idx = port_indexes[kind]
    digest.check_fresh(idx)
    idx = tm.ensure_append_slack(tm.delete(idx, np.arange(0, 90, 4)), 40)
    idx = tm.upsert(idx, _blobs(np.random.default_rng(2), 9), np.arange(3, 12))
    digest.check_fresh(idx)
    path = str(tmp_path / "t.ckpt")
    TMOD[kind].save(path, idx)
    jidx = JMOD[kind].load(path)
    _same_sidecar(jidx.list_digests, jidx.table_digests, idx.list_digests, idx.table_digests)
    jdg.check_fresh(jidx, kind)  # port save -> JAX load -> JAX check_fresh
    back = TMOD[kind].load(path, device="cpu")
    _same_sidecar(back.list_digests, back.table_digests, idx.list_digests, idx.table_digests)
    digest.check_fresh(back)


def test_kind_of_and_the_packed_sidecar(port_indexes):
    for kind, idx in port_indexes.items():
        assert digest.kind_of(idx) == kind
        packed = digest.pack_lists(idx, kind)
        assert packed.dtype == np.uint32 and packed.shape[1] == N_LISTS
        clone = tm._clone(idx)
        digest.unpack_lists(clone, kind, packed, idx.table_digests)
        _same_sidecar(clone.list_digests, clone.table_digests, idx.list_digests,
                      idx.table_digests)
        digest.unpack_lists(clone, kind, packed[:1], idx.table_digests)  # a foreign layout
        assert clone.list_digests is None and clone.table_digests is None
    with pytest.raises(TypeError):
        digest.kind_of(object())


# -- refresh: only the touched rows ----------------------------------------

def _ops(kind, rng):
    up = _blobs(rng, 5)
    ops = {
        "delete": lambda i: tm.delete(i, np.arange(10, 40, 3)),
        "upsert": lambda i: tm.upsert(i, up, np.arange(50, 55)),
        "extend": lambda i: TMOD[kind].extend(i, torch.from_numpy(up),
                                              torch.arange(N, N + 5, dtype=torch.int32)),
        "compact": lambda i: tm.compact(tm.delete(i, np.arange(0, 30)), slack=i.append_slack),
        "rebalance": lambda i: tm.rebalance(tm.delete(i, np.arange(0, 30)))[0],
    }
    return ops


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("op", ["delete", "upsert", "extend", "compact", "rebalance"])
def test_refresh_hashes_only_the_touched_rows(monkeypatch, data, port_indexes, kind, op):
    ops = _ops(kind, np.random.default_rng(4))
    base = tm.ensure_append_slack(port_indexes[kind], 64)  # appends keep the geometry
    calls = []

    def counted(real):
        def wrapped(field, *args):  # the rows come last in both
            calls.append((field, sorted(int(r) for r in args[-1])))
            return real(field, *args)
        return wrapped

    for name in ("_row_digests", "_patched_digests"):
        monkeypatch.setattr(digest, name, counted(getattr(digest, name)))
    out = ops[op](base)
    monkeypatch.undo()
    digest.check_fresh(out)
    if tuple(out.slot_rows.shape) == tuple(base.slot_rows.shape):
        want = sorted(torch.nonzero((out.slot_rows != base.slot_rows).any(dim=1))
                      .reshape(-1).tolist())
    else:
        want = list(range(N_LISTS))  # a change of geometry hashes everything
    payload = [rows for f, rows in calls if f == PAYLOAD[kind] and rows]
    if op == "delete":
        assert want == [] and payload == []  # only the mask rows hash again
        assert {f for f, rows in calls if rows} == {"tombstones"}
    else:
        assert payload == [want] and want, (payload, want)
    if op in ("upsert", "extend"):
        assert len(want) < N_LISTS  # five rows touch a few lists, not the store
    for field, rows in calls:
        if field != "tombstones":
            assert rows in ([], want), (field, rows, want)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("slack", [64, 0])
def test_refresh_copies_only_the_changed_slots(monkeypatch, port_indexes, kind, slack):
    """An append's refresh reads each touched row's new tail slots, not
    the row, and extends `source_ids`' digest over its new tail; without
    slack the append widens the store and every row is patched so."""
    base = tm.ensure_append_slack(port_indexes[kind], slack)
    n_up = 5 if slack else 300
    copied, hashed = [], []
    real_patch, real_crc = digest.crc32c_patch, digest.crc32c

    def patch(crcs, diff, tail_bytes):
        # the rows' bytes from the first nonzero column: their zero lead
        # (a pad to whole CRC blocks) holds no table bytes
        cols = np.flatnonzero(diff.any(axis=0))
        copied.append(diff.shape[0] * (diff.shape[1] - cols[0]) if cols.size else 0)
        return real_patch(crcs, diff, tail_bytes)

    def crc(data, c=0):
        hashed.append(len(memoryview(data).cast("B")))
        return real_crc(data, c)

    monkeypatch.setattr(digest, "crc32c_patch", patch)
    monkeypatch.setattr(digest, "crc32c", crc)
    out = tm.upsert(base, _blobs(np.random.default_rng(4), n_up), np.arange(N, N + n_up))
    monkeypatch.undo()
    digest.check_fresh(out)
    if slack:
        touched = torch.nonzero((out.slot_rows != base.slot_rows).any(dim=1)).reshape(-1)
    else:
        assert out.slot_rows.shape[1] > base.slot_rows.shape[1]  # the store grew
        touched = torch.arange(N_LISTS)
    row_bytes = sum(getattr(out, f)[0].numel() * getattr(out, f).element_size()
                    for f, g in digest.DIGEST_FIELDS[kind].items() if g == "list" and f != "tombstones")
    # 5 rows fill a sliver of a row; 300 fill a quarter of the store
    share = 4 if slack else 2
    assert 0 < sum(copied) < len(touched) * row_bytes / share, (copied, len(touched), row_bytes)
    assert int(out.source_ids.numel()) * 4 not in hashed  # extended, not hashed whole


def test_refresh_keeps_rot_in_a_touched_list(port_indexes):
    """Rot in a list that a later upsert appends to is still named: the
    refresh patches the stored digest instead of hashing the rot in."""
    base = tm.ensure_append_slack(port_indexes["ivf_flat"], 64)
    up = _blobs(np.random.default_rng(4), 5)
    probe = tm.upsert(base, up, np.arange(N, N + 5))
    lid = int(torch.nonzero((probe.slot_rows != base.slot_rows).any(dim=1))[0])
    rotted = tm._clone(base)
    scrub.rot_list(rotted, lid, "list_data", frac=0.25, seed=SEED)
    out = tm.upsert(rotted, up, np.arange(N, N + 5))
    assert scrub.Scrubber("ivf_flat").full_scan(out) == [("list_data", lid)]


def test_refresh_of_a_legacy_index_is_a_no_op(port_indexes):
    legacy = tm._clone(port_indexes["ivf_flat"])
    legacy.list_digests = legacy.table_digests = None
    out = tm.delete(legacy, [1, 2])
    assert out.list_digests is None and out.table_digests is None


# -- detection -------------------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_rot_named_as_exact_pair(port_indexes, kind):
    idx = tm._clone(port_indexes[kind])
    before = getattr(idx, PAYLOAD[kind])
    scrub.rot_list(idx, 5, PAYLOAD[kind], frac=0.25, seed=SEED)
    assert getattr(port_indexes[kind], PAYLOAD[kind]) is before  # the table was replaced
    sc = scrub.Scrubber(kind, budget_lists=3)
    assert sc.full_scan(idx) == [(PAYLOAD[kind], 5)]
    assert sc.mismatches == 1 and sc.laps == 1 and sc.lists_scanned == N_LISTS
    if kind == "ivf_rabitq":
        other = tm._clone(port_indexes[kind])
        scrub.rot_list(other, 2, "aux", frac=0.5, seed=SEED)
        assert scrub.Scrubber().full_scan(other) == [("aux", 2)]


def test_slot_and_table_rot_detected(port_indexes):
    idx = tm._clone(port_indexes["ivf_flat"])
    scrub.rot_list(idx, 2, "slot_rows", frac=0.5, seed=SEED)
    assert ("slot_rows", 2) in scrub.Scrubber("ivf_flat").full_scan(idx)
    idx = tm._clone(port_indexes["ivf_flat"])
    idx.centers = idx.centers.clone()
    idx.centers[0, 0] += 0.5
    assert scrub.Scrubber("ivf_flat").full_scan(idx) == [("centers", -1)]


def test_scrubber_slices_and_cursor(port_indexes):
    idx = port_indexes["ivf_pq"]
    sc = scrub.Scrubber(budget_lists=3)
    assert [sc.slice_scan(idx) for _ in range(3)] == [[], [], []]
    assert sc.cursor == 0 and sc.laps == 1 and sc.lists_scanned == N_LISTS
    assert sc.slice_scan(idx, skip=[0, 1]) == [] and sc.cursor == 3
    with pytest.raises(ValueError):
        scrub.Scrubber(budget_lists=0)


def test_legacy_index_attaches_on_first_contact(port_indexes):
    legacy = tm._clone(port_indexes["ivf_flat"])
    legacy.list_digests = legacy.table_digests = None
    sc = scrub.Scrubber("ivf_flat", budget_lists=4)
    assert sc.slice_scan(legacy) == [] and legacy.list_digests is not None
    assert sc.full_scan(legacy) == []


@pytest.mark.parametrize("kind", KINDS)
def test_maybe_rot_victims_and_bytes_match_jax(jax_indexes, kind):
    f = dict(kind="corrupt_shard", site="integrity.table.rot", count=3, fraction=0.3)
    jidx = jm._clone(jax_indexes[kind])
    tidx = _carry(kind, jidx)
    with jfaults.FaultPlan([jfaults.Fault(**f)], seed=SEED).install():
        jv = jscrub.maybe_rot(jidx, kind, salt=2)
    with tfaults.FaultPlan([tfaults.Fault(**f)], seed=SEED).install():
        tv = scrub.maybe_rot(tidx, kind, salt=2)
    assert tv == jv and len(tv) == 3
    for field in {fld for fld, _ in tv}:
        got = getattr(tidx, field).numpy()
        want = np.asarray(getattr(jidx, field))
        np.testing.assert_array_equal(got.view(np.uint8), want.view(np.uint8), field)
    assert set(scrub.Scrubber(kind).full_scan(tidx)) == set(tv)
    assert scrub.maybe_rot(tidx, kind) == []  # no plan installed


# -- quarantine and repair --------------------------------------------------

@pytest.mark.parametrize("kind", KINDS)
def test_quarantine_bit_identical_to_delete(data, port_indexes, kind):
    _, q = data
    lid = int(np.random.default_rng(SEED).integers(N_LISTS))
    twin = port_indexes[kind]
    rotted = tm._clone(twin)
    victims = _members(rotted, lid)
    scrub.rot_list(rotted, lid, PAYLOAD[kind], frac=1.0, seed=SEED)
    quarantined = watchdog.quarantine(rotted, lid, kind)
    assert quarantined is not rotted and rotted.tombstones is None
    reference = tm.delete(twin, victims)
    for over in ENGINES[kind]:
        qv, qi = _search(kind, quarantined, q, **over)
        rv, ri = _search(kind, reference, q, **over)
        assert torch.equal(qi, ri), over
        assert torch.equal(qv.view(torch.int32), rv.view(torch.int32)), over
        assert not np.isin(qi.numpy(), victims).any()
    # the payload digests of the list stay stale on purpose; the mask's are fresh
    assert scrub.Scrubber(kind).full_scan(quarantined) == [(PAYLOAD[kind], lid)]
    assert scrub.Scrubber(kind).full_scan(quarantined, skip=[lid]) == []


def _served(tmp_path, idx):
    mut = tm.Mutator(str(tmp_path / "mut"), idx)
    mut.delete(_members(idx, 0)[:1])  # a committed checkpoint to repair from
    mut.commit()
    return mut


def test_watchdog_quarantines_then_repairs_from_checkpoint(tmp_path, data, port_indexes):
    _, q = data
    mut = _served(tmp_path, port_indexes["ivf_flat"])
    idx = mut.index
    pre_v, pre_i = _search("ivf_flat", idx, q, engine="fused")
    victims = _members(idx, 4)
    served = tm._clone(idx)
    scrub.rot_list(served, 4, "list_data", frac=1.0, seed=SEED)
    wd = integrity.IntegrityWatchdog("ivf_flat", budget_lists=3)
    for _ in range(3):  # one lap of 8 lists in 3-list slices
        served = wd.step(served)
    assert wd.quarantined == {4} and 0.0 < wd.coverage() < 1.0
    assert not np.isin(_search("ivf_flat", served, q, engine="fused")[1].numpy(), victims).any()
    wd.repair = integrity.checkpoint_repairer(str(tmp_path / "mut"))
    served = wd.step(served)
    assert wd.repairs == 1 and not wd.quarantined and wd.coverage() == 1.0
    post_v, post_i = _search("ivf_flat", served, q, engine="fused")
    assert torch.equal(post_i, pre_i) and torch.equal(post_v, pre_v)


def test_failed_repair_keeps_quarantine(port_indexes):
    idx = tm._clone(port_indexes["ivf_pq"])
    scrub.rot_list(idx, 1, "codes", frac=1.0, seed=SEED)

    def broken(_idx):
        raise RuntimeError("no checkpoint")

    wd = integrity.IntegrityWatchdog("ivf_pq", budget_lists=8, repair=broken)
    idx = wd.step(idx)
    assert wd.quarantined == {1} and wd.failed_repairs == 1 and wd.repairs == 0
    assert wd.coverage() < 1.0
    # a repair that comes back rotted is refused as well
    wd.repair = lambda _idx: idx
    wd.step(idx)
    assert wd.quarantined == {1} and wd.failed_repairs == 2


# -- point-in-time recovery -------------------------------------------------

def _churn(mut, seed=11, rounds=6):
    rng = np.random.default_rng(seed)
    for r in range(rounds):
        if r == 3:
            mut.rebalance()
        elif r % 2 == 0:
            mut.upsert(_blobs(rng, 3), np.array([r, r + 20, 1500 + r]))
        else:
            mut.delete(np.array([r, r + 8]))


def test_pitr_snapshots_retention_and_sweep(tmp_path, port_indexes):
    root = str(tmp_path / "mut")
    mut = tm.Mutator(root, port_indexes["ivf_flat"], ckpt_every=2, retain=2, slack=8)
    _churn(mut)
    mut.commit()
    cursors = [c for c, _ in integrity.retained(root)]
    assert len(cursors) == 2 and cursors[-1] == mut.applied
    floor = min(cursors)
    entries = mut.log.entries()
    for seq in range(mut.applied):
        kept = os.path.exists(mut.log.payload_path(seq))
        assert kept == (seq >= floor and entries[seq]["op"] != "rebalance"), seq
    assert integrity.prune(root, keep=1) == [cursors[-1]]
    assert integrity.snapshot_path(root, 7).endswith("pitr_000007.ckpt")


@pytest.mark.parametrize("kind", ["ivf_flat", "ivf_pq"])
def test_pitr_restore_byte_identical_to_crash_free(tmp_path, port_indexes, kind):
    root = str(tmp_path / "mut")
    mut = tm.Mutator(root, port_indexes[kind], ckpt_every=2, retain=10, slack=8)
    _churn(mut)
    mut.commit()
    snaps = dict(integrity.retained(root))
    assert len(snaps) >= 3
    out = str(tmp_path / "restored.ckpt")
    for target in sorted(snaps)[1:]:
        restored, out_path = integrity.restore(root, target, out=out,
                                               base_cursor=sorted(snaps)[0], device="cpu")
        assert out_path == out and int(restored.mut_cursor) == target
        digest.check_fresh(restored)
        with open(out, "rb") as fa, open(snaps[target], "rb") as fb:
            assert fa.read() == fb.read(), f"restore to {target} is not byte-identical"
    full, _ = integrity.restore(root, device="cpu")  # the log's committed length
    assert int(full.mut_cursor) == mut.applied


def test_restore_falls_back_past_a_rotted_base(tmp_path, port_indexes):
    root = str(tmp_path / "mut")
    mut = tm.Mutator(root, port_indexes["ivf_flat"], ckpt_every=2, retain=10, slack=8)
    _churn(mut)
    mut.commit()
    snaps = dict(integrity.retained(root))
    target = sorted(snaps)[-2]
    clean, _ = integrity.restore(root, target, device="cpu")
    with open(snaps[target], "r+b") as fh:  # mid-file byte flips
        fh.seek(os.path.getsize(snaps[target]) // 2)
        buf = bytearray(fh.read(8))
        fh.seek(-len(buf), os.SEEK_CUR)
        fh.write(bytes(b ^ 0xFF for b in buf))
    with pytest.raises(digest.IntegrityError, match="failed to load/verify"):
        integrity.restore(root, target, base_cursor=target, device="cpu")
    restored, _ = integrity.restore(root, target, device="cpu")  # an older base replays
    assert int(restored.mut_cursor) == target
    assert torch.equal(restored.list_data, clean.list_data)
    assert torch.equal(restored.slot_rows, clean.slot_rows)


def test_restore_rejects_out_of_range_seq(tmp_path, port_indexes):
    root = str(tmp_path / "mut")
    mut = tm.Mutator(root, port_indexes["ivf_flat"])
    mut.delete(np.array([1]))
    mut.commit()
    with pytest.raises(digest.IntegrityError, match="outside"):
        integrity.restore(root, 99, device="cpu")
    with pytest.raises(digest.IntegrityError, match="no base"):
        integrity.restore(root, 0, base_cursor=5, device="cpu")
    assert integrity.retained(root) == []


# -- the lane-pad repair ------------------------------------------------------

def test_lane_pad_repair(tmp_path, data, jax_indexes):
    _, q = data
    jidx = jax_indexes["ivf_flat"]
    width = int(jidx.list_data.shape[1])
    assert width % 128, "the drill needs a store narrower than the lane multiple"
    tidx = tm.delete(_carry("ivf_flat", jidx), np.arange(0, 40, 5))
    rotted = tm._clone(tidx)
    scrub.rot_list(rotted, 2, "list_data", frac=0.2, seed=SEED)
    for idx in (tidx, rotted):
        _search("ivf_flat", idx, q, engine="fused")  # pads the store in place
        assert idx.list_data.shape[1] % 128 == 0 and idx.list_data.shape[1] > width
        assert idx.tombstones.shape == idx.slot_rows.shape
    assert scrub.Scrubber("ivf_flat").full_scan(tidx) == []
    assert scrub.Scrubber("ivf_flat").full_scan(rotted) == [("list_data", 2)]
    digest.check_fresh(tm.delete(tidx, [50]))  # mutation after the pad: still fresh
    path = str(tmp_path / "padded.ckpt")  # the extended digests hold in the JAX package
    tfl.save(path, tidx)
    jdg.check_fresh(jfl.load(path), "ivf_flat")
    # the JAX reference: its lane pad leaves the sidecar at the old width
    j = jm._clone(jidx)
    assert jscrub.Scrubber("ivf_flat").full_scan(j) == []
    jfl.search(jfl.SearchParams(n_probes=4, engine="pallas"), j, jnp.asarray(q), K)
    bad = jscrub.Scrubber("ivf_flat").full_scan(j)
    assert sorted(bad) == sorted((f, i) for f in ("list_data", "slot_rows")
                                 for i in range(N_LISTS))
