"""PyTorch port: core/serialize and the three indexes' save/load against
the JAX package.

- `crc32c` equals the JAX `crc32c` on buffers of 0 to ~70 KB (unaligned
  lengths, across the 1024-byte block edge, chained), and the RFC 3720
  check value of b"123456789" is 0xE3069283.
- `serialize_arrays` to a stream writes the JAX writer's bytes for the
  dtypes the indexes write (u8, i32, f32, u32), an empty array and a 0-d
  array (written as shape [1], as numpy's `ascontiguousarray` makes it in
  both); each package reads the other's stream; `peek_meta`,
  `container_data_start` and `field_byte_range` agree.
- `read_ckpt`'s gates raise what the JAX gates raise
  (tests/test_ckpt_schema.py): wrong kind, a newer version, a missing
  required field, missing required meta, a corrupt optional field
  (dropped), a corrupt required field (`ChecksumError` naming it).
- The five legacy goldens (tests/goldens/legacy_*.ckpt) load in the port
  with the declared defaults: radii None where the file has none (never
  derived), every row live, cursor and slack 0.
- Each family, both ways: a JAX-saved index loads in the port and
  searches as the JAX index does (IVF-Flat "query" ids equal, values to
  1e-5 of the row's scale; IVF-PQ bf16 "exact" trim and RaBitQ "xla" bit
  for bit, RaBitQ on a signed-permutation rotation); a port-saved mutated
  index loads in JAX with every array equal bit for bit, tombstones,
  list_radii, mut_cursor and append_slack included, and the file is
  byte-identical to the JAX save of the same arrays.
- A JAX file with a digest sidecar loads in the port with that sidecar;
  a rotted sidecar field is dropped (the index still loads), and the
  port writes the sidecar it holds.
- `atomic_write` leaves the old file whole when the write raises.
"""

import copy
import io
import os

import jax.numpy as jnp
import numpy as np
import pytest

import torch

from raft_tpu.core import serialize as js
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import ivf_rabitq as jrb
from raft_tpu_torch.core import serialize as ts
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import ivf_rabitq as trb
from raft_tpu_torch.neighbors import mutation as tm

GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
N, DIM, N_LISTS, NQ, K = 900, 32, 8, 16, 10
KINDS = ("ivf_flat", "ivf_pq", "ivf_rabitq")
TMOD = {"ivf_flat": tfl, "ivf_pq": tpq, "ivf_rabitq": trb}
JMOD = {"ivf_flat": jfl, "ivf_pq": jpq, "ivf_rabitq": jrb}
PARITY = {"ivf_flat": dict(n_probes=4, engine="query"),
          "ivf_pq": dict(n_probes=4, score_mode="recon8_list", trim_engine="exact",
                         internal_distance_dtype="bfloat16"),
          "ivf_rabitq": dict(n_probes=4, scan_engine="xla")}


@pytest.mark.parametrize("n", [0, 1, 7, 9, 1023, 1024, 1025, 4101, 70001])
def test_crc32c_matches_jax(n):
    buf = np.random.default_rng(n).integers(0, 256, n, dtype=np.uint8).tobytes()
    assert ts.crc32c(buf) == js.crc32c(buf)
    assert ts.crc32c(buf, 0xDEADBEEF) == js.crc32c(buf, 0xDEADBEEF)
    half = n // 2
    assert ts.crc32c(buf[half:], ts.crc32c(buf[:half])) == js.crc32c(buf)


def test_crc32c_check_value():
    assert ts.crc32c(b"123456789") == 0xE3069283
    assert ts.crc32c(np.frombuffer(b"123456789", np.uint8)) == 0xE3069283


def _arrays():
    rng = np.random.default_rng(3)
    return {"u8": rng.integers(0, 256, (3, 5, 7), dtype=np.uint8),
            "i32": rng.integers(-9, 9, (4, 33), dtype=np.int32),
            "f32": rng.standard_normal((130, 9)).astype(np.float32),
            "u32": rng.integers(0, 2 ** 32, (6,), dtype=np.uint32),
            "empty": np.zeros((0, 4), np.float32),
            "scalar": np.array(7, np.int32)}


def test_serialize_arrays_writes_the_jax_bytes():
    arrays, meta = _arrays(), {"kind": "test", "version": 1, "n": 3, "name": "x"}
    jbuf, tbuf = io.BytesIO(), io.BytesIO()
    js.serialize_arrays(jbuf, arrays, meta)
    ts.serialize_arrays(tbuf, {k: (torch.tensor(v) if v.dtype != np.uint32 else v)
                               for k, v in arrays.items()}, meta)
    assert tbuf.getvalue() == jbuf.getvalue()
    for buf, reader in ((jbuf, "port"), (tbuf, "jax")):
        buf.seek(0)
        if reader == "port":
            got, got_meta = ts.deserialize_arrays(buf, device="cpu")
            got = {k: v.numpy() for k, v in got.items()}
        else:
            got, got_meta = js.deserialize_arrays(buf, to_device=False)
        assert got_meta == meta
        for name, a in arrays.items():
            np.testing.assert_array_equal(got[name], a.reshape(-1) if a.ndim == 0 else a)
            assert got[name].dtype == a.dtype
    tbuf.seek(0)
    host, _ = ts.deserialize_arrays(tbuf, to_device=False)
    assert isinstance(host["f32"], np.ndarray)
    for probe in (ts.peek_meta, ts.container_data_start):
        jbuf.seek(0)
        a = probe(jbuf)
        jbuf.seek(0)
        assert a == (js.peek_meta if probe is ts.peek_meta else js.container_data_start)(jbuf)
    jbuf.seek(0)
    rng_t = ts.field_byte_range(jbuf, "f32")
    jbuf.seek(0)
    assert rng_t == js.field_byte_range(jbuf, "f32")


def _write(path, arrays, meta):
    js.serialize_arrays(path, arrays, meta)
    return path


def _flip(path, start, end):
    with open(path, "r+b") as fh:
        fh.seek(start)
        blk = fh.read(end - start)
        fh.seek(start)
        fh.write(bytes(b ^ 0xFF for b in blk))


_PQ_ARRAYS = ("rotation", "centers", "pq_centers", "codes", "slot_rows", "list_sizes",
              "source_ids")
_FLAT_META = {"kind": "ivf_flat", "version": 4, "metric": 0, "n_lists": 2}


def _gate_case(tmp_path, gate):
    """(path, kind, what the read must do) of one `read_ckpt` gate."""
    p = str(tmp_path / f"{gate}.ckpt")
    flat = {f: np.zeros((2, 2), np.float32) for f in
            ("centers", "list_data", "slot_rows", "list_sizes", "source_ids")}
    if gate == "wrong_kind":
        return _write(p, flat, _FLAT_META), "ivf_pq", "not a ivf_pq container"
    if gate == "newer_version":
        return _write(p, flat, dict(_FLAT_META, version=99)), "ivf_flat", "newer than the library"
    if gate == "missing_field":
        return (_write(p, {"centers": flat["centers"]}, _FLAT_META), "ivf_flat",
                "missing required")
    if gate == "missing_meta":
        return (_write(p, {f: np.zeros((2, 2), np.float32) for f in _PQ_ARRAYS},
                       {"kind": "ivf_pq", "version": 1, "metric": 0, "n_lists": 2,
                        "codebook_kind": "per_subspace"}), "ivf_pq",
                r"missing required field\(s\) \['pq_bits'\]")
    arrays = dict(flat, list_radii=np.ones(2, np.float32))
    _write(p, arrays, _FLAT_META)
    _flip(p, *js.field_byte_range(p, "list_radii" if gate == "corrupt_optional" else "centers"))
    return p, "ivf_flat", None if gate == "corrupt_optional" else "centers"


@pytest.mark.parametrize("gate", ["wrong_kind", "newer_version", "missing_field", "missing_meta",
                                  "corrupt_optional", "corrupt_required"])
def test_read_ckpt_gates_match_jax(tmp_path, gate):
    path, kind, match = _gate_case(tmp_path, gate)
    if match is None:
        jarrays, _ = js.read_ckpt(path, kind, to_device=False)
        tarrays, _ = ts.read_ckpt(path, kind, device="cpu")
        assert "list_radii" not in jarrays and "list_radii" not in tarrays
        assert set(tarrays) == set(jarrays)
        assert tfl.load(path, device="cpu").list_radii is None
        return
    err = js.ChecksumError if gate == "corrupt_required" else js.SerializationError
    with pytest.raises(err, match=match):
        js.read_ckpt(path, kind, to_device=False)
    terr = ts.ChecksumError if gate == "corrupt_required" else ts.SerializationError
    with pytest.raises(terr, match=match) as info:
        ts.read_ckpt(path, kind, device="cpu")
    if gate == "corrupt_required":
        assert info.value.fields == ["centers"]
    with pytest.raises(ValueError):  # the typed errors are ValueErrors, as in JAX
        TMOD[kind].load(path, device="cpu")


GOLDEN_FILES = [("ivf_flat", "legacy_ivf_flat_v2_noradii.ckpt"),
                ("ivf_flat", "legacy_ivf_flat_v2_radii.ckpt"),
                ("ivf_pq", "legacy_ivf_pq_v1_noradii.ckpt"),
                ("ivf_pq", "legacy_ivf_pq_v1_radii.ckpt"),
                ("ivf_rabitq", "legacy_ivf_rabitq_v1.ckpt")]


@pytest.mark.parametrize("kind,golden", GOLDEN_FILES)
def test_legacy_goldens_load_with_declared_defaults(kind, golden):
    path = os.path.join(GOLDENS, golden)
    jidx, tidx = JMOD[kind].load(path), TMOD[kind].load(path, device="cpu")
    assert tidx.device.type == "cpu" and tidx.size == 96
    assert tidx.tombstones is None and tidx.n_tombstones == 0
    assert tidx.mut_cursor == 0 and tidx.append_slack == 0
    assert tm.live_rows(tidx) == tidx.size
    assert tidx.fused_kb is None
    if kind == "ivf_rabitq":
        assert tidx.codes_t is None and tidx.dataset is None
    elif "noradii" in golden:
        assert tidx.list_radii is None  # budgets only, never derived at load
    else:
        np.testing.assert_array_equal(tidx.list_radii.numpy(), np.asarray(jidx.list_radii))
    for f in TMOD[kind].INDEX_FIELDS:
        a = np.asarray(getattr(jidx, f))
        np.testing.assert_array_equal(getattr(tidx, f).numpy().view(a.dtype), a)
    q = np.random.default_rng(3).random((3, tidx.dim), dtype=np.float32)
    mod = TMOD[kind]
    _, ids = mod.search(mod.SearchParams(n_probes=4, recall_target=0.9), tidx,
                        torch.tensor(q), 3)
    assert ids.shape == (3, 3) and (ids >= 0).all()
    out = tm.delete(tidx, tidx.source_ids[:2])  # a legacy index is mutable
    assert out.n_tombstones == 2


def _blobs(rng, n):
    centers = np.random.default_rng(21).uniform(-5, 5, (N_LISTS, DIM)).astype(np.float32)
    return (centers[rng.integers(0, N_LISTS, n)] + rng.standard_normal((n, DIM))).astype(
        np.float32)


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(23)
    x = _blobs(rng, N)
    return x, (x[:NQ] + 0.1 * rng.standard_normal((NQ, DIM))).astype(np.float32)


@pytest.fixture(scope="module")
def jax_indexes(data):
    x, _ = data
    prng = np.random.default_rng(11)
    perm = np.zeros((DIM, DIM), np.float32)
    perm[np.arange(DIM), prng.permutation(DIM)] = prng.choice([-1.0, 1.0], DIM)
    jb = jrb.build(jrb.IndexParams(n_lists=N_LISTS, kmeans_n_iters=3, store_dataset=False,
                                   add_data_on_build=False), x)
    cent = (np.asarray(jb.centers) @ np.asarray(jb.rotation) @ perm.T).astype(np.float32)
    rb = jrb.extend(jrb.Index(jb.params, jnp.asarray(perm), jnp.asarray(cent), jb.codes,
                              jb.aux, jb.slot_rows, jb.list_sizes, jb.source_ids), x)
    return {"ivf_flat": jfl.build(jfl.IndexParams(n_lists=N_LISTS, kmeans_n_iters=3), x),
            "ivf_pq": jpq.build(jpq.IndexParams(n_lists=N_LISTS, pq_dim=8, kmeans_n_iters=3,
                                                kmeans_trainset_fraction=1.0), x),
            "ivf_rabitq": rb}


def _searches(kind, jidx, tidx, q):
    jmod, tmod = JMOD[kind], TMOD[kind]
    jv, ji = jmod.search(jmod.SearchParams(**PARITY[kind]), jidx, q, K)
    tv, ti = tmod.search(tmod.SearchParams(**PARITY[kind]), tidx, torch.tensor(q), K)
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


def _state(index):
    """Every saved array of an index, as numpy (tombstones as uint8, codes
    as the JAX dtype's bits) beside its cursor and slack."""
    out = {}
    for f in TMOD[tm.kind_of(index)].INDEX_FIELDS + ("list_radii", "tombstones"):
        v = getattr(index, f, None)
        if v is None:
            continue
        a = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        out[f] = a.astype(np.uint8) if f == "tombstones" else a
    if "codes" in out and out["codes"].dtype == np.int32:
        out["codes"] = out["codes"].view(np.uint32)
    return out, int(index.mut_cursor), int(index.append_slack)


@pytest.mark.parametrize("kind", KINDS)
def test_jax_saved_index_loads_in_the_port(tmp_path, data, jax_indexes, kind):
    _, q = data
    path = str(tmp_path / "j.ckpt")
    jidx = jax_indexes[kind]
    JMOD[kind].save(path, jidx)
    tidx = TMOD[kind].load(path, device="cpu")
    (js_, ji), (tv, ti) = _searches(kind, jidx, tidx, q)
    np.testing.assert_array_equal(ti, ji)
    if kind == "ivf_flat":
        scale = np.abs(js_).max(axis=1, keepdims=True) + (q * q).sum(1, keepdims=True)
        assert (np.abs(tv - js_) <= 1e-5 * scale).all()
    else:
        np.testing.assert_array_equal(tv.view(np.int32), js_.view(np.int32))
    jstate, tstate = _state(jidx), _state(tidx)
    assert jstate[1:] == tstate[1:]
    for f, a in jstate[0].items():
        np.testing.assert_array_equal(tstate[0][f], a, f)


@pytest.mark.parametrize("kind", KINDS)
def test_port_saved_index_loads_in_jax(tmp_path, data, jax_indexes, kind):
    x, q = data
    mod = TMOD[kind]
    arrays = {f: np.asarray(getattr(jax_indexes[kind], f)) for f in mod.INDEX_FIELDS}
    if kind != "ivf_rabitq":
        arrays["list_radii"] = np.asarray(jax_indexes[kind].list_radii)
    params = {"ivf_flat": tfl.IndexParams(n_lists=N_LISTS),
              "ivf_pq": tpq.IndexParams(n_lists=N_LISTS, pq_dim=8),
              "ivf_rabitq": trb.IndexParams(n_lists=N_LISTS, store_dataset=False)}[kind]
    tidx = mod.index_from_arrays(arrays, params, device="cpu")
    tidx = tm.ensure_append_slack(tm.delete(tidx, np.arange(0, 90, 3)), 40)
    tidx = tm.upsert(tidx, _blobs(np.random.default_rng(4), 12))
    tidx.mut_cursor = 5
    path = str(tmp_path / "t.ckpt")
    mod.save(path, tidx)
    jidx = JMOD[kind].load(path)
    tstate, jstate = _state(tidx), _state(jidx)
    assert tstate[1:] == jstate[1:] == (5, 40)
    assert set(tstate[0]) == set(jstate[0]) and "tombstones" in jstate[0]
    for f, a in tstate[0].items():
        assert jstate[0][f].dtype == a.dtype, f
        np.testing.assert_array_equal(jstate[0][f], a, f)
    # the same arrays through the JAX writer: the same bytes
    JMOD[kind].save(str(tmp_path / "j.ckpt"), jidx)
    assert (tmp_path / "t.ckpt").read_bytes() == (tmp_path / "j.ckpt").read_bytes()
    (jv, ji), (tv, ti) = _searches(kind, jidx, tidx, q)
    np.testing.assert_array_equal(ti, ji)
    assert not np.isin(ti, np.arange(0, 90, 3)).any()
    again = mod.load(path, device="cpu")
    np.testing.assert_array_equal(_searches(kind, jidx, again, q)[1][1], ti)


def test_digest_sidecar_is_checked_and_dropped(tmp_path, data, jax_indexes):
    from raft_tpu.integrity import digest

    _, q = data
    jidx = copy.copy(jax_indexes["ivf_flat"])
    digest.attach(jidx, "ivf_flat")
    path = str(tmp_path / "d.ckpt")
    jfl.save(path, jidx)
    arrays, meta = js.deserialize_arrays(path, to_device=False)
    assert "list_digests" in arrays and meta.get("table_digests")
    tidx = tfl.load(path, device="cpu")
    assert sorted(tidx.list_digests) == sorted(jidx.list_digests)
    for f, d in jidx.list_digests.items():
        np.testing.assert_array_equal(tidx.list_digests[f], np.asarray(d), f)
    assert tidx.table_digests == {f: int(v) for f, v in jidx.table_digests.items()}
    (_, ji), (_, ti) = _searches("ivf_flat", jidx, tidx, q)
    np.testing.assert_array_equal(ti, ji)
    tfl.save(str(tmp_path / "t.ckpt"), tidx)  # the port writes the sidecar it holds
    got = ts.deserialize_arrays(str(tmp_path / "t.ckpt"), to_device=False)[0]
    np.testing.assert_array_equal(got["list_digests"], arrays["list_digests"])
    _flip(path, *js.field_byte_range(path, "list_digests"))  # optional: rot is dropped
    rotted = tfl.load(path, device="cpu")
    assert rotted.size == N and rotted.list_digests is None and rotted.table_digests is None


def test_atomic_write_keeps_the_old_file_whole(tmp_path):
    path = str(tmp_path / "c.ckpt")
    ts.serialize_arrays(path, {"a": np.arange(5, dtype=np.int32)}, {"kind": "x"})
    before = open(path, "rb").read()

    class Boom(RuntimeError):
        pass

    with pytest.raises(Boom):
        with ts.atomic_write(path) as tmp:
            with open(tmp, "wb") as fh:
                fh.write(b"half a container")
            raise Boom()
    assert open(path, "rb").read() == before
    assert os.listdir(tmp_path) == ["c.ckpt"]  # no temporary file left
    with pytest.raises(TypeError):  # a value json cannot write: nothing lands
        ts.serialize_arrays(path, {"a": np.zeros(3, np.float32)}, {"kind": object()})
    assert open(path, "rb").read() == before
    got, meta = ts.deserialize_arrays(path, device="cpu")
    assert meta == {"kind": "x"} and got["a"].tolist() == [0, 1, 2, 3, 4]
    with pytest.raises(ts.SerializationError, match="bad magic"):
        ts.deserialize_arrays(io.BytesIO(b"NOTACONTAINER" * 4), device="cpu")
    with pytest.raises(ts.SerializationError, match="truncated"):
        ts.deserialize_arrays(io.BytesIO(before[:-3]), device="cpu")
