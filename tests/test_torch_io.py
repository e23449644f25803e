"""PyTorch port: `io` (format probing, the file loader on the port's own C++
ring reader and on its memmap twin) and `neighbors.batch_loader`
(`BatchLoadIterator`, `extend_batched`, the `batch_loader.load` fault
site), on the CPU, against the JAX package on the same files and arrays.

The ring reader is built here with the system `g++` (`native.loader_lib`);
its batches equal the memmap twin's and the JAX loader's bit for bit, a
resumed iteration (`start_batch`) equals the tail of a full one, and a
streamed IVF-Flat build equals the one-shot build (the same lists, the
same search answers).
"""

import os

import numpy as np
import pytest
import torch

from raft_tpu import io as jio
from raft_tpu.neighbors.batch_loader import BatchLoadIterator as JBatchLoadIterator
from raft_tpu_torch import io as tio
from raft_tpu_torch import native
from raft_tpu_torch.core import faults
from raft_tpu_torch.neighbors import batch_loader, ivf_flat
from raft_tpu_torch.neighbors.batch_loader import BatchLoadIterator

FORMATS = {".fbin": np.float32, ".u8bin": np.uint8, ".i8bin": np.int8, ".ibin": np.int32}


def _write_bin(path, arr):
    with open(path, "wb") as f:
        np.asarray(arr.shape, np.uint32).tofile(f)
        arr.tofile(f)


def _array(dtype, n, dim, seed=0):
    rng = np.random.default_rng(seed)
    if np.issubdtype(dtype, np.floating):
        return rng.standard_normal((n, dim)).astype(dtype)
    info = np.iinfo(dtype)
    return rng.integers(max(info.min, -1000), min(info.max, 1000), (n, dim)).astype(dtype)


@pytest.mark.parametrize("ext", sorted(FORMATS) + [".npy"])
def test_probe_file_matches_jax(tmp_path, ext):
    p = str(tmp_path / f"d{ext}")
    a = _array(FORMATS.get(ext, np.float64), 13, 5)
    if ext == ".npy":
        np.save(p, a)
    else:
        _write_bin(p, a)
    got = tio.probe_file(p)
    assert got == jio.probe_file(p)
    off, shape, dtype = got
    assert shape == a.shape and dtype == a.dtype
    np.testing.assert_array_equal(np.fromfile(p, dtype, offset=off).reshape(shape), a)


def test_probe_file_rejects(tmp_path):
    with pytest.raises(ValueError):
        tio.probe_file(str(tmp_path / "x.csv"))
    p = str(tmp_path / "trunc.fbin")
    with open(p, "wb") as f:
        np.asarray([100, 100], np.uint32).tofile(f)
    with pytest.raises(ValueError, match="promises"):
        tio.probe_file(p)
    p = str(tmp_path / "f.npy")
    np.save(p, np.asfortranarray(np.ones((3, 4), np.float32)))
    with pytest.raises(ValueError, match="Fortran"):
        tio.probe_file(p)


def _batches(loader):
    return [(b.copy(), v) for b, v in loader]


@pytest.mark.parametrize("ext", [".fbin", ".u8bin", ".npy"])
@pytest.mark.parametrize("n,batch", [(37, 8), (32, 8), (5, 16), (0, 4)])
def test_native_ring_equals_the_memmap_twin_and_jax(tmp_path, ext, n, batch):
    assert native.loader_lib() is not None, native.loader_error()
    p = str(tmp_path / f"d{ext}")
    a = _array(FORMATS.get(ext, np.float32), n, 6, seed=n)
    np.save(p, a) if ext == ".npy" else _write_bin(p, a)
    ring = _batches(tio.FileBatchLoader(p, batch, native=True, copy=False))
    twin = _batches(tio.FileBatchLoader(p, batch, native=False))
    ref = _batches(jio.FileBatchLoader(p, batch, native=False))
    assert len(ring) == len(twin) == len(ref) == -(-n // batch)
    for (r, rv), (t, tv), (j, jv) in zip(ring, twin, ref):
        assert r.shape == (batch, 6) and r.dtype == a.dtype
        assert rv == tv == jv
        assert r.tobytes() == t.tobytes() == j.tobytes()
    if n:
        np.testing.assert_array_equal(np.concatenate([r[:v] for r, v in ring]), a)


@pytest.mark.parametrize("use_native", [True, False])
@pytest.mark.parametrize("start", [0, 2, 5, 6])
def test_start_batch_resumes_bit_for_bit(tmp_path, use_native, start):
    p = str(tmp_path / "d.fbin")
    _write_bin(p, _array(np.float32, 45, 3))
    full = _batches(tio.FileBatchLoader(p, 8, native=use_native))
    tail = _batches(tio.FileBatchLoader(p, 8, native=use_native, start_batch=start))
    assert len(tail) == len(full) - start
    for (a, av), (b, bv) in zip(tail, full[start:]):
        assert av == bv and a.tobytes() == b.tobytes()
    with pytest.raises(ValueError, match="start_batch"):
        tio.FileBatchLoader(p, 8, start_batch=7)


def test_ring_views_live_for_depth_minus_one_batches_and_reiterate(tmp_path):
    p = str(tmp_path / "d.fbin")
    a = _array(np.float32, 64, 4)
    _write_bin(p, a)
    loader = tio.FileBatchLoader(p, 8, depth=4, copy=False, native=True)
    held = []
    for b, v in loader:
        held.append(b)
        # the current view and the depth - 2 before it are still intact
        for k, old in enumerate(held[-3:]):
            i = len(held) - len(held[-3:]) + k
            np.testing.assert_array_equal(old, a[8 * i:8 * i + 8])
    again = _batches(loader)
    assert len(again) == len(loader) == 8
    np.testing.assert_array_equal(np.concatenate([b for b, _ in again]), a)


def test_native_true_without_the_library_raises(tmp_path, monkeypatch):
    p = str(tmp_path / "d.fbin")
    _write_bin(p, _array(np.float32, 4, 2))
    monkeypatch.setattr(native, "loader_lib", lambda: None)
    with pytest.raises(tio.NativeLoaderUnavailable):
        tio.FileBatchLoader(p, 2, native=True)
    # native=None takes the memmap twin
    assert tio.FileBatchLoader(p, 2)._lib is None
    assert issubclass(tio.NativeLoaderUnavailable, RuntimeError)
    assert tio.__all__ == jio.__all__


# -- BatchLoadIterator -------------------------------------------------------


class _Recording:
    def __init__(self, arr, events):
        self.arr, self.events = arr, events

    @property
    def shape(self):
        return self.arr.shape

    def __getitem__(self, key):
        self.events.append(("load", key.start // 16))
        return self.arr[key]


@pytest.mark.parametrize("prefetch", [True, False])
def test_prefetch_order(prefetch):
    events = []
    host = _Recording(np.arange(80, dtype=np.float32).reshape(80, 1), events)
    for b, _ in enumerate(BatchLoadIterator(host, 16, device="cpu", prefetch=prefetch)):
        events.append(("consume", b))
    for b in range(4):
        before = events.index(("load", b + 1)) < events.index(("consume", b))
        assert before == prefetch, events


@pytest.mark.parametrize("prefetch", [True, False])
@pytest.mark.parametrize("n,batch", [(50, 16), (48, 16), (5, 16)])
def test_padding_and_valid_match_jax(prefetch, n, batch):
    arr = np.arange(n * 3, dtype=np.float32).reshape(n, 3)
    got = list(BatchLoadIterator(arr, batch, device="cpu", prefetch=prefetch))
    want = list(JBatchLoadIterator(arr, batch, prefetch=prefetch))
    assert len(got) == len(want) == -(-n // batch)
    for (g, gv), (w, wv) in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        assert gv == wv and g.shape == (batch, 3)
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_dtype_memmap_and_tensor_hosts(tmp_path):
    arr = np.arange(40, dtype=np.float64).reshape(10, 4)
    (b, v), = list(BatchLoadIterator(arr, 16, device="cpu", dtype=np.float32))
    assert b.dtype == torch.float32 and v == 10
    mm_path = str(tmp_path / "m.npy")
    np.save(mm_path, arr.astype(np.float32))
    mm = np.load(mm_path, mmap_mode="r")
    got = torch.cat([t[:v] for t, v in BatchLoadIterator(mm, 4, device="cpu")])
    np.testing.assert_array_equal(got.numpy(), arr.astype(np.float32))
    got = torch.cat([t[:v] for t, v in BatchLoadIterator(torch.as_tensor(arr), 3,
                                                           device="cpu")])
    np.testing.assert_array_equal(got.numpy(), arr)
    assert len(BatchLoadIterator(np.zeros((0, 2)), 4, device="cpu")) == 0
    with pytest.raises(ValueError):
        BatchLoadIterator(arr, 0, device="cpu")


def test_batch_loader_load_fault_hooks():
    arr = np.arange(60, dtype=np.float32).reshape(20, 3)
    flaky = faults.FaultPlan([faults.Fault(kind="flaky_bootstrap", site="batch_loader.load",
                                           count=2)], seed=1)
    with flaky.install():
        for _ in range(2):
            with pytest.raises(faults.FaultInjected):
                list(BatchLoadIterator(arr, 8, device="cpu"))
        assert len(list(BatchLoadIterator(arr, 8, device="cpu"))) == 3
    nan = faults.FaultPlan([faults.Fault(kind="corrupt_shard", site="batch_loader.load",
                                         fraction=1.0)], seed=1)
    with nan.install():
        blocks = list(BatchLoadIterator(arr, 8, device="cpu"))
    for b, v in blocks:
        assert torch.isnan(b[:v]).all()
    other_rank = faults.FaultPlan([faults.Fault(kind="corrupt_shard", site="batch_loader.load",
                                                fraction=1.0, rank=3)], seed=1)
    with other_rank.install():
        clean = torch.cat([b[:v] for b, v in BatchLoadIterator(arr, 8, device="cpu")])
    np.testing.assert_array_equal(clean.numpy(), arr)
    assert batch_loader._rank() == 0


# -- streamed builds ---------------------------------------------------------


def _blobs(n, dim, seed=0):
    rng = np.random.default_rng(seed)
    c = rng.uniform(-5, 5, (16, dim))
    return (c[rng.integers(0, 16, n)] + rng.standard_normal((n, dim))).astype(np.float32)


def _same_index(a, b):
    for f in ("centers", "list_data", "slot_rows", "list_sizes", "source_ids"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


def test_extend_batched_equals_the_one_shot_build():
    x = _blobs(1500, 8)
    one = ivf_flat.build(ivf_flat.IndexParams(n_lists=16), x, device="cpu")
    empty = ivf_flat.build(ivf_flat.IndexParams(n_lists=16, add_data_on_build=False), x,
                           device="cpu")
    streamed = batch_loader.extend_batched(ivf_flat.extend, empty, x, 400)
    _same_index(one, streamed)
    q = x[:20] + 0.01
    sp = ivf_flat.SearchParams(n_probes=16)
    d1, i1 = ivf_flat.search(sp, one, q, 5)
    d2, i2 = ivf_flat.search(sp, streamed, q, 5)
    assert torch.equal(d1, d2) and torch.equal(i1, i2)
    # start_id offsets the ids
    offset = batch_loader.extend_batched(ivf_flat.extend, empty, x[:10], 4, start_id=100)
    assert offset.source_ids.tolist() == list(range(100, 110))


def test_extend_from_file_equals_extend_batched(tmp_path):
    x = _blobs(900, 6, seed=1)
    p = str(tmp_path / "x.fbin")
    _write_bin(p, x)
    empty = ivf_flat.build(ivf_flat.IndexParams(n_lists=8, add_data_on_build=False), x,
                           device="cpu")
    from_file = tio.extend_from_file(ivf_flat.extend, empty, p, 256)
    batched = batch_loader.extend_batched(ivf_flat.extend, empty, x, 256)
    _same_index(from_file, batched)
    assert os.path.getsize(p) == 8 + x.nbytes
