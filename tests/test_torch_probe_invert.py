"""PyTorch port: the probe-inversion impls of `neighbors/probe_invert`
against the JAX package's, and the two single-device leftovers.

- "count" equals "sort" bit for bit (values and dtypes) over the grid of
  tests/test_probe_invert.py, masked pairs included, and both equal the
  JAX tables;
- the three `gather_query_rows` impls equal the JAX function's output
  bit for bit ("onehot_bf16" included), on sizes that cross the one-hot
  sub-block bound; on rows holding -0.0 and an inf the one-hot forms are
  held to the JAX function, not to the gather (the sum turns -0.0 into
  +0.0, and 0 x inf makes NaN); "onehot_f32h" stays exact with TF32
  asked for through `set_matmul_precision("default")`;
- the resolvers under one monkeypatched table for both packages, with
  the `_COUNT_MAX_LISTS` and flat-bf16 gates, and "sort"/"gather" on CPU
  tensors whatever the table says;
- IVF-PQ, IVF-Flat and RaBitQ searches under each `setup_impls` give the
  default's ids (the PQ engines under "onehot_bf16": its recall);
- `check_same_rows` and `is_device_fault` on synthetic messages.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from raft_tpu.core import config as jconfig
from raft_tpu.core import tuned as jtuned
from raft_tpu.core import validation as jvalidation
from raft_tpu.neighbors import probe_invert as jpi
from raft_tpu_torch.core import config as tconfig
from raft_tpu_torch.core import tuned
from raft_tpu_torch.core import validation as tvalidation
from raft_tpu_torch.distance import pairwise as tpairwise
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import ivf_rabitq as trb
from raft_tpu_torch.neighbors import probe_invert as tpi

# tests/test_probe_invert.py's grid: (nq, n_probes, n_lists, chunk, skew)
GRID = [
    (64, 8, 16, 16, False),
    (128, 4, 8, 32, True),
    (33, 7, 64, 8, True),
    (16, 3, 4, 64, False),
    (100, 5, 300, 32, False),
    (16, 1, 4, 64, False),
]


def _probes(rng, nq, n_probes, n_lists, skew):
    if skew:
        raw = rng.zipf(1.5, size=(nq, n_probes)) % n_lists
    else:
        raw = rng.integers(0, n_lists, size=(nq, n_probes))
        raw[: nq // 2, 0] = 0  # one hot list: multi-chunk splits
    return raw.astype(np.int32)


def _assert_tables_equal(a, b):
    for x, y in zip(tuple(a), tuple(b)):
        if x is None or y is None:
            assert x is None and y is None
            continue
        assert x.dtype == y.dtype
        assert torch.equal(x, y)


def _assert_tables_match_jax(t, j):
    for x, y in zip(tuple(t), tuple(j)):
        if x is None or y is None:
            assert x is None and y is None
            continue
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("nq,n_probes,n_lists,chunk,skew", GRID)
def test_count_equals_sort_and_both_equal_jax(nq, n_probes, n_lists, chunk, skew, masked):
    rng = np.random.default_rng(nq * 7 + n_lists)
    raw = _probes(rng, nq, n_probes, n_lists, skew)
    pv = None
    if masked:
        pv = rng.random((nq, n_probes)) < 0.5
        pv[:, 0] = True
    tp = torch.from_numpy(raw)
    tpv = None if pv is None else torch.from_numpy(pv)
    jpv = None if pv is None else jnp.asarray(pv)
    s = tpi.invert_probes_sort(tp, n_lists, chunk, tpv)
    c = tpi.invert_probes_count(tp, n_lists, chunk, tpv)
    _assert_tables_equal(s, c)
    _assert_tables_match_jax(c, jpi.invert_probes_count(jnp.asarray(raw), n_lists, chunk, jpv))
    _assert_tables_match_jax(s, jpi.invert_probes_sort(jnp.asarray(raw), n_lists, chunk, jpv))


def test_blocked_ranks_cross_blocks():
    """More pairs than one block (the JAX block at 64 lists is 8192 pairs)
    carry per-list totals across blocks, as JAX's scan does."""
    rng = np.random.default_rng(3)
    flat = rng.integers(0, 65, size=20_000).astype(np.int32)  # 64 = the sentinel list
    r, c = tpi._blocked_bucket_ranks(torch.from_numpy(flat).long(), 64)
    jr, jc = jpi._blocked_bucket_ranks(jnp.asarray(flat), 64)
    np.testing.assert_array_equal(r.numpy(), np.asarray(jr))
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _assert_rows_equal(t, j):
    t, j = t.numpy(), np.asarray(j)
    assert t.dtype == j.dtype == np.float32 and t.shape == j.shape
    nan_t, nan_j = np.isnan(t), np.isnan(j)
    np.testing.assert_array_equal(nan_t, nan_j)
    np.testing.assert_array_equal(_bits(t)[~nan_t], _bits(j)[~nan_j])


# (nq + 1, dim, id table shape): the one-hot sub-block holds
# 2^25 // (chunk * (nq + 1) * itemsize) rows, so 10 rows of 64 over 20001
# query rows cross it for both dtypes, and 3 rows of 8 over 257 do not
QS_CASES = [(20001, 8, (10, 64)), (257, 16, (3, 8)), (4097, 12, (2, 5, 16))]


@pytest.mark.parametrize("impl", tpi.QS_IMPLS)
@pytest.mark.parametrize("nq1,dim,shape", QS_CASES)
def test_gather_query_rows_impls_match_jax(impl, nq1, dim, shape):
    rng = np.random.default_rng(nq1)
    q = rng.standard_normal((nq1, dim)).astype(np.float32)
    q[-1] = 0.0  # the sentinel row
    ids = rng.integers(0, nq1, size=shape).astype(np.int32)
    ids.reshape(-1)[::7] = nq1 - 1
    got = tpi.gather_query_rows(torch.from_numpy(q), torch.from_numpy(ids).long(), impl)
    want = jpi.gather_query_rows(jnp.asarray(q), jnp.asarray(ids), impl)
    _assert_rows_equal(got, want)
    if impl == "onehot_f32h":
        np.testing.assert_array_equal(got.numpy(), q[ids])
    elif impl == "onehot_bf16":
        rounded = torch.from_numpy(q[ids]).to(torch.bfloat16).float()
        assert torch.equal(got, rounded)


@pytest.mark.parametrize("impl", ["onehot_bf16", "onehot_f32h"])
def test_onehot_signed_zero_and_inf_follow_jax(impl):
    rng = np.random.default_rng(9)
    q = rng.standard_normal((33, 6)).astype(np.float32)
    q[2, 1] = -0.0
    q[5, :] = -0.0
    q[-1] = 0.0
    ids = rng.integers(0, 33, size=(4, 8)).astype(np.int32)
    ids[0, :3] = (2, 5, 5)
    got = tpi.gather_query_rows(torch.from_numpy(q), torch.from_numpy(ids).long(), impl)
    want = jpi.gather_query_rows(jnp.asarray(q), jnp.asarray(ids), impl)
    _assert_rows_equal(got, want)
    assert not np.signbit(got.numpy()[0, 1]).any()  # -0.0 reads +0.0
    q[7, 3] = np.inf
    got = tpi.gather_query_rows(torch.from_numpy(q), torch.from_numpy(ids).long(), impl)
    want = jpi.gather_query_rows(jnp.asarray(q), jnp.asarray(ids), impl)
    _assert_rows_equal(got, want)
    assert np.isnan(got.numpy()[..., 3]).any()


def test_onehot_f32h_is_exact_under_default_precision():
    rng = np.random.default_rng(4)
    q = torch.tensor(rng.standard_normal((101, 16)), dtype=torch.float32)
    ids = torch.tensor(rng.integers(0, 101, size=(6, 32)))
    prev = tpairwise._MATMUL_PRECISION
    try:
        tpairwise.set_matmul_precision("default")
        torch.backends.cuda.matmul.allow_tf32 = True
        got = tpi.gather_query_rows(q, ids, "onehot_f32h")
        assert torch.backends.cuda.matmul.allow_tf32  # restored
    finally:
        tpairwise._MATMUL_PRECISION = prev
        torch.backends.cuda.matmul.allow_tf32 = False
    assert torch.equal(got, q[ids])


def test_gather_query_rows_rejects_an_unknown_impl():
    with pytest.raises(ValueError, match="unknown query-row impl"):
        tpi.gather_query_rows(torch.zeros((3, 2)), torch.zeros((1, 2), dtype=torch.long), "x")
    with pytest.raises(ValueError, match="unknown query-row impl"):
        jpi.gather_query_rows(jnp.zeros((3, 2)), jnp.zeros((1, 2), jnp.int32), "x")


TABLES = [
    {},
    {"invert_impl": "count"},
    {"invert_impl": "sort", "listmajor_qs_impl": "onehot_bf16"},
    {"listmajor_qs_impl": "onehot_f32h"},
    {"listmajor_qs_impl": "onehot_bf16", "listmajor_qs_impl_flat": "onehot_bf16"},
    {"listmajor_qs_impl": "onehot_bf16", "listmajor_qs_impl_flat": "gather"},
    {"invert_impl": "radix", "listmajor_qs_impl": "scatter", "listmajor_qs_impl_flat": 3},
]


@pytest.fixture
def under(monkeypatch):
    """Put both packages under one fake table, the port's gate open."""
    def apply(table):
        monkeypatch.setattr(jtuned, "_load", lambda: dict(table))
        monkeypatch.setattr(tuned, "_load", lambda: dict(table))
        monkeypatch.setattr(tuned, "applies", lambda device: True)
    return apply


@pytest.mark.parametrize("table", range(len(TABLES)))
def test_resolvers_match_jax(under, table):
    under(TABLES[table])
    dev = torch.device("cuda")  # reaches only the patched gate
    for n_lists in (16, 1024, tpi._COUNT_MAX_LISTS, tpi._COUNT_MAX_LISTS + 1):
        assert tpi.resolve_invert_impl(n_lists, dev) == jpi.resolve_invert_impl(n_lists)
        for engine in ("pq", "flat"):
            assert (tpi.resolve_setup_impls(n_lists, engine, dev)
                    == jpi.resolve_setup_impls(n_lists, engine))
    for engine in ("pq", "flat"):
        assert tpi.resolve_qs_impl(engine, dev) == jpi.resolve_qs_impl(engine)
    assert tpi.INVERT_IMPLS == jpi.INVERT_IMPLS and tpi.QS_IMPLS == jpi.QS_IMPLS
    assert tpi._COUNT_MAX_LISTS == jpi._COUNT_MAX_LISTS == 8192


def test_gates(under):
    under({"invert_impl": "count", "listmajor_qs_impl": "onehot_bf16"})
    dev = torch.device("cuda")
    assert tpi.resolve_invert_impl(8192, dev) == "count"
    assert tpi.resolve_invert_impl(8193, dev) == "sort"
    assert tpi.resolve_qs_impl("pq", dev) == "onehot_bf16"
    assert tpi.resolve_qs_impl("flat", dev) == "gather"


def test_cpu_tensors_resolve_to_the_default_whatever_the_table(monkeypatch):
    monkeypatch.setattr(tuned, "_load", lambda: {
        "invert_impl": "count", "listmajor_qs_impl": "onehot_f32h",
        "listmajor_qs_impl_flat": "onehot_f32h"})
    cpu = torch.device("cpu")
    assert tpi.resolve_setup_impls(16, "pq", cpu) == ("sort", "gather")
    assert tpi.resolve_setup_impls(16, "flat", cpu) == ("sort", "gather")
    assert tpi.resolve_setup_impls(16) == ("sort", "gather")  # no device: no table


def test_dispatcher_follows_the_table(under):
    rng = np.random.default_rng(1)
    raw = torch.from_numpy(rng.integers(0, 16, size=(32, 4)).astype(np.int32))
    under({"invert_impl": "count"})
    _assert_tables_equal(tpi.invert_probes(raw, 16, 8), tpi.invert_probes_count(raw, 16, 8))


# ---------------------------------------------------------------------------
# the engines under each setup
# ---------------------------------------------------------------------------

SETUPS = [(inv, qs) for inv in tpi.INVERT_IMPLS for qs in tpi.QS_IMPLS]


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(11)
    centers = rng.uniform(-6, 6, (12, 24)).astype(np.float32)
    x = (centers[rng.integers(0, 12, 3000)]
         + rng.standard_normal((3000, 24))).astype(np.float32)
    q = x[rng.choice(3000, 40, replace=False)] + 0.05 * rng.standard_normal(
        (40, 24)).astype(np.float32)
    return torch.from_numpy(x), torch.from_numpy(q.astype(np.float32))


@pytest.fixture(scope="module")
def built(blobs):
    x, _ = blobs
    return {
        "pq": tpq.build(tpq.IndexParams(n_lists=12, pq_dim=12, kmeans_n_iters=5), x,
                        device="cpu"),
        "flat": tfl.build(tfl.IndexParams(n_lists=12, kmeans_n_iters=5), x, device="cpu"),
        "rabitq": trb.build(trb.IndexParams(n_lists=12, kmeans_n_iters=5), x, device="cpu"),
    }


def _search(kind, built, q, setup, monkeypatch):
    """A search under a tuned table naming `setup` (the gate patched open,
    so the engines resolve it as on the card): `invert_impl` and
    `listmajor_qs_impl`, and the flat key too unless the impl is bf16,
    which the flat engines and RaBitQ then gate back to "gather"."""
    inv, qs = setup
    table = {"invert_impl": inv, "listmajor_qs_impl": qs}
    if qs != "onehot_bf16":
        table["listmajor_qs_impl_flat"] = qs
    monkeypatch.setattr(tuned, "_load", lambda: dict(table))
    monkeypatch.setattr(tuned, "applies", lambda device: True)
    if kind == "pq-approx":
        p = tpq.SearchParams(n_probes=4, score_mode="recon8_list", trim_engine="approx")
        return tpq.search(p, built["pq"], q, 10)
    if kind == "pq-fused":
        p = tpq.SearchParams(n_probes=4, score_mode="recon8_list", trim_engine="fused")
        return tpq.search(p, built["pq"], q, 10)
    if kind == "pq-pallas":
        p = tpq.SearchParams(n_probes=4, score_mode="recon8_list", trim_engine="pallas")
        return tpq.search(p, built["pq"], q, 10)
    if kind in ("flat-list", "flat-fused"):
        p = tfl.SearchParams(n_probes=4, engine=kind.split("-")[1])
        return tfl.search(p, built["flat"], q, 10)
    p = trb.SearchParams(n_probes=4, scan_engine="fused")
    return trb.search(p, built["rabitq"], q, 10)


def _recall(ids, truth):
    return float(np.mean([len(set(a) & set(b)) / len(b)
                          for a, b in zip(ids.tolist(), truth.tolist())]))


@pytest.mark.parametrize("kind", ["pq-approx", "pq-fused", "pq-pallas", "flat-list",
                                  "flat-fused", "rabitq"])
def test_engines_give_the_default_ids_under_each_setup(kind, built, blobs, monkeypatch):
    """Every exact setup gives the default's ids and values bit for bit.
    "onehot_bf16" rounds the PQ engines' query rows to bf16 (the flat
    engines and RaBitQ gate it back to "gather"), which moves their
    approximate scores by up to ~1%: there the ids are held by recall
    against the exact truth, within 0.02 of the default's."""
    x, q = blobs
    d2 = torch.cdist(q.double(), x.double())
    truth = torch.topk(d2, 10, largest=False).indices
    dv, di = _search(kind, built, q, ("sort", "gather"), monkeypatch)
    for setup in SETUPS[1:]:
        v, i = _search(kind, built, q, setup, monkeypatch)
        if setup[1] == "onehot_bf16" and kind.startswith("pq"):
            assert abs(_recall(i, truth) - _recall(di, truth)) <= 0.02, (kind, setup)
            continue
        assert torch.equal(i, di), (kind, setup)
        assert torch.equal(v, dv), (kind, setup)


# ---------------------------------------------------------------------------
# the single-device leftovers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows", [(5, 5), (5, 6), (0, 1)])
def test_check_same_rows_matches_jax(rows):
    a, b = np.zeros((rows[0], 3)), np.zeros((rows[1], 4))
    try:
        jvalidation.check_same_rows(a, b, "x", "y")
        want = None
    except ValueError as e:
        want = str(e)
    if want is None:
        tvalidation.check_same_rows(torch.from_numpy(a), torch.from_numpy(b), "x", "y")
    else:
        with pytest.raises(ValueError) as exc:
            tvalidation.check_same_rows(torch.from_numpy(a), torch.from_numpy(b), "x", "y")
        assert str(exc.value) == want


CUDA_FAULTS = [
    "CUDA error: device-side assert triggered",
    "CUDA error: an illegal memory access was encountered",
    "CUDA error: unspecified launch failure",
    "CUDA error: misaligned address",
    "CUDA error: an illegal instruction was encountered",
    "CUDA error: uncorrectable ECC error encountered",
]
SHARED = [
    ("UNAVAILABLE: TPU device error", True),
    ("INTERNAL: device error in kernel", True),
    ("ValueError: k=300 exceeds 256", False),
    ("CUDA out of memory. Tried to allocate 2.00 GiB", False),
    ("", False),
]


@pytest.mark.parametrize("msg", CUDA_FAULTS)
def test_is_device_fault_classifies_the_cuda_context_poisoners(msg):
    assert tconfig.is_device_fault(RuntimeError(msg))


@pytest.mark.parametrize("msg,want", SHARED)
def test_is_device_fault_matches_jax_on_shared_messages(msg, want):
    assert tconfig.is_device_fault(RuntimeError(msg)) == jconfig.is_device_fault(
        RuntimeError(msg)) == want
