"""PyTorch port: the int8 list scan (`fused_list_topk_int8`) against the
JAX Pallas kernel in interpret mode, and the int8 score's rounding.

An int8 score is exact up to its last step: the int32 dot is exact in any
order. The JAX kernels on the CPU round L2 twice (`f32(idot) * scale`,
then `base - 2 * dots`) and inner product once (`base - f32(idot) *
scale` as one fused multiply-add). The port's plain version rounds the
same way (`fused_scan.int8_scores`), so values and slots must match bit
for bit on any int8 data, ties included.
"""

from fractions import Fraction

import jax.numpy as jnp
import numpy as np
import pytest

import torch

from raft_tpu.ops import fused_scan as jfs
from raft_tpu.ops import pq_list_scan as jpls
from raft_tpu_torch.matrix.select_k import check_fused_list_request, list_scan_select_k
from raft_tpu_torch.ops import fused_scan as tfs
from raft_tpu_torch.ops import pq_list_scan as tpls


def _int8_case(rng, ncb=6, chunk=8, L=256, rot=24, n_lists=4, inf_frac=0.1, grid=False):
    """Random int8 rows and store (+-127 included), row scales U(1e-3, 1),
    base U(0, 1e5) with +inf slots. `grid` draws small values instead, so
    that many scores tie."""
    lo, hi = (-3, 4) if grid else (-127, 128)
    q8 = rng.integers(lo, hi, (ncb, chunk, rot)).astype(np.int8)
    st = rng.integers(lo, hi, (n_lists, L, rot)).astype(np.int8)
    q8[0, 0, :] = 127
    st[0, :2, :] = -127
    rs = rng.uniform(1e-3, 1.0, (ncb, chunk, 1)).astype(np.float32)
    if grid:
        base = rng.integers(0, 20, (n_lists, 1, L)).astype(np.float32)
        rs[:] = np.float32(0.25)
    else:
        base = rng.uniform(0, 1e5, (n_lists, 1, L)).astype(np.float32)
    base[rng.random((n_lists, 1, L)) < inf_frac] = np.inf
    lof = rng.integers(0, n_lists, ncb).astype(np.int32)
    return lof, q8, st, base, rs


def _t(*arrays):
    return [torch.tensor(a) for a in arrays]


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("ip", [False, True])
@pytest.mark.parametrize("L", [256, 384])
def test_fused_list_topk_int8_plain_bitwise_equal_to_jax(rng, k, ip, L):
    lof, q8, st, base, rs = _int8_case(rng, L=L)
    jv, ji = (np.asarray(a) for a in jfs.fused_list_topk_int8(
        lof, q8, st, base, rs, k, inner_product=ip, interpret=True))
    tv, ti = tfs.fused_list_topk_int8(*_t(lof, q8, st, base, rs), k, inner_product=ip)
    assert tv.shape == jv.shape and ti.dtype == torch.int32
    np.testing.assert_array_equal(tv.numpy().view(np.int32), jv.view(np.int32))
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(ti.numpy()[fin], ji[fin])


@pytest.mark.parametrize("ip", [False, True])
def test_fused_list_topk_int8_plain_ties_and_empty_chunks(rng, ip):
    """Small values make many equal scores (ties go to the smaller slot);
    chunk_valid zeros write (+inf, sentinel) in both packages."""
    lof, q8, st, base, rs = _int8_case(rng, ncb=6, grid=True, inf_frac=0.4)
    cv = np.array([1, 0, 1, 1, 0, 1], np.int32)
    jv, ji = (np.asarray(a) for a in jfs.fused_list_topk_int8(
        lof, q8, st, base, rs, 40, inner_product=ip, interpret=True,
        chunk_valid=jnp.asarray(cv)))
    tv, ti = tfs.fused_list_topk_int8(*_t(lof, q8, st, base, rs), 40, inner_product=ip,
                                      chunk_valid=torch.tensor(cv))
    np.testing.assert_array_equal(tv.numpy(), jv)
    np.testing.assert_array_equal(ti.numpy(), ji)
    assert np.all(ti.numpy()[cv == 0] == tfs._ID_SENTINEL)


def test_fused_list_topk_int8_plain_chunk_rows(rng):
    """The port's chunk_rows: rows past each chunk's live count hold
    (+inf, sentinel); live rows are unchanged."""
    lof, q8, st, base, rs = _int8_case(rng)
    args = _t(lof, q8, st, base, rs)
    rows = torch.tensor([0, 8, 3, 1, 5, 7], dtype=torch.int32)
    full = tfs.fused_list_topk_int8(*args, 10)
    part = tfs.fused_list_topk_int8(*args, 10, chunk_rows=rows)
    live = torch.arange(8)[None, :] < rows[:, None]
    for got, ref, empty in zip(part, full, (float("inf"), tfs._ID_SENTINEL)):
        assert torch.equal(got[live], ref[live])
        assert torch.all(got[~live] == empty)


@pytest.mark.parametrize("ip", [False, True])
@pytest.mark.parametrize("L", [256, 384, 1280])
def test_int8_engines_cross_engine_subset(rng, ip, L):
    """The exact int8 trim's top-k and the bin fold's int8 candidates are
    the same f32 values: every top-k pair with fewer than two better
    pairs in its bin (slot % 128, (slot // 128) % 2) is, bitwise, among
    the fold's 512 candidates of that row. At L <= 512 a bin holds at
    most two slots, so every finite top-k pair is there."""
    lof, q8, st, base, rs = _int8_case(rng, L=L)
    args = _t(lof, q8, st, base, rs)
    k = 100
    tv, ti = tfs.fused_list_topk_int8(*args, k, inner_product=ip)
    fv, fi = tpls.pq_list_scan(*args[:4], inner_product=ip, q_scale=args[4])
    # the JAX kernels agree with each other the same way
    jv, _ = jfs.fused_list_topk_int8(lof, q8, st, base, rs, k, inner_product=ip,
                                     interpret=True)
    jfv, _ = jpls.pq_list_scan(lof, q8, st, base, inner_product=ip, interpret=True,
                               q_scale=jnp.asarray(rs))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(fv.numpy(), np.asarray(jfv))
    tv, ti, fv, fi = tv.numpy()[..., :k], ti.numpy()[..., :k], fv.numpy(), fi.numpy()
    checked = 0
    for c in range(tv.shape[0]):
        for r in range(tv.shape[1]):
            cands = set(zip(fv[c, r].view(np.int32).tolist(), fi[c, r].tolist()))
            seen = {}
            for v, s in zip(tv[c, r], ti[c, r]):
                if not np.isfinite(v):
                    break
                b = (s % 128, (s // 128) % 2)
                if seen.get(b, 0) < 2:
                    assert (int(np.float32(v).view(np.int32)), int(s)) in cands, (c, r, v, s)
                    checked += 1
                elif L <= 512:
                    raise AssertionError("a bin of at most two slots dropped a pair")
                seen[b] = seen.get(b, 0) + 1
    assert checked > 0


def _correctly_rounded(a, b, c, r):
    e = Fraction(float(c)) + Fraction(float(a)) * Fraction(float(b))
    lo = np.nextafter(r, np.float32(-np.inf))
    hi = np.nextafter(r, np.float32(np.inf))
    d = abs(e - Fraction(float(r)))
    return d <= abs(e - Fraction(float(lo))) and d <= abs(e - Fraction(float(hi)))


def test_fma_emulation_rounds_once(rng):
    """`_fma_f32` is `a * b + c` rounded once to f32. The constructed
    cases land the float64 sum exactly on an f32 midpoint while the exact
    sum lies above it: rounding the float64 sum to nearest would round
    twice and give the other neighbour."""
    a = np.array([65.0, 205.0, 305.0, -65.0], np.float32)
    b = np.array([0.9846154, 0.31219512, 0.20983607, 0.9846154], np.float32)
    c = np.array([2.0 ** 30, 2.0 ** 30, 2.0 ** 30, -(2.0 ** 30)], np.float32)
    naive = (c.astype(np.float64) + a.astype(np.float64) * b.astype(np.float64)).astype(np.float32)
    got = tfs._fma_f32(*_t(a, b, c)).numpy()
    assert np.all(naive != got)
    np.testing.assert_array_equal(np.abs(got), np.float32(2.0 ** 30 + 128))
    n = 400
    a = rng.integers(-(2 ** 21) + 1, 2 ** 21, n).astype(np.float32)
    b = rng.uniform(1e-3, 1.0, n).astype(np.float32)
    c = rng.uniform(-1e5, 1e5, n).astype(np.float32)
    got = tfs._fma_f32(*_t(a, b, c)).numpy()
    assert all(_correctly_rounded(a[i], b[i], c[i], got[i]) for i in range(n))
    inf = tfs._fma_f32(*_t(a[:3], b[:3], np.full(3, np.inf, np.float32))).numpy()
    assert np.all(inf == np.inf)


def test_int8_dispatch_and_wrapper_errors():
    lof = torch.zeros((1,), dtype=torch.int32)
    q = torch.zeros((1, 8, 16))
    q8 = torch.zeros((1, 8, 16), dtype=torch.int8)
    store = torch.zeros((1, 128, 16))
    st8 = torch.zeros((1, 128, 16), dtype=torch.int8)
    base = torch.zeros((1, 1, 128))
    scale = torch.ones((1, 8, 1))
    with pytest.raises(ValueError, match="strategy"):
        list_scan_select_k(lof, q, store, base, 5, strategy="warpsort")
    with pytest.raises(ValueError, match="q_scale"):
        list_scan_select_k(lof, q8, st8, base, 5, strategy="fused_int8")
    with pytest.raises(ValueError, match="q_scale"):
        list_scan_select_k(lof, q, store, base, 5, strategy="fused", q_scale=scale)
    with pytest.raises(ValueError, match="int8"):
        list_scan_select_k(lof, q, store, base, 5, strategy="fused_int8", q_scale=scale)
    with pytest.raises(ValueError, match="int8"):
        tfs.fused_list_topk_int8(lof, q8, store, base, scale, 5)
    with pytest.raises(ValueError):
        tfs.fused_list_topk_int8(lof, q8, st8, base, scale.double(), 5)
    with pytest.raises(ValueError):
        tfs.fused_list_topk_int8(lof, q8, st8, base, torch.ones((1, 8)), 5)
    with pytest.raises(ValueError):
        tfs.fused_list_topk_int8(lof, q8, st8, base, scale, 200, kbuf=128)
    v, i = list_scan_select_k(lof, q8, st8, base, 5, strategy="fused_int8", q_scale=scale)
    assert v.shape == (1, 8, 128) and torch.all(v[..., :5] == 0)


def test_int8_shared_memory_budget():
    assert tfs.fits_fused_list(3840, 96, 40, q_int8=True)
    assert check_fused_list_request("t", 3840, 96, 40, None, "x", q_int8=True) == 128
    assert not tfs.fits_fused_list(256, 16384, 40, q_int8=True)
    with pytest.raises(ValueError, match="budget"):
        check_fused_list_request("t", 256, 16384, 40, None, "x", q_int8=True)


@pytest.mark.parametrize("pattern", ["short", "holes", "none"])
@pytest.mark.parametrize("ip", [False, True])
def test_fused_list_topk_int8_plain_matches_jax_past_the_last_real_slot(rng, pattern, ip):
    """Bases in the patterns the card kernel's stop at a list's last real
    slot must survive: lists of 5, 40 and 1 real slots in the first tile,
    the later tiles +inf ("short"); whole +inf tiles between real ones
    ("holes"); a list with no real slot ("none"). Values bit for bit and
    every id, the +inf fill in slot order included."""
    _, q8, st, _, rs = _int8_case(rng, ncb=6, chunk=4, L=640, rot=32, n_lists=3)
    lof = np.arange(6, dtype=np.int32) % 3
    base = rng.uniform(0, 1e5, (3, 1, 640)).astype(np.float32)
    if pattern == "short":
        for i, n in enumerate((5, 40, 1)):
            base[i, :, n:] = np.inf
    elif pattern == "holes":
        base[:, :, 128:384] = np.inf
        base[1, :, 512:] = np.inf
    else:
        base[0] = np.inf
    jv, ji = (np.asarray(a) for a in jfs.fused_list_topk_int8(
        lof, q8, st, base, rs, 100, inner_product=ip, interpret=True))
    tv, ti = tfs.fused_list_topk_int8(*_t(lof, q8, st, base, rs), 100, inner_product=ip)
    np.testing.assert_array_equal(tv.numpy().view(np.int32), jv.view(np.int32))
    np.testing.assert_array_equal(ti.numpy(), ji)
