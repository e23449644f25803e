"""PyTorch port: the fused scan kernels' plain versions against the JAX
Pallas kernels (run in interpret mode, as tests/test_fused_scan.py runs
them).

On bf16-exact integer-grid data every product and sum is exact in f32,
so ids and values must match exactly. On gaussian data the f32 sums are
taken in another order by XLA and by torch, so ids must agree in at least
99% of slots and values to rtol 1e-5 where the ids agree (atol 1e-4
covers scores that cancel to near zero).

Exhausted slots hold +inf in both packages. Their ids are compared only
where the value is finite: the JAX flat kernel pads the dataset to its
512-row tile, and those pad columns (+inf base) fill the exhausted slots
with their own column ids, where the port writes the sentinel.
"""

import numpy as np
import pytest

import torch

from raft_tpu.ops import fused_scan as jfs
from raft_tpu_torch.ops import fused_scan as tfs


def _grid(rng, shape, lo=-4, hi=5):
    return rng.integers(lo, hi, shape).astype(np.float32)


def _compare(jax_out, port_out, exact):
    jv, ji = (np.asarray(a) for a in jax_out)
    tv, ti = (a.numpy() for a in port_out)
    assert tv.shape == jv.shape and ti.dtype == np.int32
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    if exact:
        np.testing.assert_array_equal(ti[fin], ji[fin])
        np.testing.assert_array_equal(tv, jv)
        return
    same = ti == ji
    assert same[fin].mean() >= 0.99, same[fin].mean()
    np.testing.assert_allclose(tv[fin & same], jv[fin & same], rtol=1e-5, atol=1e-4)


# -- flat scan: fused_topk --------------------------------------------------


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("ip", [False, True])
def test_fused_topk_plain_matches_jax_on_grid(rng, k, ip):
    x = _grid(rng, (37, 40))   # ragged m and d
    y = _grid(rng, (1000, 40))  # ragged n: not a multiple of the JAX tile
    jout = jfs.fused_topk(x, y, k, inner_product=ip, interpret=True)
    tout = tfs.fused_topk(torch.tensor(x), torch.tensor(y), k, inner_product=ip)
    _compare(jout, tout, exact=True)


def test_fused_topk_plain_fewer_rows_than_k(rng):
    x, y = _grid(rng, (5, 8)), _grid(rng, (50, 8))
    jout = jfs.fused_topk(x, y, 100, interpret=True)
    tv, ti = tfs.fused_topk(torch.tensor(x), torch.tensor(y), 100)
    _compare(jout, (tv, ti), exact=True)
    assert np.all(ti.numpy()[:, 50:] == tfs._ID_SENTINEL)


@pytest.mark.parametrize("ip", [False, True])
def test_fused_topk_plain_matches_jax_on_gaussian(rng, ip):
    x = rng.standard_normal((64, 96)).astype(np.float32)
    y = rng.standard_normal((3000, 96)).astype(np.float32)
    jout = jfs.fused_topk(x, y, 10, inner_product=ip, interpret=True)
    tout = tfs.fused_topk(torch.tensor(x), torch.tensor(y), 10, inner_product=ip)
    _compare(jout, tout, exact=False)


def _straddling_grid(rng, m, n, d, range_len):
    """Integer-grid rows with copies of the rows on both sides of every
    boundary between n ranges of `range_len`, and of row 0 at n // 3 and
    n - 1: ties whose smaller id lies in another range."""
    x, y = _grid(rng, (m, d)), _grid(rng, (n, d))
    for b in range(range_len, n, range_len):
        y[b - 2:b + 3] = y[b - 2]
    y[n // 3] = y[n - 1] = y[0]
    return x, y


@pytest.mark.parametrize("k,ip", [(1, False), (10, True), (33, False), (129, True)])
def test_fused_topk_plain_matches_jax_with_ties_across_n_ranges(rng, k, ip):
    plan = tfs.flat_plan(20, 2000, 24, k, num_sms=132)
    assert plan.n_ranges > 1
    x, y = _straddling_grid(rng, 20, 2000, 24, plan.range_len)
    jout = jfs.fused_topk(x, y, k, inner_product=ip, interpret=True)
    tout = tfs.fused_topk(torch.tensor(x), torch.tensor(y), k, inner_product=ip)
    _compare(jout, tout, exact=True)


@pytest.mark.parametrize("n_ranges,range_len", [(16, 128), (3, 768), (1, 2048), (40, 128)])
@pytest.mark.parametrize("k", [1, 10, 100])
def test_range_split_and_merge_twin_matches_jax(rng, n_ranges, range_len, k):
    """The card's split of the dataset into n ranges, each range's k best,
    then a lexicographic merge of the lists: equal to the JAX kernel,
    ids and values, on ties that straddle the ranges (and with ranges
    past the dataset's end, or shorter than k)."""
    n, ip = 1900, k == 10
    x, y = _straddling_grid(rng, 9, n, 16, range_len)
    xb, yb = tfs._bf16(torch.tensor(x)), torch.tensor(y).to(torch.bfloat16)
    base = torch.zeros(n) if ip else (yb.float() ** 2).sum(1)
    got = tfs.fused_topk_ranges_plain(xb, yb, base, k, tfs.fused_kbuf(k), ip, n_ranges,
                                      range_len)
    jout = jfs.fused_topk(x, y, k, inner_product=ip, interpret=True)
    _compare(jout, got, exact=True)


def test_merge_twin_keeps_sentinels_past_the_candidates():
    ws_v = torch.tensor([[[1.0, 3.0, np.inf], [1.0, 2.0, np.inf]]])
    ws_i = torch.tensor([[[7, 9, tfs._ID_SENTINEL], [4, 8, tfs._ID_SENTINEL]]], dtype=torch.int32)
    v, i = tfs.merge_ranges_plain(ws_v, ws_i, 3, 5)
    assert v.tolist() == [[1.0, 1.0, 2.0, np.inf, np.inf]]
    assert i.tolist() == [[4, 7, 8, tfs._ID_SENTINEL, tfs._ID_SENTINEL]]
    v, i = tfs.merge_ranges_plain(ws_v[:, :1], ws_i[:, :1], 3, 4)  # fewer candidates than k
    assert i.tolist() == [[7, 9, tfs._ID_SENTINEL, tfs._ID_SENTINEL]]


@pytest.mark.parametrize("m,n,d,k,num_sms,want", [
    # the main path: 32 query blocks x 4 ranges fill 128 of 132 SMs
    (4096, 1 << 20, 96, 10, 132, ("wgmma", 128, 4, 262144, (4096, 4, 10))),
    # k past a 128-row block's heaps: 64 rows a block, twice the blocks
    (4096, 1 << 20, 96, 88, 132, ("wgmma", 128, 4, 262144, (4096, 4, 88))),
    (4096, 1 << 20, 96, 89, 132, ("wgmma", 64, 2, 524288, (4096, 2, 89))),
    (4096, 1 << 20, 96, 216, 132, ("wgmma", 64, 2, 524288, (4096, 2, 216))),
    # heaps too deep for either block: the CUDA-core kernel
    (4096, 1 << 20, 96, 217, 132, ("simt", 16, 1, 1 << 20, None)),
    (16, 100, 4096, 256, 132, ("simt", 16, 1, 128, None)),
    # one query block: as many ranges as SMs, at most 128, at least a tile each
    (1, 1 << 20, 96, 10, 132, ("wgmma", 128, 128, 8192, (1, 128, 10))),
    (129, 1000, 96, 10, 132, ("wgmma", 128, 8, 128, (129, 8, 10))),
    (5, 50, 8, 100, 132, ("wgmma", 128, 1, 128, (5, 1, 100))),
    # more query blocks than SMs: one range
    (65536, 1 << 20, 96, 10, 132, ("wgmma", 128, 1, 1 << 20, (65536, 1, 10))),
])
def test_flat_plan(m, n, d, k, num_sms, want):
    plan = tfs.flat_plan(m, n, d, k, num_sms)
    assert (plan.variant, plan.rows, plan.n_ranges, plan.range_len, plan.workspace) == want
    if plan.variant == "wgmma":
        assert tfs._tc_smem_bytes(plan.dp, k, plan.rows) <= tfs.SMEM_LIMIT
        assert plan.range_len % 128 == 0 and (plan.n_ranges - 1) * plan.range_len < n
        assert plan.n_ranges * plan.range_len >= n and plan.dp % 8 == 0 and plan.dp >= d


def test_flat_plan_pads_rows_to_the_kernel_loads():
    assert tfs.flat_plan(8, 100, 33, 5, 132).dp == 40
    assert tfs.flat_plan(8, 100, 96, 5, 132).dp == 96
    # bytes: 1024 slack, 2 chunks x 128 B x (128 query + 3 x 128 dataset rows),
    # 3 x 128 base floats and 2 barriers each, 128 heaps of k 10 pairs, 8 warps'
    # queues of 128 pairs
    assert tfs._tc_smem_bytes(96, 10, 128) == (1024 + 2 * 128 * 512 + 1536 + 48 + 128 * 80
                                               + 8 * 1024)


# -- list scan: fused_list_topk ---------------------------------------------


def _list_case(rng, ncb, chunk, L, rot, n_lists, store_dtype, grid, inf_frac=0.1,
               with_valid=False):
    if grid:
        q = _grid(rng, (ncb, chunk, rot))
        st = _grid(rng, (n_lists, L, rot))
    else:
        q = rng.standard_normal((ncb, chunk, rot)).astype(np.float32)
        st = rng.standard_normal((n_lists, L, rot)) * (30.0 if store_dtype == "int8" else 1.0)
    if store_dtype == "int8":
        st = np.clip(np.round(st), -127, 127).astype(np.int8)
    else:
        st = st.astype(np.float32)
        if store_dtype == "bf16":
            st = torch.tensor(st).to(torch.bfloat16).float().numpy()  # bf16-exact
    base = rng.integers(0, 20, (n_lists, 1, L)).astype(np.float32)
    base[rng.random((n_lists, 1, L)) < inf_frac] = np.inf
    lof = rng.integers(0, n_lists, ncb).astype(np.int32)
    cv = (rng.random(ncb) < 0.6).astype(np.int32) if with_valid else None
    return lof, q, st, base, cv


def _run_both(lof, q, st, base, cv, k, ip, store_dtype):
    import jax.numpy as jnp

    jst = jnp.asarray(st, jnp.bfloat16) if store_dtype == "bf16" else st
    jout = jfs.fused_list_topk(lof, q, jst, base, k, inner_product=ip, interpret=True,
                               chunk_valid=None if cv is None else jnp.asarray(cv))
    tst = torch.tensor(st)
    if store_dtype == "bf16":
        tst = tst.to(torch.bfloat16)
    tout = tfs.fused_list_topk(torch.tensor(lof), torch.tensor(q), tst, torch.tensor(base),
                               k, inner_product=ip,
                               chunk_valid=None if cv is None else torch.tensor(cv))
    return jout, tout


@pytest.mark.parametrize("k", [1, 10, 100])
@pytest.mark.parametrize("ip", [False, True])
@pytest.mark.parametrize("store_dtype", ["int8", "bf16", "f32"])
def test_fused_list_topk_plain_matches_jax_on_grid(rng, k, ip, store_dtype):
    case = _list_case(rng, ncb=6, chunk=8, L=256, rot=33, n_lists=4,
                      store_dtype=store_dtype, grid=True)
    _compare(*_run_both(*case, k, ip, store_dtype), exact=True)


def test_fused_list_topk_plain_empty_chunks_and_inf_slots(rng):
    """chunk_valid zeros write (+inf, sentinel); half the slots carry a
    +inf base, so k passes run past the finite candidates."""
    case = _list_case(rng, ncb=9, chunk=4, L=128, rot=16, n_lists=3, store_dtype="f32",
                      grid=True, inf_frac=0.5, with_valid=True)
    jout, tout = _run_both(*case, 100, False, "f32")
    _compare(jout, tout, exact=True)
    dead = case[4] == 0
    assert np.all(np.isinf(tout[0].numpy()[dead]))
    assert np.all(tout[1].numpy()[dead] == tfs._ID_SENTINEL)


def test_fused_list_topk_plain_chunk_of_one(rng):
    """refine's geometry: one query row per chunk, one list per query."""
    case = _list_case(rng, ncb=12, chunk=1, L=128, rot=96, n_lists=12, store_dtype="bf16",
                      grid=True)
    _compare(*_run_both(*case, 10, False, "bf16"), exact=True)


def test_fused_list_topk_plain_skips_rows_past_chunk_rows(rng):
    """The port's chunk_rows operand: rows at or past chunk_rows[i] hold
    (+inf, sentinel); the live rows are unchanged; chunk_valid still
    empties whole chunks."""
    lof, q, st, base, cv = _list_case(rng, ncb=7, chunk=8, L=256, rot=16, n_lists=3,
                                      store_dtype="f32", grid=True, with_valid=True)
    args = [torch.tensor(a) for a in (lof, q, st, base)]
    rows = torch.tensor([0, 8, 3, 1, 5, 12, 7], dtype=torch.int32)
    full = tfs.fused_list_topk(*args, 10)
    part = tfs.fused_list_topk(*args, 10, chunk_rows=rows, chunk_valid=torch.tensor(cv))
    live = (torch.arange(8)[None, :] < rows[:, None]) & (torch.tensor(cv) != 0)[:, None]
    for got, ref, empty in zip(part, full, (float("inf"), tfs._ID_SENTINEL)):
        assert torch.equal(got[live], ref[live])
        assert torch.all(got[~live] == empty)


@pytest.mark.parametrize("ip", [False, True])
def test_fused_list_topk_plain_matches_jax_on_gaussian(rng, ip):
    case = _list_case(rng, ncb=8, chunk=16, L=384, rot=96, n_lists=5, store_dtype="int8",
                      grid=False, with_valid=True)
    _compare(*_run_both(*case, 40, ip, "int8"), exact=False)


# -- envelopes and buffer widths --------------------------------------------


def test_kbuf_and_lane_padding_match_jax():
    from raft_tpu.ops.pq_list_scan import lane_padded as jax_lane_padded
    from raft_tpu_torch.ops.pq_list_scan import lane_padded

    for k in (1, 128, 129, 256):
        assert tfs.fused_kbuf(k) == jfs.fused_kbuf(k)
    for w in (1, 128, 255, 257, 1000):
        assert lane_padded(w) == jax_lane_padded(w)
    with pytest.raises(ValueError):
        tfs.fused_kbuf(257)


def test_shared_memory_envelopes():
    # main-path geometries fit one Hopper block; lists of any length
    # stream through
    assert tfs.fits_fused_list(3840, 96, 40)
    assert tfs.fits_fused_list(128, 96, 10)
    assert tfs.fits_fused_list(1 << 16, 96, 256)
    assert tfs.fits_fused(4096, 1_000_000, 96, 10)
    # rows too wide for 227 KB, a ragged L, a narrow kbuf
    assert not tfs.fits_fused_list(256, 4096, 256)
    assert not tfs.fits_fused_list(200, 96, 40)
    assert not tfs.fits_fused_list(256, 96, 200, kbuf=128)
    assert not tfs.fits_fused(16, 100, 4096, 256)


# -- the card kernels' stop at a list's last real slot ---------------------


def _stop_bases(rng, L, pattern):
    """(3, 1, L) integer bases in the patterns the card kernels' stop at a
    list's last real slot must survive (csrc/list_scan_tc.cuh): "short"
    lists of 5, 40 and 1 real slots, all in the first tile, the later tiles
    +inf; "holes" whole +inf tiles between real tiles; "none" a list
    without a real slot beside two full ones."""
    base = rng.integers(0, 20, (3, 1, L)).astype(np.float32)
    if pattern == "short":
        for i, n in enumerate((5, 40, 1)):
            base[i, :, n:] = np.inf
    elif pattern == "holes":
        base[:, :, 128:384] = np.inf
        base[1, :, 512:] = np.inf
    else:
        base[0] = np.inf
    return base


def _compare_every_id(jax_out, port_out):
    """Values bit for bit and every id, +inf slots too: past a list's real
    slots both fill the rows with its +inf slots in slot order, then the
    sentinel."""
    (jv, ji), (tv, ti) = (np.asarray(a) for a in jax_out), (a.numpy() for a in port_out)
    np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("pattern", ["short", "holes", "none"])
@pytest.mark.parametrize("store_dtype,ip", [("int8", False), ("bf16", True), ("f32", False)])
def test_fused_list_topk_plain_matches_jax_past_the_last_real_slot(rng, pattern, store_dtype,
                                                                   ip):
    lof, q, st, _, _ = _list_case(rng, ncb=6, chunk=4, L=640, rot=33, n_lists=3,
                                  store_dtype=store_dtype, grid=True)
    lof = np.arange(6, dtype=np.int32) % 3
    base = _stop_bases(rng, 640, pattern)
    jout, tout = _run_both(lof, q, st, base, None, 100, ip, store_dtype)
    _compare_every_id(jout, tout)


def test_fused_list_topk_plain_fills_past_a_short_list_with_the_sentinel(rng):
    """k past the list's length: its +inf slots in slot order, then the
    sentinel, in both packages."""
    lof, q, st, _, _ = _list_case(rng, ncb=3, chunk=4, L=128, rot=16, n_lists=3,
                                  store_dtype="f32", grid=True)
    lof = np.arange(3, dtype=np.int32)
    jout, tout = _run_both(lof, q, st, _stop_bases(rng, 128, "short"), None, 200, False, "f32")
    _compare_every_id(jout, tout)
    ti = tout[1].numpy()
    np.testing.assert_array_equal(ti[0, :, 5:128], np.broadcast_to(np.arange(5, 128), (4, 123)))
    assert np.all(ti[:, :, 128:] == tfs._ID_SENTINEL)


def test_list_kernel_shared_memory_at_the_main_path_shapes():
    """The list kernels' blocks (csrc/list_scan_tc.cuh) fit at the main
    path's shapes for every k, and at the trim's k 40 leave room for three
    blocks an SM (228 KB, 1 KB of it reserved a block). Register lists (k
    <= 32) take no shared memory; past k 32 a row's list and its buffer
    of 128 pairs do, the list 64, 128 or 256 pairs as k needs."""
    for q_int8 in (False, True):
        for k in (10, 32, 33, 40, 64, 128, 250, 256):
            assert tfs.fits_fused_list(3840, 96, k, q_int8=q_int8)
        assert 3 * (tfs._list_tc_smem_bytes(96, q_int8, 40) + 1024) <= 228 * 1024
        regs = tfs._list_tc_smem_bytes(96, q_int8, 32)
        for k, width in ((33, 64), (64, 64), (65, 128), (129, 256), (256, 256)):
            assert tfs._list_tc_smem_bytes(96, q_int8, k) == regs + 16 * (width + 128) * 8
    # refine: chunk 1, L 128, bf16 rows, k 10
    assert tfs.fits_fused_list(128, 96, 10)


@pytest.mark.parametrize("k,words", [(40, 389), (100, 373), (250, 341)])
def test_bitplane_envelope_follows_the_list_width(k, words):
    """At 8 query bits the widest rotation the CUDA-core bit-plane scan
    held grew as the list narrowed with k (64, 128, 256 pairs): 389, 373
    and 341 code words. The K-blocked tensor-core scan admits those and
    past them; what follows the list width now is the widest rotation
    whose query levels stay resident in shared memory (352, 336 and 322
    words: 88 and 84 K-blocks of 4 words, then 161 of 2 with the 256-pair
    lists), past which they stream."""
    assert tfs.fits_fused_bitplane(256, words, 8, k)
    assert tfs.fits_fused_bitplane(256, words + 1, 8, k)
    assert tfs.fits_fused_bitplane(4992, 3, 8, k)
    edge = {40: 352, 100: 336, 250: 322}[k]
    assert tfs.bitplane_resident(edge, k) and not tfs.bitplane_resident(edge + 1, k)
    assert tfs.bitplane_resident(3, k)
