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
