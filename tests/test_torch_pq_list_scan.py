"""PyTorch port: the bin-fold list scan (`ops/pq_list_scan.py`) against
the JAX Pallas kernel in interpret mode.

- Integer-grid data (small integer rows, store and base): every bf16
  product and f32 sum is exact, so values and slots must match bit for
  bit, both folds, f32 and int8 rows, L2 and inner product. int8 rows
  score exactly on any int8 data (`test_torch_fused_int8.py`).
- Gaussian rows: XLA and torch take the f32 sums in another order, so
  values agree to rtol 1e-5 (atol 1e-3 for scores that cancel to near
  zero), and slots match except at a stated near-tie: where they differ,
  the float64 scores of the two slots lie within that tolerance.
- `_pack_scores` / `_unpack_scores` are bitwise the JAX functions on
  +-0, +-inf, subnormals and negatives.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch

from raft_tpu.ops import pq_list_scan as jpls
from raft_tpu_torch.ops import fused_scan as tfs
from raft_tpu_torch.ops import pq_list_scan as tpls


def _case(rng, rows, ncb=6, chunk=8, L=384, rot=24, n_lists=4, inf_frac=0.2, inf_tile=None):
    """rows: "grid" (f32 integer rows), "int8" or "gaussian"."""
    if rows == "int8":
        q = rng.integers(-127, 128, (ncb, chunk, rot)).astype(np.int8)
        st = rng.integers(-127, 128, (n_lists, L, rot)).astype(np.int8)
        base = rng.uniform(0, 1e5, (n_lists, 1, L)).astype(np.float32)
    elif rows == "grid":
        q = rng.integers(-3, 4, (ncb, chunk, rot)).astype(np.float32)
        st = rng.integers(-3, 4, (n_lists, L, rot)).astype(np.int8)
        base = rng.integers(0, 20, (n_lists, 1, L)).astype(np.float32)
    else:
        q = rng.standard_normal((ncb, chunk, rot)).astype(np.float32)
        st = rng.integers(-127, 128, (n_lists, L, rot)).astype(np.int8)
        base = (rng.random((n_lists, 1, L)) * 10).astype(np.float32)
    base[rng.random((n_lists, 1, L)) < inf_frac] = np.inf
    if inf_tile is not None:  # a whole fold of +inf slots
        base[:, :, 128 * inf_tile:128 * (inf_tile + 1)] = np.inf
    lof = rng.integers(0, n_lists, ncb).astype(np.int32)
    rs = rng.uniform(1e-3, 1.0, (ncb, chunk, 1)).astype(np.float32) if rows == "int8" else None
    return lof, q, st, base, rs


def _run_both(case, ip, fold, chunk_rows=None):
    lof, q, st, base, rs = case
    jv, ji = jpls.pq_list_scan(lof, q, st, base, inner_product=ip, interpret=True, fold=fold,
                               q_scale=None if rs is None else jnp.asarray(rs))
    tv, ti = tpls.pq_list_scan(
        *(torch.tensor(a) for a in (lof, q, st, base)), inner_product=ip, fold=fold,
        q_scale=None if rs is None else torch.tensor(rs), chunk_rows=chunk_rows)
    assert tv.shape == (q.shape[0], q.shape[1], 512) and ti.dtype == torch.int32
    return (np.asarray(jv), np.asarray(ji)), (tv.numpy(), ti.numpy())


@pytest.mark.parametrize("fold", ["exact", "packed"])
@pytest.mark.parametrize("rows", ["grid", "int8"])
@pytest.mark.parametrize("ip", [False, True])
@pytest.mark.parametrize("L", [256, 384])
def test_pq_list_scan_plain_equals_jax_exactly(rng, fold, rows, ip, L):
    (jv, ji), (tv, ti) = _run_both(_case(rng, rows, L=L, inf_tile=1 if L == 384 else None),
                                   ip, fold)
    np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("fold", ["exact", "packed"])
@pytest.mark.parametrize("ip", [False, True])
def test_pq_list_scan_plain_matches_jax_on_gaussian(rng, fold, ip):
    case = _case(rng, "gaussian", L=384, rot=24)
    (jv, ji), (tv, ti) = _run_both(case, ip, fold)
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    if fold == "packed":
        # the packed value is a bf16 band's lower bound: a sum one ulp
        # apart can cross into the neighbouring band
        np.testing.assert_allclose(tv[fin], jv[fin], rtol=2.0 ** -7, atol=1e-3)
    else:
        np.testing.assert_allclose(tv[fin], jv[fin], rtol=1e-5, atol=1e-3)
    lof, q, st, base, _ = case
    qb = torch.tensor(q).to(torch.bfloat16).double().numpy()
    diff = np.argwhere((ti != ji) & fin)
    for c, r, j in diff:
        # a stated near-tie: the two slots' float64 scores agree within the tolerance
        coef = 1.0 if ip else 2.0
        s = [base[lof[c], 0, x] - coef * qb[c, r] @ st[lof[c], x].astype(np.float64)
             for x in (ti[c, r, j], ji[c, r, j])]
        tol = (2.0 ** -7 if fold == "packed" else 1e-5) * max(1.0, abs(s[1])) + 1e-3
        assert abs(s[0] - s[1]) <= tol, (c, r, j, s)
    assert len(diff) <= 0.01 * fin.sum()


def test_pq_list_scan_plain_chunk_rows_and_empty_chunks(rng):
    """The port's chunk_rows: rows past a chunk's live count, and every
    row of an empty chunk (count 0), hold (+inf, 0); live rows are the
    JAX kernel's."""
    case = _case(rng, "int8", ncb=5)
    rows = torch.tensor([0, 8, 3, 1, 5], dtype=torch.int32)
    for fold in ("exact", "packed"):
        (jv, ji), (tv, ti) = _run_both(case, False, fold, chunk_rows=rows)
        live = (torch.arange(8)[None, :] < rows[:, None]).numpy()
        np.testing.assert_array_equal(tv[live], jv[live])
        np.testing.assert_array_equal(ti[live], ji[live])
        assert np.all(np.isinf(tv[~live])) and np.all(ti[~live] == 0)


def test_pack_and_unpack_bitwise_equal_to_jax():
    special = np.array([0.0, -0.0, np.inf, -np.inf, 1e-45, -1e-45, 1e-40, -1e-40,
                        1.17549435e-38, -3.5, 3.5, 1e30, -1e30, 65504.0, -1.0, 1.0], np.float32)
    rng = np.random.default_rng(5)
    x = np.concatenate([special, rng.standard_normal(200).astype(np.float32) * 1e3,
                        rng.integers(-(2 ** 31), 2 ** 31 - 1, 200).astype(np.int32).view(
                            np.float32)])
    x = x[~np.isnan(x)]
    folds = (np.arange(x.size) % 40).astype(np.int32)
    jp = np.asarray(jpls._pack_scores(jnp.asarray(x), jnp.asarray(folds)))
    tp = tpls._pack_scores(torch.tensor(x), torch.tensor(folds)).numpy()
    np.testing.assert_array_equal(tp, jp)
    jv, jf = (np.asarray(a) for a in jpls._unpack_scores(jnp.asarray(jp)))
    tv, tf = (a.numpy() for a in tpls._unpack_scores(torch.tensor(tp)))
    np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))
    np.testing.assert_array_equal(tf, jf)
    np.testing.assert_array_equal(tf, folds)
    # the band's lower bound (-inf, which no score takes, unpacks to NaN
    # in both packages)
    fin = np.isfinite(x)
    assert np.all(tv[fin] <= x[fin]) and np.all(np.isnan(tv[x == -np.inf]))
    # the high 16 bits keep the score order (-0.0 below +0.0); the fold id
    # orders scores within one band
    order = np.lexsort((~np.signbit(x), x))
    assert np.all(np.diff(tp[order] >> 16) >= 0)


def test_wrapper_errors_constants_and_budget():
    lof = torch.zeros((2,), dtype=torch.int32)
    q = torch.zeros((2, 4, 8))
    q8 = torch.zeros((2, 4, 8), dtype=torch.int8)
    st8 = torch.zeros((1, 256, 8), dtype=torch.int8)
    base = torch.zeros((1, 1, 256))
    rs = torch.ones((2, 4, 1))
    bad = [
        dict(qres_s=q8, q_scale=None),                          # int8 rows need q_scale
        dict(qres_s=q, q_scale=rs),                             # q_scale needs int8 rows
        dict(qres_s=q8, q_scale=rs, store=st8.float()),         # ... and an int8 store
        dict(qres_s=q8, q_scale=rs.double()),                   # q_scale dtype
        dict(qres_s=q8, q_scale=torch.ones((2, 4))),            # q_scale shape
        dict(qres_s=q, fold="fast"),                            # unknown fold
        dict(qres_s=q, store=torch.zeros((1, 128, 8)), base=torch.zeros((1, 1, 128))),  # L < 256
        dict(qres_s=q, store=torch.zeros((1, 300, 8)), base=torch.zeros((1, 1, 300))),  # L % 128
        dict(qres_s=q, base=torch.zeros((1, 1, 128))),          # base shape
        dict(qres_s=q, lof=lof.long()),                         # lof dtype
    ]
    for kw in bad:
        args = dict(lof=lof, store=st8, base=base, q_scale=None, fold="exact")
        args.update(kw)
        with pytest.raises(ValueError):
            tpls.pq_list_scan(args.pop("lof"), args.pop("qres_s"), args.pop("store"),
                              args.pop("base"), inner_product=False, **args)
    assert (tpls._LANES, tpls._BINS, tpls._CANDS) == (128, 256, 512)
    assert tpls.fold_variant() == "exact"
    for w in (1, 128, 255, 257, 1000, 3839):
        assert tpls.lane_padded(w) == jpls.lane_padded(w)
    assert tpls.fits_pq_list_scan(3840, 96) and tpls.fits_pq_list_scan(3840, 96, q_int8=True)
    assert not tpls.fits_pq_list_scan(128, 96)      # fewer than 256 slots
    assert not tpls.fits_pq_list_scan(300, 96)      # not a multiple of 128
    assert not tpls.fits_pq_list_scan(256, 8192)    # rows too wide for 227 KB
    assert "pq_list_scan" in tfs.launch_counts()


# -- the card kernel's stop at a list's last real slot ----------------------


def _fold_smem_bytes(rot: int, q_int8: bool) -> int:
    """One kernel block's shared memory, counted here from the layout of
    csrc/list_scan_tc.cuh (TcLayout) as the kernel uses it: 1024 bytes of
    alignment slack; the store stages (two for int8 rows of whole 16-byte
    rows, which TMA fills, else one), 128 slots x 128-byte chunks of bf16
    or int8 columns each; the 16 query rows in the same chunks; the score
    tile's 16 x 132 floats (scratch here) and 16 row scales; 8 bytes of
    barrier a stage; rounded up to 16 bytes. No row lists: the bins live
    in registers."""
    unit = 16 if q_int8 else 8                       # columns a 16-byte unit
    chunks = -(-(-(-rot // unit)) // 8)              # 128-byte chunks a row
    stages = 2 if q_int8 and rot % 16 == 0 else 1
    body = (stages * 128 + 16) * chunks * 128 + 4 * 16 * (132 + 1) + 8 * stages
    return 1024 + -(-body // 16) * 16


@pytest.mark.parametrize("q_int8", [False, True])
@pytest.mark.parametrize("rot", [33, 40, 64, 96, 100, 128])
@pytest.mark.parametrize("L", [256, 384, 640, 1280, 3840])
def test_fits_pq_list_scan_follows_the_kernel_layout(L, rot, q_int8):
    smem = _fold_smem_bytes(rot, q_int8)
    assert tpls._fold_smem_bytes(rot, q_int8) == smem
    assert tpls.fits_pq_list_scan(L, rot, q_int8) == (smem <= tfs.SMEM_LIMIT)
    # three blocks an SM (228 KB, 1 KB of it reserved a block) at every
    # width the engines use
    assert 3 * (smem + 1024) <= 228 * 1024
    assert not tpls.fits_pq_list_scan(L + 64, rot, q_int8)  # L % 128


def test_fits_pq_list_scan_rejects_rows_past_the_block():
    for q_int8 in (False, True):
        widest = max(r for r in range(1, 4096) if _fold_smem_bytes(r, q_int8) <= tfs.SMEM_LIMIT)
        assert tpls.fits_pq_list_scan(3840, widest, q_int8)
        assert not tpls.fits_pq_list_scan(3840, widest + 1, q_int8)
    assert not tpls.fits_pq_list_scan(128 * 0x10000, 96)  # fold ids past 16 bits


#: where the real slots of the lists of `_stop_case` end: the kernel scans
#: up to the end of the last one (rounded up to 64) and fills the folds
#: past it by rule
_ENDS = (0, 1, 63, 64, 65, 127, 129, 383)


def _stop_case(rng, rows, L=384, rot=16, chunk=4):
    """Lists whose real slots end at each of _ENDS, and three with
    tombstone runs before their end (whole +inf folds between real ones,
    a run across a fold boundary, the first fold +inf), each probed by
    two chunks; rows "grid" (f32 integer rows) or "int8"."""
    n_lists = len(_ENDS) + 3
    fin = np.ones((n_lists, L), bool)
    for i, e in enumerate(_ENDS):
        fin[i, e:] = False
    t = len(_ENDS)
    fin[t, 128:256] = False
    fin[t, 300:] = False
    fin[t + 1, 100:200] = False
    fin[t + 2, :128] = False
    ncb = 2 * n_lists
    lof = (np.arange(ncb) % n_lists).astype(np.int32)
    if rows == "int8":
        q = rng.integers(-127, 128, (ncb, chunk, rot)).astype(np.int8)
        st = rng.integers(-127, 128, (n_lists, L, rot)).astype(np.int8)
        base = rng.uniform(0, 1e5, (n_lists, 1, L)).astype(np.float32)
        rs = rng.uniform(1e-3, 1.0, (ncb, chunk, 1)).astype(np.float32)
    else:
        q = rng.integers(-3, 4, (ncb, chunk, rot)).astype(np.float32)
        st = rng.integers(-3, 4, (n_lists, L, rot)).astype(np.int8)
        base = rng.integers(0, 20, (n_lists, 1, L)).astype(np.float32)
        rs = None
    base[~fin[:, None, :]] = np.inf
    return lof, q, st, base, rs


@pytest.mark.parametrize("fold", ["exact", "packed"])
@pytest.mark.parametrize("rows", ["grid", "int8"])
@pytest.mark.parametrize("ip", [False, True])
def test_pq_list_scan_plain_equals_jax_past_the_last_real_slot(rng, fold, rows, ip):
    """The inputs on which the card kernel's stop at a list's last real slot
    and its fill of the unscanned folds could go wrong (chip_smoke.py phase
    3 runs the kernel on the same patterns): both packages bit for bit,
    every candidate, +inf ones and their slots too."""
    (jv, ji), (tv, ti) = _run_both(_stop_case(rng, rows), ip, fold)
    np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))
    np.testing.assert_array_equal(ti, ji)
    # a list without a real slot: the exact fold holds (+inf, 0) in every
    # bin; the packed fold takes each bank's two smallest +inf folds
    assert np.all(np.isinf(tv[0])) and np.all(np.isinf(tv[len(_ENDS) + 3]))
    if fold == "exact":
        assert np.all(ti[0] == 0)
    else:
        lane = np.arange(128)
        np.testing.assert_array_equal(ti[0, :, :128], np.broadcast_to(lane, (4, 128)))
        np.testing.assert_array_equal(ti[0, :, 128:256], np.broadcast_to(128 + lane, (4, 128)))
        np.testing.assert_array_equal(ti[0, :, 256:384], np.broadcast_to(256 + lane, (4, 128)))
        assert np.all(ti[0, :, 384:] == 0)  # bank 1 has one fold at L 384
