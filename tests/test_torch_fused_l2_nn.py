"""PyTorch port: fused L2 1-NN (`ops.fused_l2_argmin` and the public
`distance.fused_l2_nn`) against the JAX package on the same numpy inputs.

The JAX side is the Pallas kernel `fused_l2_argmin_pallas` in interpret
mode (the function the CUDA kernel replaces) and the public
`fused_l2_nn`, which on the CPU runs the JAX package's blocked XLA form.

- Integer-grid data: every distance is exact in f32 in both packages, so
  ids (ties to the lowest index included) and distances must be equal.
- Gaussian data: distances to rtol 1e-5 (the dots add in another order);
  ids equal except at near-ties, where the two candidates' float64
  distances lie within that tolerance of each other.
- Duplicate rows of y take the lowest index; candidates that round below
  zero all clamp to 0.0 BEFORE the comparison, so the lowest of them wins
  even when a later one rounds further below.
"""

import numpy as np
import pytest

import torch

from raft_tpu.distance.fused_l2_nn import fused_l2_nn as jax_fused_l2_nn
from raft_tpu.distance.fused_l2_nn import fused_l2_nn_argmin as jax_fused_l2_nn_argmin
from raft_tpu.ops.fused_l2_argmin import fused_l2_argmin_pallas
from raft_tpu_torch.distance import fused_l2_nn, fused_l2_nn_argmin
from raft_tpu_torch.ops import fused_l2_argmin as tfa


def _jax_kernel(x, y, sqrt=False):
    d, i = fused_l2_argmin_pallas(x, y, bm=16, bn=128, sqrt=sqrt, interpret=True)
    return np.asarray(d), np.asarray(i)


def _port_plain(x, y, sqrt=False):
    d, i = tfa.fused_l2_argmin(torch.tensor(x), torch.tensor(y), sqrt=sqrt)
    assert d.dtype == torch.float32 and i.dtype == torch.int32
    return d.numpy(), i.numpy()


def _assert_ids_up_to_near_ties(x, y, got, want, rtol=1e-5):
    bad = np.nonzero(got != want)[0]
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    for r in bad:
        da = ((x64[r] - y64[got[r]]) ** 2).sum()
        db = ((x64[r] - y64[want[r]]) ** 2).sum()
        assert abs(da - db) <= rtol * max(da, db, 1.0), (r, got[r], want[r], da, db)
    assert len(bad) <= max(1, len(got) // 100)


@pytest.mark.parametrize("sqrt", [False, True])
@pytest.mark.parametrize("m,n,k", [(70, 300, 12), (33, 1, 5), (16, 129, 1)])
def test_plain_matches_jax_kernel_on_grid(rng, m, n, k, sqrt):
    x = rng.integers(-3, 4, (m, k)).astype(np.float32)
    y = rng.integers(-3, 4, (n, k)).astype(np.float32)
    y[n // 2:] = y[:n - n // 2]  # duplicate rows: the lower index must win
    jd, ji = _jax_kernel(x, y, sqrt)
    td, ti = _port_plain(x, y, sqrt)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(td, jd)


@pytest.mark.parametrize("sqrt", [False, True])
def test_plain_matches_jax_kernel_on_gaussian(rng, sqrt):
    x = rng.standard_normal((150, 24)).astype(np.float32)
    y = rng.standard_normal((333, 24)).astype(np.float32)
    jd, ji = _jax_kernel(x, y, sqrt)
    td, ti = _port_plain(x, y, sqrt)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-6)
    _assert_ids_up_to_near_ties(x, y, ti, ji)


def test_public_fused_l2_nn_matches_jax(rng):
    x = rng.standard_normal((120, 16)).astype(np.float32) * 3
    y = rng.standard_normal((257, 16)).astype(np.float32) * 3
    jd, ji = (np.asarray(a) for a in jax_fused_l2_nn(x, y))
    td, ti = fused_l2_nn(x, y, device="cpu")
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5, atol=1e-5)
    _assert_ids_up_to_near_ties(x, y, ti.numpy(), ji)
    ja = np.asarray(jax_fused_l2_nn_argmin(x, y, sqrt=True))
    ta = fused_l2_nn_argmin(x, y, sqrt=True, device="cpu")
    assert ta.dtype == torch.int32
    _assert_ids_up_to_near_ties(x, y, ta.numpy(), ja)
    gx, gy = np.round(x), np.round(y)
    np.testing.assert_array_equal(fused_l2_nn_argmin(gx, gy, device="cpu").numpy(),
                                  np.asarray(jax_fused_l2_nn_argmin(gx, gy)))


def test_duplicate_rows_take_the_lowest_index(rng):
    y = rng.standard_normal((300, 8)).astype(np.float32)
    y[130] = y[5]
    y[257] = y[5]
    x = y[[5, 130, 257, 7]]
    jd, ji = _jax_kernel(x, y)
    td, ti = _port_plain(x, y)
    assert ti.tolist() == ji.tolist() == [5, 5, 5, 7]
    np.testing.assert_array_equal(td, jd)


def test_candidates_that_round_below_zero_clamp_before_the_comparison():
    """x = 1 + 2^-12 against y = x + j ulp: the later candidates' raw
    values round to -2^-23, below the first ones' 0.0; after the clamp all
    tie at 0.0 and index 0 wins in both packages."""
    x0 = np.float32(1 + 2**-12)
    y = (x0 + np.arange(-40, 41, dtype=np.float32) * np.float32(2**-23))[:, None]
    x = np.array([[x0]], np.float32)
    xt, yt = torch.tensor(x), torch.tensor(y)
    xn, yn, y2 = tfa._norms(xt, yt)
    raw = (xn[:, None] + (yn[None, :] + xt @ y2.T))[0]
    assert float(raw[0]) == 0.0 and float(raw.min()) < 0.0 and int(raw.argmin()) > 0
    jd, ji = _jax_kernel(x, y)
    td, ti = _port_plain(x, y)
    assert ti.tolist() == ji.tolist() == [0]
    assert td.tolist() == jd.tolist() == [0.0]


def test_plain_blocks_rows_of_x(rng):
    x = rng.integers(-3, 4, (50, 6)).astype(np.float32)
    y = rng.integers(-3, 4, (40, 6)).astype(np.float32)
    xt, yt = torch.tensor(x), torch.tensor(y)
    whole = tfa.fused_l2_argmin_plain(xt, yt)
    blocked = tfa.fused_l2_argmin_plain(xt, yt, budget_elems=7 * 40)
    for a, b in zip(whole, blocked):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_fused_l2_nn_validates_like_jax(rng):
    x = rng.standard_normal((4, 3)).astype(np.float32)
    with pytest.raises(ValueError):
        fused_l2_nn(x, x[:, :2], device="cpu")
    with pytest.raises(ValueError):
        fused_l2_nn_argmin(x, x[:0], device="cpu")
    with pytest.raises(ValueError):
        fused_l2_nn(x[0], x, device="cpu")
    with pytest.raises(ValueError, match="cpu or cuda"):
        meta = torch.empty((4, 3), device="meta")
        tfa.fused_l2_argmin(meta, meta)


# --- a CPU model of the kernel's split-TF32 arithmetic ----------------------
#
# The CUDA kernel computes each dot on the tensor cores as three TF32
# products (lo.hi + hi.lo, then hi.hi) per depth step of 8, adds each
# step's result into an f32 sum that starts at |y|^2, then clamps
# |x|^2 + sum at 0, |x|^2 summed in its own order (one wgmma kernel at
# every depth). The model below repeats that arithmetic on the CPU,
# with the tensor cores' rounding of an accumulation unknown: each mma is
# its exact sum rounded once, to nearest ("rn") or toward zero ("rz", the
# pessimistic reading). It must hold chip_smoke.py's tolerance against the
# plain version on every data kind the card sees, and equal it bit for bit
# on integer grids, before the card is asked.


def _tf32_bits(a):
    """Round f32 values to TF32 on their bits: to nearest, ties away from
    zero, the low 13 bits cleared (cvt.rna.tf32.f32)."""
    b = np.ascontiguousarray(a, np.float32).view(np.uint32)
    return ((b + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(a):
    hi = _tf32_bits(a)
    return hi, _tf32_bits((a - hi).astype(np.float32))


def _round(v, mode):
    r = v.astype(np.float32)
    if mode == "rz":
        over = np.abs(r.astype(np.float64)) > np.abs(v)
        r = np.where(over, np.nextafter(r, np.float32(0)), r)
    return r


def _kernel_xn(xp):
    """|x|^2 as the kernel sums it: one f32 fused multiply-add a column, in
    column order."""
    s = np.zeros(xp.shape[0], np.float32)
    for c in range(xp.shape[1]):
        v = xp[:, c].astype(np.float64)
        s = (s.astype(np.float64) + v * v).astype(np.float32)
    return s


def _split_tf32_model(x, y, mode):
    """(dist, idx) of the kernel's arithmetic on the CPU."""
    xt, yt = torch.tensor(x), torch.tensor(y)
    _, yn, y2 = (t.numpy() for t in tfa._norms(xt, yt))
    k = x.shape[1]
    kp = -(-k // 8) * 8
    xp = np.zeros((x.shape[0], kp), np.float32)
    yp = np.zeros((y.shape[0], kp), np.float32)
    xp[:, :k], yp[:, :k] = x, y2
    xn = _kernel_xn(xp)
    (xh, xl), (yh, yl) = _split(xp), _split(yp)
    acc = np.broadcast_to(yn[None, :], (x.shape[0], y.shape[0])).astype(np.float32)
    f64 = np.float64
    for s in range(0, kp, 8):
        sl = slice(s, s + 8)
        c = _round(xl[:, sl].astype(f64) @ yh[:, sl].T.astype(f64), mode)
        c = _round(c.astype(f64) + xh[:, sl].astype(f64) @ yl[:, sl].T.astype(f64), mode)
        c = _round(c.astype(f64) + xh[:, sl].astype(f64) @ yh[:, sl].T.astype(f64), mode)
        acc = (acc + c).astype(np.float32)
    d = np.maximum((xn[:, None] + acc).astype(np.float32), np.float32(0))
    i = d.argmin(1)  # the first minimum: the lowest index
    return d[np.arange(len(i)), i], i.astype(np.int32)


def _hold_to_plain(x, y, got):
    """chip_smoke.py's `argmin_compare` rule: distances to 1e-5 |d| plus
    the expanded form's f32 floor 4 eps (|x|^2 + |y|^2 + 2|x.y|) at the
    plain version's pick; differing ids only at float64 near-ties within
    it. Returns the largest error as a share of its tolerance."""
    pd, pi = (t.numpy() for t in tfa.fused_l2_argmin_plain(torch.tensor(x), torch.tensor(y)))
    kd, ki = got
    x64, y64 = x.astype(np.float64), y.astype(np.float64)
    yp = y64[pi]
    eps = float(np.finfo(np.float32).eps)
    floor = 4 * eps * ((x64 * x64).sum(1) + (yp * yp).sum(1) + 2 * np.abs((x64 * yp).sum(1)))
    tol = 1e-5 * np.abs(pd.astype(np.float64)) + floor
    err = np.abs(kd.astype(np.float64) - pd)
    assert (err <= tol).all(), float((err / tol).max())
    bad = np.nonzero(ki != pi)[0]
    da = ((x64[bad] - y64[ki[bad]]) ** 2).sum(1)
    db = ((x64[bad] - y64[pi[bad]]) ** 2).sum(1)
    assert (np.abs(da - db) <= tol[bad]).all()
    return float((err / tol).max())


def _blob_rows(rng, m, n, k, offset=0.0):
    """Rows of the main path's kind: n centres U(-5, 5), rows a centre
    plus unit gaussian noise, both shifted by `offset`."""
    centres = rng.uniform(-5, 5, (n, k))
    rows = centres[rng.integers(0, n, m)] + rng.standard_normal((m, k))
    return (rows + offset).astype(np.float32), (centres + offset).astype(np.float32)


@pytest.mark.parametrize("mode", ["rn", "rz"])
@pytest.mark.parametrize("kind", ["gaussian", "blobs", "blobs+100", "gaussian+100"])
def test_split_tf32_model_holds_the_chip_tolerance(rng, kind, mode):
    if kind.startswith("blobs"):
        x, y = _blob_rows(rng, 600, 200, 96, 100.0 if kind.endswith("+100") else 0.0)
    else:
        x = rng.standard_normal((600, 96)).astype(np.float32)
        y = rng.standard_normal((200, 96)).astype(np.float32)
        if kind.endswith("+100"):
            x, y = x + np.float32(100), y + np.float32(100)
    assert _hold_to_plain(x, y, _split_tf32_model(x, y, mode)) <= 1.0


@pytest.mark.parametrize("mode", ["rn", "rz"])
@pytest.mark.parametrize("m,n,k", [(70, 300, 12), (257, 129, 97), (33, 64, 7)])
def test_split_tf32_model_is_exact_on_integer_grids(rng, m, n, k, mode):
    """hi is exact on small integers and lo zero: every sum is exact, so
    the model equals the plain version bit for bit, ties included."""
    x = rng.integers(-3, 4, (m, k)).astype(np.float32)
    y = rng.integers(-3, 4, (n, k)).astype(np.float32)
    y[n // 2:] = y[:n - n // 2]
    md, mi = _split_tf32_model(x, y, mode)
    pd, pi = tfa.fused_l2_argmin_plain(torch.tensor(x), torch.tensor(y))
    np.testing.assert_array_equal(mi, pi.numpy())
    np.testing.assert_array_equal(md.view(np.int32), pd.numpy().view(np.int32))


def test_tf32_round_matches_the_bit_model(rng):
    """The wrapper's TF32 rounding equals the model's bit operations (ties
    away from zero included), and hi + lo carries a value to 2^-21."""
    ties = np.array([1 + 2**-11, -(1 + 2**-11), 1 + 3 * 2**-11, 2**-12, 0.0], np.float32)
    a = np.concatenate([ties, rng.standard_normal(500).astype(np.float32)])
    np.testing.assert_array_equal(tfa.tf32_round(torch.tensor(a)).numpy(), _tf32_bits(a))
    assert tfa.tf32_round(torch.tensor(ties)).tolist()[:3] == [1 + 2**-10, -(1 + 2**-10),
                                                               1 + 2**-9]
    hi, lo = _split(a)
    np.testing.assert_allclose(hi.astype(np.float64) + lo, a, rtol=2.0**-21, atol=0)


@pytest.mark.parametrize("rows,k,kpad", [(150, 70, 96), (300, 200, 224)])
def test_pack_split_lays_out_swizzled_chunks(rng, rows, k, kpad):
    """The kernel's split operands (-2y always, x past a padded depth of
    RESIDENT_MAX_DEPTH): per tile of 128 rows and 32-deep chunk, hi then
    lo, 128 bytes a row, 16-byte unit u of row r stored at position
    u ^ (r % 8)."""
    a = (rng.standard_normal((rows, k)) * 3).astype(np.float32)
    p = tfa.pack_split(torch.tensor(a)).numpy()
    nt, nkc = -(-rows // 128), kpad // 32
    assert p.shape == (nt, nkc, 2, 128, 32)
    full = np.zeros((128 * nt, kpad), np.float32)
    full[:rows, :k] = a
    hi, lo = _split(full)
    ct, kc, r, pos, e = np.meshgrid(np.arange(nt), np.arange(nkc), np.arange(128), np.arange(8),
                                    np.arange(4), indexing="ij")
    col = 32 * kc + 4 * (pos ^ (r % 8)) + e
    np.testing.assert_array_equal(p[ct, kc, 0, r, 4 * pos + e], hi[128 * ct + r, col])
    np.testing.assert_array_equal(p[ct, kc, 1, r, 4 * pos + e], lo[128 * ct + r, col])
    assert tfa.RESIDENT_MAX_DEPTH == 128
