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
from raft_tpu_torch.distance import fused_l2_nn as tnn
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
    td, ti = tnn.fused_l2_nn(x, y, device="cpu")
    np.testing.assert_allclose(td.numpy(), jd, rtol=1e-5, atol=1e-5)
    _assert_ids_up_to_near_ties(x, y, ti.numpy(), ji)
    ja = np.asarray(jax_fused_l2_nn_argmin(x, y, sqrt=True))
    ta = tnn.fused_l2_nn_argmin(x, y, sqrt=True, device="cpu")
    assert ta.dtype == torch.int32
    _assert_ids_up_to_near_ties(x, y, ta.numpy(), ja)
    gx, gy = np.round(x), np.round(y)
    np.testing.assert_array_equal(tnn.fused_l2_nn_argmin(gx, gy, device="cpu").numpy(),
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
        tnn.fused_l2_nn(x, x[:, :2], device="cpu")
    with pytest.raises(ValueError):
        tnn.fused_l2_nn_argmin(x, x[:0], device="cpu")
    with pytest.raises(ValueError):
        tnn.fused_l2_nn(x[0], x, device="cpu")
    with pytest.raises(ValueError, match="cpu or cuda"):
        meta = torch.empty((4, 3), device="meta")
        tfa.fused_l2_argmin(meta, meta)
