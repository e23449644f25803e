"""PyTorch port: `_quantize_query_rows`, the query side of both int8
trims, against the JAX function as the JAX engines run it (under `jit`).

Every int8 score is `f32(int dot) * row_scale`, so the row scale has to
agree bit for bit, not to a tolerance. Under `jit` XLA compiles the
reference's `ua / 127.0` into a multiply by the f32 reciprocal; the port
multiplies by that reciprocal. The int8 rows are compared exactly too.
"""

import jax
import numpy as np
import pytest

import torch

from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu_torch.neighbors import ivf_pq as tpq


def _rows(seed, shape):
    """Gaussian rows scaled per row by magnitudes spread log-uniformly
    over 1e-3 .. 1e3, with one all-zero row."""
    rng = np.random.default_rng(seed)
    u = rng.standard_normal(shape).astype(np.float32)
    mag = 10.0 ** rng.uniform(-3.0, 3.0, shape[:-1] + (1,))
    u = (u * mag).astype(np.float32)
    u.reshape(-1, shape[-1])[0] = 0.0
    return u


@pytest.mark.parametrize("seed,shape", [(0, (64, 128, 96)), (1, (6, 8, 24)), (2, (4096, 33))])
def test_quantize_rows_bitwise_equal_to_jitted_jax(seed, shape):
    u = _rows(seed, shape)
    j8, js = (np.asarray(a) for a in jax.jit(jpq._quantize_query_rows)(u))
    t8, ts = tpq._quantize_query_rows(torch.tensor(u))
    assert t8.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(t8.numpy(), j8)
    np.testing.assert_array_equal(ts.numpy().view(np.int32), js.view(np.int32))


def test_quantize_rows_zero_row_and_extremes():
    u = _rows(3, (5, 16))
    u[1] = 0.0
    u[2, :] = 1e3
    u[3, :] = -1e-3
    j8, js = (np.asarray(a) for a in jax.jit(jpq._quantize_query_rows)(u))
    t8, ts = tpq._quantize_query_rows(torch.tensor(u))
    np.testing.assert_array_equal(t8.numpy(), j8)
    np.testing.assert_array_equal(ts.numpy().view(np.int32), js.view(np.int32))
    assert np.all(t8.numpy()[1] == 0) and np.all(np.abs(t8.numpy()[2:4]) == 127)
