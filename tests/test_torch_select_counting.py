"""PyTorch port: select_k(strategy="counting") and the counting kernel's
plain version against the JAX package on the same numpy inputs.

The JAX side runs its Pallas counting kernel in interpret mode (what
`select_k(strategy="counting")` does on the CPU). Ids must be equal and
values equal in the input dtype, bit for bit (NaN where NaN): the engine
is exact, selecting in the total order of the f32 bits (-0.0 before
+0.0), ties to the smaller index. Like the JAX kernel, which extracts
each selected value as a masked sum, the port returns a selected -0.0 as
+0.0, and the final best-first sort then orders those zeros by position.
"""

import numpy as np
import pytest

import torch
import jax.numpy as jnp

from raft_tpu.matrix import select_k as jax_select_k
from raft_tpu.ops.select_counting import counting_select_min as jax_counting_select_min
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.ops import select_counting as tsc


def _same(got, want):
    gv, gi = got
    wv, wi = (np.asarray(a) for a in want)
    np.testing.assert_array_equal(gi.numpy(), wi)
    assert gv.dtype == torch.float32 or str(gv.dtype).endswith(str(wv.dtype))
    gv, wv = gv.float().numpy(), wv.astype(np.float32)
    np.testing.assert_array_equal(np.isnan(gv), np.isnan(wv))
    fin = ~np.isnan(wv)
    np.testing.assert_array_equal(gv[fin].view(np.int32), wv[fin].view(np.int32))


@pytest.mark.parametrize("batch,length,k", [(1, 128, 5), (7, 1000, 32), (3, 4096, 256),
                                            (2, 70000, 17)])
@pytest.mark.parametrize("select_min", [True, False])
def test_counting_matches_jax_at_the_jax_test_shapes(rng, batch, length, k, select_min):
    x = ((rng.random((batch, length), dtype=np.float32) - 0.5) * 100.0).astype(np.float32)
    want = jax_select_k(x, k, select_min=select_min, strategy="counting")
    got = select_k(x, k, select_min=select_min, strategy="counting", device="cpu")
    _same(got, want)


@pytest.mark.parametrize("select_min", [True, False])
def test_counting_ties_signed_zeros_and_infinities(select_min):
    x = np.array([[2.0, -1.0, 2.0, 2.0, -1.0, 0.0, np.inf, -np.inf] * 16,
                  [0.5] * 64 + [0.25] * 64,
                  [0.0, -0.0, 1.0, -0.0, 0.0, np.inf, -np.inf, -0.0] * 16],
                 dtype=np.float32)
    for k in (1, 5, 40, 128):
        want = jax_select_k(x, k, select_min=select_min, strategy="counting")
        got = select_k(x, k, select_min=select_min, strategy="counting", device="cpu")
        _same(got, want)


@pytest.mark.parametrize("dtype", [np.int8, np.uint16, jnp.bfloat16, np.float16, np.int16,
                                   np.uint8])
def test_counting_integer_and_half_inputs_keep_their_dtype(rng, dtype):
    x = rng.integers(-128 if dtype in (np.int8, np.int16) else 0, 120, (4, 300))
    xj = np.asarray(jnp.asarray(x, dtype=dtype))
    xt = torch.tensor(x.astype(np.float32)).to({
        np.int8: torch.int8, np.uint16: torch.uint16, jnp.bfloat16: torch.bfloat16,
        np.float16: torch.float16, np.int16: torch.int16, np.uint8: torch.uint8}[dtype])
    for select_min in (True, False):
        want = jax_select_k(xj, 9, select_min=select_min, strategy="counting")
        gv, gi = select_k(xt, 9, select_min=select_min, strategy="counting", device="cpu")
        assert gv.dtype == xt.dtype
        np.testing.assert_array_equal(gi.numpy(), np.asarray(want[1]))
        np.testing.assert_array_equal(gv.float().numpy(), np.asarray(want[0]).astype(np.float32))


def test_counting_rejects_disallowed_dtypes(rng):
    x = rng.standard_normal((2, 130))
    with pytest.raises(ValueError, match="f32-embeddable"):
        select_k(x.astype(np.float64), 3, strategy="counting", device="cpu")
    with pytest.raises(ValueError, match="f32-embeddable"):
        select_k(x.astype(np.int32), 3, strategy="counting", device="cpu")
    with pytest.raises(ValueError, match="f32-embeddable"):
        jax_select_k(x.astype(np.int32), 3, strategy="counting")


@pytest.mark.parametrize("k", [1, 10, 128, 384])
def test_kernel_plain_matches_the_jax_kernel_unsorted(rng, k):
    """The raw kernel contract: k smallest, unsorted, in the JAX kernel's
    position order (below the threshold in index order, then the ties at
    it in index order), on rows where k passes the finite values (+inf
    real entries precede +inf pad columns by index)."""
    x = rng.integers(0, 6, (3, 384)).astype(np.float32)
    x[0, 250:] = np.inf
    x[1, ::7] = -0.0
    x[1, 3::7] = 0.0
    x[2, 100:] = np.nan
    want = jax_counting_select_min(x, k, interpret=True)
    got = tsc.counting_select_min(torch.tensor(x), k)
    assert got[1].dtype == torch.int32
    _same(got, want)
    want_set = np.sort(np.argsort(tsc._monotone_u32(torch.tensor(x)).numpy(), axis=1,
                                  kind="stable")[:, :k], axis=1)
    np.testing.assert_array_equal(np.sort(got[1].numpy(), axis=1), want_set)


def test_monotone_map_is_the_total_order():
    v = np.array([-np.inf, -2.0, -0.0, 0.0, 1e-45, 3.0, np.inf, np.nan], np.float32)
    keys = tsc._monotone_u32(torch.tensor(v)).numpy()
    assert (np.diff(keys) > 0).all() and keys.min() >= 0 and keys.max() < 2**32
    assert tsc._monotone_u32(torch.tensor([-np.nan], dtype=torch.float32)).item() < keys[0]


def test_counting_wrapper_checks(rng):
    x = torch.tensor(rng.standard_normal((2, 200)).astype(np.float32))
    with pytest.raises(ValueError, match="multiple of 128"):
        tsc.counting_select_min(x, 3)
    with pytest.raises(ValueError, match="out of range"):
        tsc.counting_select_min(x[:, :128].contiguous(), 129)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tsc.counting_select_min(torch.empty((2, 128), device="meta"), 3)


def _worst_rows(kind, length):
    i = np.arange(length, dtype=np.float32)
    if kind == "descending":  # every element below all before it
        return np.stack([length - i, -0.25 * i, 1e30 / (i + 1.0)]).astype(np.float32)
    return np.stack([np.full(length, 7.0), np.full(length, -0.0),  # all equal
                     np.full(length, np.inf)]).astype(np.float32)


@pytest.mark.parametrize("kind", ["descending", "all-equal"])
@pytest.mark.parametrize("k", [1, 10, 32, 33, 128, 129, 256, 257])
def test_kernel_plain_matches_the_jax_kernel_on_worst_rows(kind, k):
    """Rows that make every element an insertion (descending) or tie
    everywhere (all equal), k on both sides of the CUDA kernel's switches
    (32/33: one list register a lane or two; 128/129, SMALL_K_MAX: the
    one-pass variant or the radix select) and of the JAX envelope's cap
    (256/257)."""
    x = _worst_rows(kind, 1024)
    want = jax_counting_select_min(x, k, interpret=True)
    got = tsc.counting_select_min(torch.tensor(x), k)
    _same(got, want)


@pytest.mark.parametrize("k", [tsc.SMALL_K_MAX, tsc.SMALL_K_MAX + 1, 256, 257])
def test_counting_select_k_at_the_variant_switch(rng, k):
    x = rng.integers(-20, 20, (4, 1280)).astype(np.float32)
    x[0, ::5] = -0.0
    want = jax_select_k(x, k, select_min=True, strategy="counting")
    got = select_k(x, k, select_min=True, strategy="counting", device="cpu")
    _same(got, want)
