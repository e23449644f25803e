"""PyTorch port: `refine_host` (neighbors/refine) against the JAX
`refine_host` on the same numpy inputs.

The dataset stays a host numpy array (and a memmap); candidates hold -1
entries (clipped on the host, masked by id) and duplicate ids. Both
strategies: "two_phase" (f32) returns the JAX ids, values to 1e-5 of the
row's scale; "fused" (kernel 1's refine launch on the card, its plain
version here) returns the JAX ids and values on gaussian rows, and bit
for bit on an integer grid, where bf16 rounding is exact. Within the
port, `refine_host` equals `refine` over the same rows as a tensor, bit
for bit, for both strategies and three metrics. Bad shapes raise.
"""

import numpy as np
import pytest

import torch

from raft_tpu.neighbors.refine import refine_host as jax_refine_host
from raft_tpu_torch.neighbors.refine import refine, refine_host

N, DIM, NQ, NC, K = 3000, 24, 20, 48, 10


def _inputs(grid=False, seed=0):
    rng = np.random.default_rng(seed)
    if grid:
        x = rng.integers(-6, 6, (N, DIM)).astype(np.float32)
    else:
        x = rng.standard_normal((N, DIM)).astype(np.float32)
    q = (x[rng.choice(N, NQ, replace=False)] + (0 if grid else 0.05)
         * rng.standard_normal((NQ, DIM))).astype(np.float32)
    cand = np.stack([rng.choice(N, NC, replace=False) for _ in range(NQ)]).astype(np.int32)
    cand[:, -3:] = -1  # short shortlists
    cand[0, :2] = cand[0, 2]  # a duplicate id
    return x, q, cand


@pytest.mark.parametrize("strategy", ["two_phase", "fused"])
def test_refine_host_matches_jax(strategy):
    x, q, cand = _inputs()
    jv, ji = jax_refine_host(x, q, cand, K, strategy=strategy)
    tv, ti = refine_host(x, q, cand, K, strategy=strategy, device="cpu")
    assert tv.device.type == "cpu" and ti.dtype == torch.int32
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    scale = (q * q).sum(1, keepdims=True) + 1.0
    assert (np.abs(tv.numpy() - np.asarray(jv)) <= 1e-5 * scale).all()


def test_refine_host_fused_bit_for_bit_on_a_grid():
    x, q, cand = _inputs(grid=True, seed=3)
    jv, ji = jax_refine_host(x, q, cand, K, strategy="fused")
    tv, ti = refine_host(x, q, cand, K, strategy="fused", device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy().view(np.int32), np.asarray(jv).view(np.int32))


@pytest.mark.parametrize("strategy", ["two_phase", "fused"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product"])
def test_refine_host_equals_refine_on_the_device_rows(tmp_path, strategy, metric):
    x, q, cand = _inputs(seed=5)
    mm = np.lib.format.open_memmap(str(tmp_path / "x.npy"), mode="w+", dtype=np.float32,
                                   shape=x.shape)
    mm[:] = x
    mm.flush()
    dv, di = refine(torch.from_numpy(x), torch.from_numpy(q), torch.from_numpy(cand), K,
                    metric=metric, strategy=strategy, device="cpu")
    for host in (x, np.load(str(tmp_path / "x.npy"), mmap_mode="r")):
        hv, hi = refine_host(host, q, torch.from_numpy(cand), K, metric=metric,
                             strategy=strategy, device="cpu")
        assert torch.equal(hi, di)
        assert torch.equal(hv.view(torch.int32), dv.view(torch.int32))
    assert not np.isin(di.numpy(), [-1]).any()


def test_refine_host_refuses_bad_shapes():
    x, q, cand = _inputs()
    with pytest.raises(ValueError, match="candidates"):
        refine_host(x, q, cand[:3], K, device="cpu")
    with pytest.raises(ValueError, match="n_candidates"):
        refine_host(x, q, cand, NC + 1, device="cpu")
    with pytest.raises(ValueError, match="dataset"):
        refine_host(x[:, :5], q, cand, K, device="cpu")
    with pytest.raises(ValueError, match="strategy"):
        refine_host(x, q, cand, K, strategy="nope", device="cpu")
