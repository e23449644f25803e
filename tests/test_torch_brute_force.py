"""PyTorch port: brute_force.knn (tiled and fused) against the JAX
package's knn on the same numpy inputs.

Integer-grid data makes every squared distance exact in f32 and in
bf16, so ids and values must match exactly on both engines (euclidean
values to one f32 ulp: XLA's CPU sqrt is not correctly rounded). On gaussian data the
tiled engines (both f32) sum in another order, so ids must agree in at
least 99% of slots and distances to rtol 1e-5.
"""

import numpy as np
import pytest

import torch

from raft_tpu.neighbors import brute_force as jbf
from raft_tpu.neighbors.brute_force import _bf_knn_impl as jax_bf_knn_impl
from raft_tpu.distance.distance_types import resolve_metric as jax_resolve_metric
from raft_tpu_torch.neighbors import brute_force as tbf


def _grid(rng, shape):
    return rng.integers(-6, 7, shape).astype(np.float32)


@pytest.mark.parametrize("engine", ["tiled", "fused"])
@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product"])
@pytest.mark.parametrize("k", [1, 10, 64])
def test_knn_matches_jax_on_grid(rng, engine, metric, k):
    ds, q = _grid(rng, (900, 24)), _grid(rng, (21, 24))
    jv, ji = jbf.knn(ds, q, k, metric=metric, engine=engine)
    tv, ti = tbf.knn(ds, q, k, metric=metric, engine=engine, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    if metric == "euclidean":
        # XLA's CPU sqrt is not correctly rounded: one f32 ulp apart
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=2.4e-7)
    else:
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_knn_tiled_merge_across_tiles_matches_jax(rng):
    """A tile far below n drives the running-queue merge; ties between
    tiles must keep the smaller row id, as the JAX scan does."""
    ds, q = _grid(rng, (1000, 8)), _grid(rng, (9, 8))
    m = jax_resolve_metric("sqeuclidean")
    jv, ji = jax_bf_knn_impl(ds, q, 10, m, tile=128)
    tv, ti = tbf._bf_knn_impl(torch.tensor(ds), torch.tensor(q), 10,
                              tbf.resolve_metric("sqeuclidean"), tile=128)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


@pytest.mark.parametrize("engine", ["tiled", "fused"])
def test_knn_matches_jax_on_gaussian(rng, engine):
    ds = rng.standard_normal((3000, 32)).astype(np.float32)
    q = rng.standard_normal((40, 32)).astype(np.float32)
    jv, ji = jbf.knn(ds, q, 10, engine=engine)
    tv, ti = tbf.knn(ds, q, 10, engine=engine, device="cpu")
    same = ti.numpy() == np.asarray(ji)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(tv.numpy()[same], np.asarray(jv)[same], rtol=1e-5)


_SLICE_METRICS = ["l1", "chebyshev", "canberra", "hamming", "kl_divergence", "minkowski",
                  "braycurtis", "cosine"]


def _slice_operands(rng, metric, grid):
    shape_ds, shape_q = (1000, 12), (17, 12)
    if grid:
        vals = np.array([0, 1, 3]) if metric in ("canberra", "kl_divergence") else np.arange(-3, 4)
        if metric in ("braycurtis", "hamming"):
            vals = np.arange(0, 4)
        return (rng.choice(vals, shape_ds).astype(np.float32),
                rng.choice(vals, shape_q).astype(np.float32))
    ds = rng.standard_normal(shape_ds).astype(np.float32)
    q = rng.standard_normal(shape_q).astype(np.float32)
    if metric in ("kl_divergence", "braycurtis"):
        ds, q = np.abs(ds), np.abs(q)
    if metric == "kl_divergence":
        ds = (ds / ds.sum(1, keepdims=True)).astype(np.float32)
        q = (q / q.sum(1, keepdims=True)).astype(np.float32)
    if metric == "hamming":
        ds, q = np.round(ds), np.round(q)
    return ds, q


@pytest.mark.parametrize("grid", [True, False])
@pytest.mark.parametrize("metric", _SLICE_METRICS)
def test_tiled_knn_slice_matches_jax_for_every_metric(rng, metric, grid):
    """Both packages' `_bf_knn_impl` with a tile of 128 rows, so the tile
    loop and the running merge run on the CPU. Integer grids (values whose
    canberra terms are exact where that metric needs it) give exact ids,
    ties included; gaussian data ids in >= 99% of slots and values to
    rtol 1e-5."""
    ds, q = _slice_operands(rng, metric, grid)
    arg = 3.0 if metric == "minkowski" else 2.0
    jv, ji = jax_bf_knn_impl(ds, q, 10, jax_resolve_metric(metric), metric_arg=arg, tile=128)
    tv, ti = tbf._bf_knn_impl(torch.tensor(ds), torch.tensor(q), 10, tbf.resolve_metric(metric),
                              metric_arg=arg, tile=128)
    jv, ji = np.asarray(jv), np.asarray(ji)
    assert ti.dtype == torch.int32
    if grid:
        np.testing.assert_array_equal(ti.numpy(), ji)
        np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-6, atol=1e-6)
        return
    same = ti.numpy() == ji
    assert same.mean() >= 0.99
    np.testing.assert_allclose(tv.numpy(), jv, rtol=1e-5, atol=1e-6)


def test_knn_passes_metric_arg_through(rng):
    ds, q = _grid(rng, (300, 5)), _grid(rng, (7, 5))
    for p in (1.0, 3.0):
        jv, ji = jbf.knn(ds, q, 6, metric="minkowski", metric_arg=p)
        tv, ti = tbf.knn(ds, q, 6, metric="minkowski", metric_arg=p, device="cpu")
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), rtol=1e-6)
    l1 = tbf.knn(ds, q, 6, metric="l1", device="cpu")
    p1 = tbf.knn(ds, q, 6, metric="minkowski", metric_arg=1.0, device="cpu")
    np.testing.assert_array_equal(l1[1].numpy(), p1[1].numpy())


def test_knn_rejects_prefilter_and_bad_engine(rng):
    """A prefilter is ported now: held to the JAX package's knn on the
    same mask (the other probes still raise)."""
    ds = _grid(rng, (50, 4))
    keep = rng.random(50) < 0.5
    for engine in ("tiled", "fused"):
        jv, ji = jbf.knn(ds, ds[:2], 3, engine=engine, prefilter=keep)
        tv, ti = tbf.knn(ds, ds[:2], 3, engine=engine, prefilter=keep, device="cpu")
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert keep[ti.numpy()].all()
    with pytest.raises(ValueError):
        tbf.knn(ds, ds[:2], 3, engine="nope", device="cpu")
    with pytest.raises(ValueError):
        tbf.knn(ds, ds[:2, :3], 3, device="cpu")


# --- public call shapes: engine="auto", compute_dtype, knn_merge_parts ------


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product", "l1"])
def test_knn_engine_auto_matches_jax(rng, metric):
    """"auto" resolves as the JAX package does without a tuned value (the
    tiled engine); integer grids give exact ids and values."""
    ds, q = _grid(rng, (700, 12)), _grid(rng, (11, 12))
    jv, ji = jbf.knn(ds, q, 9, metric=metric, engine="auto")
    tv, ti = tbf.knn(ds, q, 9, metric=metric, engine="auto", device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert ti.dtype == torch.int32


def test_knn_compute_dtype_bfloat16_matches_jax(rng):
    """Grid values plus a jitter that bf16 rounds away: the bf16 operands
    are exact integers in both packages, so ids (ties included) match and
    values agree within bf16 tolerance; the f32 call ranks the jitter."""
    import jax.numpy as jnp

    ds = _grid(rng, (600, 10)) + rng.choice([0.0, 0.004], (600, 10)).astype(np.float32)
    q = _grid(rng, (9, 10)) + rng.choice([0.0, 0.004], (9, 10)).astype(np.float32)
    jv, ji = jbf.knn(ds, q, 12, compute_dtype=jnp.bfloat16)
    tv, ti = tbf.knn(ds, q, 12, compute_dtype=torch.bfloat16, device="cpu")
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv, np.float32), rtol=2**-8, atol=1e-6)
    f32 = tbf.knn(ds, q, 12, device="cpu")[0]
    assert not torch.equal(f32, tv)


@pytest.mark.parametrize("engine", ["fused", "pallas"])
def test_knn_compute_dtype_with_fused_engine_raises_like_jax(rng, engine):
    import jax.numpy as jnp

    ds = _grid(rng, (50, 4))
    with pytest.raises(ValueError, match="compute_dtype applies to engine='tiled' only"):
        jbf.knn(ds, ds[:2], 3, engine=engine, compute_dtype=jnp.bfloat16)
    with pytest.raises(ValueError, match="compute_dtype applies to engine='tiled' only"):
        tbf.knn(ds, ds[:2], 3, engine=engine, compute_dtype=torch.bfloat16, device="cpu")


@pytest.mark.parametrize("select_min", [True, False])
@pytest.mark.parametrize("layout", ["stacked", "concatenated"])
def test_knn_merge_parts_matches_jax_with_ties_across_parts(rng, layout, select_min):
    """Four parts of sorted per-part results over few distinct values:
    ties across parts go to the earlier part, as in the JAX merge."""
    n_parts, n_q, kp = 4, 7, 6
    d = np.sort(rng.integers(0, 4, (n_parts, n_q, kp)).astype(np.float32), axis=-1)
    if not select_min:
        d = d[..., ::-1].copy()
    ids = rng.permutation(10_000)[:n_parts * n_q * kp].reshape(n_parts, n_q, kp)
    ids = ids.astype(np.int32)
    if layout == "concatenated":
        d = np.moveaxis(d, 0, 1).reshape(n_q, n_parts * kp)
        ids = np.moveaxis(ids, 0, 1).reshape(n_q, n_parts * kp)
    for k in (None, 5):
        jv, ji = jbf.knn_merge_parts(d, ids, k=k, select_min=select_min)
        tv, ti = tbf.knn_merge_parts(d, ids, k=k, select_min=select_min, device="cpu")
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
        assert ti.dtype == torch.int32
