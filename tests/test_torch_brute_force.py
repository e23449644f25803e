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


def test_knn_rejects_prefilter_and_bad_engine(rng):
    ds = _grid(rng, (50, 4))
    with pytest.raises(NotImplementedError):
        tbf.knn(ds, ds[:2], 3, prefilter=np.ones(50, bool), device="cpu")
    with pytest.raises(ValueError):
        tbf.knn(ds, ds[:2], 3, engine="nope", device="cpu")
    with pytest.raises(ValueError):
        tbf.knn(ds, ds[:2, :3], 3, device="cpu")
