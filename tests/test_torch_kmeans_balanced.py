"""PyTorch port: balanced k-means against the JAX package.

Given identical centers, assignment is deterministic: labels must agree
except on near-ties (rows whose two best distances are within f32 noise),
and the per-center sums, counts and inertia must agree to rtol 1e-5 (the
sums are taken in another order). A fit starts from different random
draws in the two packages (different generators), so fits are compared
by their inertia on the same data: within 5%.
"""

import numpy as np
import pytest

import torch

from raft_tpu.cluster import kmeans_balanced as jkb
from raft_tpu.cluster.kmeans_common import assign_and_reduce as jax_assign_and_reduce
from raft_tpu_torch.cluster import kmeans_balanced as tkb
from raft_tpu_torch.cluster.kmeans_common import assign_and_reduce
from raft_tpu_torch.random.rng import make_generator, sample_without_replacement


def _blobs(rng, n, d, n_blobs, spread=5.0):
    c = rng.uniform(-spread, spread, (n_blobs, d)).astype(np.float32)
    return (c[rng.integers(0, n_blobs, n)] + rng.standard_normal((n, d))).astype(np.float32)


def _near_tie_rows(x, centers, tol=1e-4):
    d = ((x[:, None, :].astype(np.float64) - centers[None].astype(np.float64)) ** 2).sum(-1)
    two = np.sort(d, axis=1)[:, :2]
    return (two[:, 1] - two[:, 0]) <= tol * np.maximum(two[:, 1], 1.0)


@pytest.mark.parametrize("with_weights", [False, True])
def test_assign_and_reduce_matches_jax(rng, with_weights):
    x = _blobs(rng, 2000, 16, 12)
    centers = x[rng.choice(2000, 12, replace=False)] + 0.1
    w = rng.uniform(0.5, 2.0, 2000).astype(np.float32) if with_weights else None
    jl, js, jc, ji = (np.asarray(a) for a in jax_assign_and_reduce(x, centers, w))
    tl, ts, tc, ti = assign_and_reduce(torch.tensor(x), torch.tensor(centers),
                                       None if w is None else torch.tensor(w))
    ties = _near_tie_rows(x, centers)
    np.testing.assert_array_equal(tl.numpy()[~ties], jl[~ties])
    assert (tl.numpy() == jl).all(), "no near-ties expected at this spread"
    np.testing.assert_allclose(tc.numpy(), jc, rtol=1e-5)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(float(ti), float(ji), rtol=1e-5)


def test_batched_assign_and_reduce_equals_each_slice(rng):
    """The PQ trainer runs every subspace in one batched call; each batch
    entry must equal the unbatched call on its own slice."""
    x = torch.tensor(rng.standard_normal((3, 500, 4)).astype(np.float32))
    c = torch.tensor(rng.standard_normal((3, 16, 4)).astype(np.float32))
    bl, bs, bc, bi = assign_and_reduce(x, c)
    for b in range(3):
        l, s, cnt, i = assign_and_reduce(x[b], c[b])
        assert torch.equal(bl[b], l)
        torch.testing.assert_close(bs[b], s)
        torch.testing.assert_close(bc[b], cnt)
        torch.testing.assert_close(bi[b], i)


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_predict_matches_jax(rng, metric):
    x = _blobs(rng, 1500, 8, 10)
    centers = _blobs(rng, 10, 8, 10)
    jl = np.asarray(jkb.predict(x, centers, metric=metric))
    tl = tkb.predict(x, centers, metric=metric, device="cpu").numpy()
    agree = (jl == tl).mean()
    assert agree >= 0.999, agree


@pytest.mark.parametrize("n_clusters", [8, 520])
def test_fit_inertia_within_five_percent_of_jax(rng, n_clusters):
    """8 clusters seed with k-means++, 520 with a uniform draw of rows."""
    n = 3000 if n_clusters > 512 else 2000
    x = _blobs(rng, n, 8, n_clusters)
    jc = np.asarray(jkb.fit(x, n_clusters, n_iters=10, seed=3))
    tc = tkb.fit(x, n_clusters, n_iters=10, seed=3, device="cpu")
    assert tc.shape == (n_clusters, 8) and torch.isfinite(tc).all()
    _, _, _, j_inertia = assign_and_reduce(torch.tensor(x), torch.tensor(jc))
    _, _, _, t_inertia = assign_and_reduce(torch.tensor(x), tc)
    ratio = float(t_inertia) / float(j_inertia)
    assert abs(ratio - 1.0) <= 0.05, ratio


def test_fit_is_reproducible_from_its_seed(rng):
    x = _blobs(rng, 800, 6, 5)
    a = tkb.fit(x, 5, n_iters=4, seed=11, device="cpu")
    b = tkb.fit(x, 5, n_iters=4, seed=11, device="cpu")
    assert torch.equal(a, b)


def test_sample_without_replacement_draws_distinct_rows():
    gen = make_generator(0, "cpu")
    s = sample_without_replacement(gen, 1000, 300)
    assert s.shape == (300,) and len(set(s.tolist())) == 300
    assert int(s.min()) >= 0 and int(s.max()) < 1000
    with pytest.raises(ValueError):
        sample_without_replacement(gen, 5, 6)
