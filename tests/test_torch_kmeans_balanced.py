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
    tp = tkb.predict(x, centers, metric=metric, device="cpu")
    # int32 labels, as the JAX package returns them (L2 and IP branches)
    assert jl.dtype == np.int32 and tp.dtype == torch.int32
    tl = tp.numpy()
    agree = (jl == tl).mean()
    assert agree >= 0.999, agree
    _, jfl = jkb.fit_predict(x[:300], 5, n_iters=3, metric=metric)
    _, tfl = tkb.fit_predict(x[:300], 5, n_iters=3, metric=metric, device="cpu")
    assert np.asarray(jfl).dtype == np.int32 and tfl.dtype == torch.int32


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


def test_pack_lists_matches_jax(rng):
    from raft_tpu.neighbors.ivf_flat import _pack_lists as jax_pack
    from raft_tpu_torch.neighbors.ivf_flat import _pack_lists

    labels = rng.integers(0, 7, 500)
    labels[labels == 3] = 2  # list 3 empty
    for group in (8, 32):
        jr, js = jax_pack(labels.astype(np.int64), 9, group=group)
        tr, ts = _pack_lists(torch.tensor(labels), 9, group=group)
        np.testing.assert_array_equal(tr.numpy(), jr)
        np.testing.assert_array_equal(ts.numpy(), js)


def test_padded_rows_never_move_a_center(rng):
    """Padding rows (weight 0, past `valid_n`) sit far away; no center of
    the batched EM may move toward them, whatever their count."""
    real = [300, 120, 7]
    parts = torch.full((3, 320, 4), 1e6)
    weights = torch.zeros((3, 320))
    for b, nv in enumerate(real):
        parts[b, :nv] = torch.tensor(rng.standard_normal((nv, 4)).astype(np.float32))
        weights[b, :nv] = 1.0
    gen = make_generator(0, "cpu")
    c = tkb._fit_partitions(gen, parts, weights, torch.tensor(real), 6, 5, "sqeuclidean")
    assert c.shape == (3, 6, 4) and torch.isfinite(c).all()
    assert float(c.abs().max()) < 10.0


def test_fit_with_max_train_points_and_fit_predict(rng):
    x = _blobs(rng, 3000, 8, 6)
    c = tkb.fit(x, 24, n_iters=5, seed=1, max_train_points=500, device="cpu")
    jc = np.asarray(jkb.fit(x, 24, n_iters=5, seed=1, max_train_points=500))
    _, _, _, ti = assign_and_reduce(torch.tensor(x), c)
    _, _, _, ji = assign_and_reduce(torch.tensor(x), torch.tensor(jc))
    assert abs(float(ti) / float(ji) - 1.0) <= 0.05
    centers, labels = tkb.fit_predict(x, 6, n_iters=5, seed=1, device="cpu")
    assert torch.equal(labels, tkb.predict(x, centers, device="cpu"))


@pytest.mark.parametrize("n_clusters", [100, 103])
def test_fit_hierarchical_inertia_within_five_percent_of_jax(rng, n_clusters):
    """103 is not a multiple of k_meso (10): 7 surplus centers drop."""
    x = _blobs(rng, 5000, 8, 40)
    jc = np.asarray(jkb.fit_hierarchical(x, n_clusters, n_iters=6, seed=2))
    tc = tkb.fit_hierarchical(x, n_clusters, n_iters=6, seed=2, device="cpu")
    assert tc.shape == jc.shape == (n_clusters, 8) and torch.isfinite(tc).all()
    _, _, _, j_inertia = assign_and_reduce(torch.tensor(x), torch.tensor(jc))
    _, _, _, t_inertia = assign_and_reduce(torch.tensor(x), tc)
    ratio = float(t_inertia) / float(j_inertia)
    assert abs(ratio - 1.0) <= 0.05, ratio


def test_fit_hierarchical_empty_partitions_take_their_mesocenter(rng):
    """Five distinct points for ten mesoclusters: duplicate mesocenters
    leave partitions empty; their fine centers are the mesocenter, and
    every center stays finite (as in the JAX package)."""
    pts = rng.uniform(-3, 3, (5, 4)).astype(np.float32)
    x = pts[rng.integers(0, 5, 2000)]
    tc = tkb.fit_hierarchical(x, 100, n_iters=3, seed=0, device="cpu")
    jc = np.asarray(jkb.fit_hierarchical(x, 100, n_iters=3, seed=0))
    assert tc.shape == jc.shape == (100, 4)
    assert torch.isfinite(tc).all() and np.isfinite(jc).all()
    meso = tkb.fit(x, 10, n_iters=3, seed=0, device="cpu")
    labels = tkb.predict(x, meso, device="cpu")
    assert len(set(labels.tolist())) < 10  # some partition is empty
    d = ((tc[:, None, :] - torch.tensor(pts)[None]) ** 2).sum(-1).min(dim=1).values
    assert float(d.max()) < 1e-6  # every center is one of the points
