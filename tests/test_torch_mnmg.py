"""The port's distributed brute-force k-NN and k-means
(raft_tpu_torch/comms/mnmg_knn.py, mnmg_kmeans.py, mnmg_merge.py) against
the JAX package's on the same numpy inputs: in-process CPU worlds of 1, 2,
4 and 8 ranks against JAX `Comms(n_devices=R)` on the virtual devices.

- `knn` and `knn_local` (1,003 rows: no world divides them; 37 queries:
  the sharded merge pads them) in the replicated, sharded and auto query
  modes and with the tournament merge: ids equal to JAX's outside ties
  (a swap is allowed only between values within 1e-6 relative), values
  within 1e-5 relative; the tournament bit for bit the allgather merge;
  `knn_local` bit for bit `knn` in one process. A prefilter (mask and
  Bitset), bf16 operands and inner product on 4 ranks, and a world whose
  shards hold fewer rows than k.
- `_kmeans_fit_sharded` from the same numpy init: centers and inertia
  within 1e-5 relative, n_iter equal. `kmeans_fit` (seeded k-means++ on
  a torch generator, so another init than JAX's) held by quality: inertia
  within 5% of JAX's. `kmeans_predict` labels equal to JAX's for the
  same centers; the *_local variants equal the driver calls.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.comms import Comms as JComms
from raft_tpu.comms import mnmg as jm
from raft_tpu_torch.comms import Comms, mnmg
from raft_tpu_torch.comms import mnmg_merge
from raft_tpu_torch.core import tuned as ttuned
from raft_tpu_torch.core.bitset import Bitset

WORLDS = (1, 2, 4, 8)
N, D, NQ, K = 1003, 16, 37, 10


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(11)
    x = rng.standard_normal((N, D)).astype(np.float32)
    q = rng.standard_normal((NQ, D)).astype(np.float32)
    return x, q


@pytest.fixture(scope="module")
def worlds():
    out = {r: (JComms(n_devices=r), Comms(n_devices=r, device="cpu", timeout_s=60)) for r in WORLDS}
    yield out
    for _, tc in out.values():
        tc.destroy()


@pytest.fixture(scope="module")
def jax_knn(worlds, data):
    """JAX's answer per world (replicated merge)."""
    x, q = data
    return {r: tuple(np.asarray(a) for a in jm.knn(jc, x, q, K, query_mode="replicated"))
            for r, (jc, _) in worlds.items()}


def _assert_knn_equal(v, i, jv, ji, rtol=1e-5):
    """ids equal outside ties; values within rtol."""
    v, i = np.asarray(v), np.asarray(i)
    assert i.dtype == np.int32 and v.dtype == np.float32 and i.shape == ji.shape
    np.testing.assert_allclose(v, jv, rtol=rtol, atol=1e-6)
    for r, c in zip(*np.nonzero(i != ji)):
        # a swap only between (near-)equal values
        assert abs(float(jv[r, c]) - float(v[r, c])) <= 1e-6 * max(1.0, abs(float(jv[r, c])))
        assert set(i[r]) == set(ji[r]) or c == i.shape[1] - 1


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("mode", ["replicated", "sharded", "auto"])
def test_knn_equals_jax(worlds, data, jax_knn, world, mode):
    x, q = data
    tc = worlds[world][1]
    v, i = mnmg.knn(tc, x, q, K, query_mode=mode)
    assert v.shape == (NQ, K)
    _assert_knn_equal(v, i, *jax_knn[world])


@pytest.mark.parametrize("world", WORLDS)
def test_knn_local_equals_knn_and_jax(worlds, data, jax_knn, world):
    x, q = data
    jc, tc = worlds[world]
    v, i = mnmg.knn_local(tc, x, q, K)
    bv, bi = mnmg.knn(tc, x, q, K)
    assert torch.equal(v, bv) and torch.equal(i, bi)
    jv, ji = jm.knn_local(jc, x, q, K)
    _assert_knn_equal(v, i, np.asarray(jv), np.asarray(ji))


@pytest.mark.parametrize("world", (2, 4, 8))
def test_tournament_merge_equals_allgather_bit_for_bit(worlds, data, jax_knn, world,
                                                       monkeypatch):
    x, q = data
    tc = worlds[world][1]
    base = mnmg.knn(tc, x, q, K, query_mode="replicated")
    monkeypatch.setattr(ttuned, "applies", lambda device: True)
    monkeypatch.setattr(ttuned, "get", lambda key, default=None:
                        "tournament" if key == "mnmg_replicated_merge_schedule" else default)
    assert mnmg_merge._replicated_merge_schedule("cpu") == "tournament"
    v, i = mnmg.knn(tc, x, q, K, query_mode="replicated")
    assert torch.equal(v, base[0]) and torch.equal(i, base[1])
    _assert_knn_equal(v, i, *jax_knn[world])


def test_query_mode_resolution_matches_jax(worlds, monkeypatch):
    """Untuned (the port commits no comms value): the JAX resolution
    without its table's TPU-measured keys."""
    from raft_tpu.core import tuned as jtuned

    monkeypatch.setattr(jtuned, "get", lambda key, default=None: default)
    jc, tc = worlds[4]
    for nq, k in ((4096, 10), (4096, 100), (100, 10), (8192, 64)):
        assert (mnmg_merge._resolve_query_mode("auto", tc, nq, k)
                == jm._resolve_query_mode("auto", jc, nq, k))
    with pytest.raises(ValueError):
        mnmg_merge._resolve_query_mode("bogus", tc, 1, 1)


@pytest.mark.parametrize("kind", ["mask", "bitset"])
def test_knn_prefilter_equals_jax(worlds, data, kind):
    x, q = data
    jc, tc = worlds[4]
    keep = np.random.default_rng(3).random(N) < 0.5
    jv, ji = jm.knn(jc, x, q, K, prefilter=keep)
    pf = keep if kind == "mask" else Bitset.from_mask(torch.from_numpy(keep))
    v, i = mnmg.knn(tc, x, q, K, prefilter=pf)
    _assert_knn_equal(v, i, np.asarray(jv), np.asarray(ji))
    assert keep[i.numpy()].all()


def test_knn_bf16_and_inner_product_equal_jax(worlds, data):
    x, q = data
    jc, tc = worlds[4]
    jv, ji = jm.knn(jc, x, q, K, compute_dtype=jnp.bfloat16)
    v, i = mnmg.knn(tc, x, q, K, compute_dtype=torch.bfloat16)
    _assert_knn_equal(v, i, np.asarray(jv), np.asarray(ji), rtol=1e-2)
    jv, ji = jm.knn(jc, x, q, K, metric="inner_product")
    v, i = mnmg.knn(tc, x, q, K, metric="inner_product")
    _assert_knn_equal(v, i, np.asarray(jv), np.asarray(ji))


def test_knn_shards_smaller_than_k(worlds, data):
    """13 rows on 8 ranks (2 a rank, the last rank's only pads): k 5."""
    x, q = data
    jc, tc = worlds[8]
    jv, ji = jm.knn(jc, x[:13], q, 5)
    v, i = mnmg.knn(tc, x[:13], q, 5)
    _assert_knn_equal(v, i, np.asarray(jv), np.asarray(ji))


@pytest.fixture(scope="module")
def blobs():
    rng = np.random.default_rng(13)
    centers = rng.uniform(-10, 10, (6, D)).astype(np.float32)
    lab = rng.integers(0, 6, 1203)
    return (centers[lab] + 0.4 * rng.standard_normal((1203, D))).astype(np.float32)


@pytest.mark.parametrize("world", (2, 8))
def test_kmeans_fit_sharded_from_the_same_init(worlds, blobs, world):
    jc, tc = worlds[world]
    c0 = blobs[np.random.default_rng(1).choice(len(blobs), 6, replace=False)]
    jxs, n, per = jm._shard_rows(jc, blobs)
    jw = jc.shard(np.where(np.arange(per * world) < n, 1.0, 0.0).astype(np.float32))
    jcent, jin, jit = jm._kmeans_fit_sharded(jc, jxs, jw, max_iter=20, inits=[c0])
    txs, tn, tper = mnmg._shard_rows(tc, blobs)
    tw = tc.shard(np.where(np.arange(tper * world) < tn, 1.0, 0.0).astype(np.float32))
    tcent, tin, tit = mnmg._kmeans_fit_sharded(tc, txs, tw, max_iter=20, inits=[c0])
    jcent = np.asarray(jcent)
    assert tit == jit
    assert np.abs(tcent.numpy() - jcent).max() <= 1e-5 * np.abs(jcent).max()
    assert abs(tin - jin) <= 1e-5 * jin


def test_kmeans_fit_quality_and_predict_equal_jax(worlds, blobs):
    jc, tc = worlds[4]
    jcent, jin, _ = jm.kmeans_fit(jc, blobs, 6, max_iter=20, seed=0)
    tcent, tin, tit = mnmg.kmeans_fit(tc, blobs, 6, max_iter=20, seed=0)
    assert tcent.shape == (6, D) and 1 <= tit <= 20
    assert tin <= 1.05 * jin
    # labels for the same centers, equal to JAX's
    jl = np.asarray(jm.kmeans_predict(jc, blobs, np.asarray(jcent)))
    tl = mnmg.kmeans_predict(tc, blobs, np.asarray(jcent))
    assert tl.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), jl)
    # the *_local variants in one process are the driver calls
    lc, lin, lit = mnmg.kmeans_fit_local(tc, blobs, 6, max_iter=20, seed=0)
    assert lit == tit and abs(lin - tin) <= 1e-5 * tin
    np.testing.assert_allclose(lc.numpy(), tcent.numpy(), rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(mnmg.kmeans_predict_local(tc, blobs, tcent),
                                  mnmg.kmeans_predict(tc, blobs, tcent).numpy())


def test_kmeans_fit_is_the_same_at_worlds_1_and_4(worlds, monkeypatch):
    """The partial sums go by round-sized row blocks in float64: with a
    block budget that makes them 5,000 rows (16 clusters of 1,024
    columns), shards of 5,000 rows give world 1's centers bit for bit."""
    from raft_tpu_torch.comms import mnmg_kmeans

    monkeypatch.setattr(mnmg_kmeans, "BLOCK_BUDGET_ELEMS", 1 << 23)
    assert mnmg_kmeans._aligned_block(16, 1024) == 5000
    rng = np.random.default_rng(17)
    centers = rng.uniform(-1, 1, (8, 1024)).astype(np.float32)
    x = (centers[rng.integers(0, 8, 20_000)]
         + rng.standard_normal((20_000, 1024))).astype(np.float32)
    one = mnmg.kmeans_fit(worlds[1][1], x, 16, max_iter=4, tol=0.0, seed=0)
    four = mnmg.kmeans_fit(worlds[4][1], x, 16, max_iter=4, tol=0.0, seed=0)
    assert torch.equal(one[0], four[0]) and one[1:] == four[1:]
