"""Shared data and checks of the distributed IVF parity tests
(tests/test_torch_mnmg_*.py, test_torch_recovery.py): the seeded blob
rows, the carry-across of a JAX distributed index onto the port's world,
the id / value comparison and the patched-init builds."""

import numpy as np
import torch

import jax
import jax.numpy as jnp

from raft_tpu.cluster import kmeans as jkmeans
from raft_tpu_torch.comms import mnmg_ivf_build

#: about 2,003 x 16 rows so that no world divides them, 37 queries,
#: 16 lists, pq_dim 8 (the rotation is the identity: rot_dim == dim)
N, D, NQ, K, N_LISTS, PQ_DIM, N_PROBES = 2003, 16, 37, 10, 16, 8, 8
WORLDS = (1, 2, 4)


def blobs():
    """(x, q, exact top-K ids): 16 blobs, centers U(-5, 5), unit noise."""
    rng = np.random.default_rng(23)
    centers = rng.uniform(-5, 5, (N_LISTS, D)).astype(np.float32)
    x = (centers[rng.integers(0, N_LISTS, N)] + rng.standard_normal((N, D))).astype(np.float32)
    q = (centers[rng.integers(0, N_LISTS, NQ)]
         + rng.standard_normal((NQ, D))).astype(np.float32)
    d = ((q[:, None, :].astype(np.float64) - x[None].astype(np.float64)) ** 2).sum(-1)
    return x, q, np.argsort(d, axis=1, kind="stable")[:, :K]


def carry(tc, jidx, kind: str, params):
    """The port's Distributed* of `kind` on `tc` holding the JAX index's
    arrays (`mnmg_ivf_build.index_from_arrays`)."""
    arrays = {f: np.asarray(getattr(jidx, f)) for f in mnmg_ivf_build.DISTRIBUTED_FIELDS[kind]}
    for f in ("host_gids", "list_sizes", "local_gids", "local_sizes"):
        if getattr(jidx, f, None) is not None:
            arrays[f] = np.asarray(getattr(jidx, f))
    return mnmg_ivf_build.index_from_arrays(
        tc, kind, arrays, params, jidx.n, extended=bool(getattr(jidx, "extended", False)),
        bridged=bool(getattr(jidx, "bridged", False)))


def recall(ids, truth) -> float:
    ids = np.asarray(ids)
    return float(np.mean([len(set(a) & set(b)) / len(b) for a, b in zip(ids, truth)]))


def as_np(res):
    """(values, ids) of a search result (a pair or a DegradedSearchResult)
    of either package as numpy."""
    v, i = res[0], res[1]
    v = v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
    i = i.numpy() if isinstance(i, torch.Tensor) else np.asarray(i)
    return v, i


def assert_same(jres, tres, rtol=1e-5):
    """The port's (values, ids) against JAX's on one index: dtypes and
    shapes, values within `rtol` relative, ids equal but for swaps of
    values that agree within 1e-6 relative (ties)."""
    jv, ji = as_np(jres)
    tv, ti = as_np(tres)
    assert tv.dtype == np.float32 and ti.dtype == np.int32 and ti.shape == ji.shape
    finite = np.isfinite(jv)
    assert np.array_equal(finite, np.isfinite(tv))
    scale = max(1.0, float(np.abs(jv[finite]).max())) if finite.any() else 1.0
    np.testing.assert_allclose(tv[finite], jv[finite], rtol=rtol, atol=rtol * scale)
    for r, c in zip(*np.nonzero(ti != ji)):
        assert abs(float(jv[r, c]) - float(tv[r, c])) <= 1e-6 * max(1.0, abs(float(jv[r, c])))
        assert ti[r, c] in ji[r] or c == ti.shape[1] - 1


def assert_same_or_recall(jres, tres, truth, tol=0.005):
    """ROADMAP Queue C's rule for the bin trim and the bf16 engines: ids
    equal within groups of equal values, else recall equal within `tol`."""
    try:
        assert_same(jres, tres, rtol=1e-5)
    except AssertionError:
        assert abs(recall(as_np(tres)[1], truth) - recall(as_np(jres)[1], truth)) <= tol


def jax_plusplus(seed: int = 0):
    """A stand-in for the port's `cluster.kmeans._kmeans_plusplus` that
    returns the JAX package's seeding of the same rows (the JAX builds
    seed from `jax.random.PRNGKey(seed)`)."""
    def plusplus(gen, x, n_clusters):
        c = jkmeans._kmeans_plusplus(jax.random.PRNGKey(seed), jnp.asarray(x.cpu().numpy()),
                                     int(n_clusters))
        return torch.as_tensor(np.array(c), device=x.device)

    return plusplus


def near_tie_rows(x_rot, centers_a, centers_b, la, lb, rtol=1e-6) -> bool:
    """Whether every row whose label differs between two labellings sits
    within `rtol` of a tie between its two centers."""
    diff = np.flatnonzero(la != lb)
    if not diff.size:
        return True
    xd = x_rot[diff].astype(np.float64)
    da = ((xd - centers_a[la[diff]]) ** 2).sum(1)
    db = ((xd - centers_b[lb[diff]]) ** 2).sum(1)
    return bool(np.all(np.abs(da - db) <= rtol * np.maximum(da, 1.0)))
