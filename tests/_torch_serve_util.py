"""Shared data, index carries and checks of the serving and jobs parity
tests (tests/test_torch_serve*.py, test_torch_jobs.py): the JAX serving
suite's blob rows, a JAX index of each family carried onto the port with
`index_from_arrays` (the RaBitQ one with a signed-permutation rotation,
so both packages' scans agree bit for bit), and a tie-aware comparison of
(values, ids) pairs."""

import jax.numpy as jnp
import numpy as np
import torch

from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import ivf_rabitq as jrb
from raft_tpu.random import make_blobs as jmake_blobs
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import ivf_rabitq as trb

DIM = 16
KINDS = ("ivf_flat", "ivf_pq", "ivf_rabitq")
TMOD = {"ivf_flat": tfl, "ivf_pq": tpq, "ivf_rabitq": trb}
JMOD = {"ivf_flat": jfl, "ivf_pq": jpq, "ivf_rabitq": jrb}


def blobs(n=1024, dim=DIM):
    """tests/test_serve.py's rows: JAX make_blobs, 6 clusters, std 0.4."""
    data, _ = jmake_blobs(n, dim, n_clusters=6, cluster_std=0.4, seed=13)
    return np.asarray(data)


def signed_perm(dim, seed=11):
    """A (rot_dim, dim) rotation whose first `dim` rows are a signed
    permutation and whose padding rows (up to RaBitQ's 32-bit words) are
    zero: `x @ rotation.T` is exact in both packages."""
    prng = np.random.default_rng(seed)
    rot_dim = -(-dim // 32) * 32
    perm = np.zeros((rot_dim, dim), np.float32)
    perm[np.arange(dim), prng.permutation(dim)] = prng.choice([-1.0, 1.0], dim)
    return perm


def jax_params(kind, n_lists=8, pq_dim=8, empty=False):
    """The JAX build params of each family (`empty`: a trained index with
    no rows, the cold-start seed of a streamed build)."""
    add = dict(add_data_on_build=False) if empty else {}
    if kind == "ivf_flat":
        return jfl.IndexParams(n_lists=n_lists, kmeans_n_iters=3, **add)
    if kind == "ivf_pq":
        return jpq.IndexParams(n_lists=n_lists, pq_dim=pq_dim, kmeans_n_iters=3,
                               kmeans_trainset_fraction=1.0, **add)
    return jrb.IndexParams(n_lists=n_lists, kmeans_n_iters=3, store_dataset=False,
                           add_data_on_build=False)


def jax_build(kind, x, n_lists=8, pq_dim=8, empty=False):
    """A JAX index of `kind` on `x` (RaBitQ: re-based onto a signed
    permutation rotation, then extended with `x` unless `empty`)."""
    if kind != "ivf_rabitq":
        return JMOD[kind].build(jax_params(kind, n_lists, pq_dim, empty), x)
    perm = signed_perm(x.shape[1])
    jb = jrb.build(jax_params(kind, n_lists), x)
    cent = (np.asarray(jb.centers) @ np.asarray(jb.rotation) @ perm.T).astype(np.float32)
    idx = jrb.Index(jb.params, jnp.asarray(perm), jnp.asarray(cent), jb.codes, jb.aux,
                    jb.slot_rows, jb.list_sizes, jb.source_ids)
    return idx if empty else jrb.extend(idx, x)


def carry(kind, jidx, n_lists=8, pq_dim=8):
    """The port's copy of a JAX index, on the CPU."""
    mod = TMOD[kind]
    arrays = {f: np.asarray(getattr(jidx, f)) for f in mod.INDEX_FIELDS}
    if kind == "ivf_flat":
        if getattr(jidx, "list_radii", None) is not None:
            arrays["list_radii"] = np.asarray(jidx.list_radii)
        return tfl.index_from_arrays(arrays, tfl.IndexParams(n_lists=n_lists), device="cpu")
    if kind == "ivf_pq":
        if getattr(jidx, "list_radii", None) is not None:
            arrays["list_radii"] = np.asarray(jidx.list_radii)
        return tpq.index_from_arrays(arrays, tpq.IndexParams(n_lists=n_lists, pq_dim=pq_dim),
                                     device="cpu")
    return trb.index_from_arrays(arrays, trb.IndexParams(n_lists=n_lists, store_dataset=False),
                                 device="cpu")


def as_np(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def assert_tie_equal(tv, ti, jv, ji, rtol=1e-5, scale=1.0):
    """Values within `rtol` of each row's largest finite magnitude (or of
    `scale` where larger: an expanded L2's cancellation errs relative to
    the squared norms, not to the distance), and ids equal but for their
    order within a group of such values (a group that reaches the row's
    end may hold other ids of that value)."""
    tv, ti, jv, ji = as_np(tv), as_np(ti), as_np(jv), as_np(ji)
    assert ti.shape == ji.shape and tv.shape == jv.shape
    va, vb = jv.astype(np.float64), tv.astype(np.float64)
    fin = np.isfinite(va)
    np.testing.assert_array_equal(fin, np.isfinite(vb))
    np.testing.assert_array_equal(va[~fin], vb[~fin])
    tol = rtol * np.maximum(np.where(fin, np.abs(va), 0).max(axis=1), max(scale, 1.0))
    err = np.where(fin, np.abs(va - vb), 0)
    assert (err <= tol[:, None]).all(), float(err.max())
    for r in np.nonzero((ti != ji).any(axis=1))[0]:
        for c in np.nonzero(ti[r] != ji[r])[0]:
            group = np.abs(va[r] - va[r, c]) <= tol[r]
            if not group[-1]:
                assert set(ti[r][group]) == set(ji[r][group]), (r, c)


def assert_bitwise(a_v, a_i, b_v, b_i):
    np.testing.assert_array_equal(as_np(a_i), as_np(b_i))
    np.testing.assert_array_equal(as_np(a_v).view(np.int32), as_np(b_v).view(np.int32))


def norm_scale(*arrays) -> float:
    """The largest squared row norm of the arrays plus the largest of the
    queries': the magnitude an expanded L2 distance cancels from."""
    return float(sum(float((np.asarray(a, np.float64) ** 2).sum(1).max()) for a in arrays))
