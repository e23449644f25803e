"""PyTorch port: `linalg`, the `matrix` helpers, the gram kernels and
`set_matmul_precision` against the JAX package on the same numpy inputs,
on the CPU.

Tolerances: elementwise results and reductions to 1e-5 relative;
decompositions (eigh, svd, qr) up to the sign of each vector
(`matrix.sign_flip`, as LAPACK and cuSOLVER may pick either) within
1e-4; `rsvd` draws its sketch from a torch generator, so it is held by
its reconstruction error against the exact rank-k SVD's; the gram
matrices to 1e-5 relative of the operands' scale.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raft_tpu.distance as jdist
import raft_tpu.linalg as jl
import raft_tpu.matrix as jm
import raft_tpu_torch.distance as tdist
import raft_tpu_torch.linalg as tl
import raft_tpu_torch.matrix as tm
from raft_tpu_torch.distance import pairwise as tpairwise

RTOL = 1e-5
RNG = np.random.default_rng(21)
X = RNG.standard_normal((7, 9)).astype(np.float32)
Y = RNG.standard_normal((9, 5)).astype(np.float32)
V9 = RNG.standard_normal(9).astype(np.float32)
V7 = RNG.standard_normal(7).astype(np.float32)
SPD = (lambda a: (a @ a.T + 6 * np.eye(6)).astype(np.float32))(RNG.random((6, 6)))
KEYS = np.array([0, 1, 0, 2, 1, 0, 2])


def _close(got, want, rtol=RTOL):
    got = got if isinstance(got, (tuple, list)) else (got,)
    want = want if isinstance(want, (tuple, list)) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu"
        w = np.asarray(w)
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=rtol, atol=rtol * max(1.0, np.abs(w).max()))


# name -> (args, kwargs); the same call on both packages
ELEMENTWISE = {
    "gemm": ((X, Y), {"alpha": 0.5}),
    "gemv": ((X, V9), {"alpha": 2.0, "beta": 1.0, "y": V7}),
    "axpy": ((0.3, X, X), {}),
    "dot": ((V9, V9), {}),
    "transpose": ((X,), {}),
    "unary_op": ((X, lambda a: a * 2), {}),
    "binary_op": ((X, X, lambda a, b: a - b * 3), {}),
    "ternary_op": ((X, X, X, lambda a, b, c: a * b + c), {}),
    "map_op": ((lambda a, b: a * b, X, X), {}),
    "eltwise_add": ((X, X), {}),
    "eltwise_sub": ((X, X[::-1].copy()), {}),
    "eltwise_multiply": ((X, X), {}),
    "eltwise_divide": ((X, X + 5.0), {}),
    "eltwise_power": ((np.abs(X), 1.5), {}),
    "eltwise_sqrt": ((np.abs(X),), {}),
    "scalar_add": ((X, 2.5), {}),
    "scalar_multiply": ((X, -1.5), {}),
    "reduce": ((X,), {"axis": 1, "main_op": lambda v: v ** 2}),
    "coalesced_reduction": ((X,), {}),
    "strided_reduction": ((X,), {}),
    "map_reduce": ((lambda a, b: a * b, X, X), {}),
    "norm": ((X,), {"norm_type": "l1", "axis": 0}),
    "row_norm": ((X,), {"sqrt": True}),
    "col_norm": ((X,), {"norm_type": "linf"}),
    "normalize": ((X,), {}),
    "mean_squared_error": ((X, X + 1.0), {"weight": 0.5}),
    "reduce_rows_by_key": ((X, KEYS, 3), {}),
    "reduce_cols_by_key": ((X.T.copy(), KEYS, 3), {}),
    "matrix_vector_op": ((X, V9), {}),
}


@pytest.mark.parametrize("name", sorted(ELEMENTWISE))
def test_linalg_matches_jax(name):
    args, kw = ELEMENTWISE[name]
    _close(getattr(tl, name)(*args, **kw, device="cpu"), getattr(jl, name)(*args, **kw))


@pytest.mark.parametrize("reduce_op,init", [("min", 0.0), ("max", 0.5), ("min", -0.2)])
def test_reduce_ops(reduce_op, init):
    _close(tl.reduce(X, axis=0, reduce_op=reduce_op, init=init, device="cpu"),
           jl.reduce(X, axis=0, reduce_op=reduce_op, init=init))


def test_gemm_transposes_and_beta():
    c = RNG.standard_normal((9, 9)).astype(np.float32)
    kw = dict(alpha=1.5, beta=0.25, C=c, trans_a=True)
    _close(tl.gemm(X, X, **kw, device="cpu"), jl.gemm(X, X, **kw))
    _close(tl.gemm(X, X, trans_b=True, device="cpu"), jl.gemm(X, X, trans_b=True))


def _up_to_sign(t, j):
    _close(tm.sign_flip(t), jm.sign_flip(j), rtol=1e-4)


def test_eigh_up_to_sign():
    tw, tv = tl.eigh(SPD, device="cpu")
    jw, jv = jl.eigh(SPD)
    _close(tw, jw, rtol=1e-4)
    _up_to_sign(tv, jv)
    assert tl.eig_dc is tl.eigh


@pytest.mark.parametrize("full", [False, True])
def test_svd_up_to_sign(full):
    tu, ts, tv = tl.svd(X, full_matrices=full, device="cpu")
    ju, js, jv = jl.svd(X, full_matrices=full)
    _close(ts, js, rtol=1e-4)
    if not full:  # the trailing vectors of a full basis are any basis
        _up_to_sign(tu, ju)
        _up_to_sign(tv, jv)
    r = min(X.shape)
    np.testing.assert_allclose((tu[:, :r] * ts) @ tv[:, :r].T, X, atol=1e-4)


def test_qr_up_to_sign():
    tq, tr = tl.qr(X.T.copy(), device="cpu")
    jq, jr = jl.qr(X.T.copy())
    _up_to_sign(tq, jq)
    s = torch.sign(torch.diagonal(tr)) * np.sign(np.diag(np.asarray(jr)))
    _close(tr * s[:, None], np.asarray(jr), rtol=1e-4)


def test_rsvd_by_reconstruction_error():
    rng = np.random.default_rng(5)
    a = (rng.standard_normal((120, 6)) @ rng.standard_normal((6, 40))
         + 0.01 * rng.standard_normal((120, 40))).astype(np.float32)
    k = 4
    u, s, v = tl.rsvd(a, k, device="cpu")
    assert u.shape == (120, k) and s.shape == (k,) and v.shape == (40, k)
    ju, js, jv = jl.rsvd(a, k)
    err = np.linalg.norm(a - (u * s).numpy() @ v.numpy().T)
    jerr = np.linalg.norm(a - (np.asarray(ju) * np.asarray(js)) @ np.asarray(jv).T)
    uu, ss, vt = np.linalg.svd(a.astype(np.float64))
    best = np.linalg.norm(a - (uu[:, :k] * ss[:k]) @ vt[:k])
    assert err <= best * 1.01 + 1e-4 and jerr <= best * 1.01 + 1e-4
    np.testing.assert_allclose(s.numpy(), ss[:k], rtol=1e-3)
    g = torch.Generator().manual_seed(7)
    u2, s2, _ = tl.rsvd(a, k, generator=g, device="cpu")
    np.testing.assert_allclose(s2.numpy(), ss[:k], rtol=1e-3)


@pytest.mark.parametrize("method", ["svd", "eig"])
def test_lstsq(method):
    a = RNG.random((12, 4)).astype(np.float32)
    b = a @ RNG.random(4).astype(np.float32)
    _close(tl.lstsq(a, b, method=method, device="cpu"), jl.lstsq(a, b, method=method),
           rtol=1e-3)


@pytest.mark.parametrize("lower", [True, False])
def test_cholesky_and_rank1_update(lower):
    _close(tl.cholesky(SPD, lower=lower, device="cpu"), jl.cholesky(SPD, lower=lower),
           rtol=1e-4)
    L = np.asarray(jl.cholesky(SPD, lower=lower))
    x = RNG.random(6).astype(np.float32)
    got = tl.cholesky_r1_update(L, x, lower=lower, device="cpu")
    _close(got, jl.cholesky_r1_update(L, x, lower=lower), rtol=1e-4)
    lo = got if lower else got.T
    np.testing.assert_allclose((lo @ lo.T).numpy(), SPD + np.outer(x, x), atol=1e-3)


def test_lanczos_resolves_to_the_sparse_solver():
    from raft_tpu_torch.sparse.solver import lanczos

    assert tl.lanczos is lanczos and "lanczos" in dir(tl)
    with pytest.raises(AttributeError):
        tl.not_a_name  # noqa: B018


# -- matrix helpers ----------------------------------------------------------

IDX = np.array([3, 0, 6, 3])
MASK = np.array([True, False, True, True])
A77 = RNG.standard_normal((7, 7)).astype(np.float32)
POS = np.abs(A77) + 0.1

MATRIX = {
    "gather": ((X, IDX), {}),
    "gather_if": ((X, IDX, MASK), {"fill_value": -1.0}),
    "scatter": ((X, IDX[:2], X[:2] * 2), {}),
    "argmax": ((X,), {}),
    "argmin": ((X,), {"axis": 0}),
    "slice": ((X, 1, 5, 2), {"col_end": 7}),
    "reverse": ((X,), {"axis": 1}),
    "linewise_op": ((X, V7, lambda m, v: m * v), {"along_rows": False}),
    "col_wise_sort": ((X,), {"ascending": False}),
    "norm_rows": ((X,), {"ord": 1}),
    "diagonal": ((A77,), {}),
    "set_diagonal": ((A77, V7), {}),
    "upper_triangular": ((A77,), {}),
    "lower_triangular": ((A77,), {}),
    "power": ((POS, 2.5), {}),
    "sqrt": ((POS,), {}),
    "reciprocal": ((np.array([[0.0, 2.0], [1e-9, -4.0]], np.float32),),
                   {"scalar": 3.0, "thres": 1e-6}),
    "ratio": ((POS,), {}),
    "sign_flip": ((X,), {}),
    "threshold": ((X, 0.2), {"fill_value": 9.0}),
    "copy": ((X,), {}),
}


def test_matrix_cases_cover_every_helper():
    assert tm.__all__ == jm.__all__
    helpers = set(jm.__all__) - {"select_k", "scan_select_k", "eye", "fill"}
    assert set(MATRIX) == helpers


@pytest.mark.parametrize("name", sorted(MATRIX))
def test_matrix_helper_matches_jax(name):
    args, kw = MATRIX[name]
    got = getattr(tm, name)(*args, **kw, device="cpu")
    want = getattr(jm, name)(*args, **kw)
    for g, w in zip(got if isinstance(got, tuple) else (got,),
                    want if isinstance(want, tuple) else (want,)):
        w = np.asarray(w)
        assert g.shape == w.shape and g.numpy().dtype == w.dtype, (g.dtype, w.dtype)
        np.testing.assert_allclose(g.numpy(), w, rtol=RTOL)


def test_eye_fill_and_the_scatter_copy():
    np.testing.assert_array_equal(tm.eye(3, 4, device="cpu").numpy(), np.asarray(jm.eye(3, 4)))
    assert tm.eye(2, dtype=np.float64, device="cpu").dtype == torch.float64
    np.testing.assert_array_equal(tm.fill((2, 3), 7.0, dtype=torch.int32, device="cpu").numpy(),
                                  np.full((2, 3), 7, np.int32))
    t = torch.as_tensor(X)
    tm.scatter(t, IDX[:1], X[:1] * 0)
    assert torch.equal(t, torch.as_tensor(X))  # out of place
    assert tm.gather(X, np.array([[0, 1], [2, 3]]), device="cpu").shape == (2, 2, 9)


# -- gram kernels and matmul precision ---------------------------------------


@pytest.mark.parametrize("kernel", ["LINEAR", "POLYNOMIAL", "RBF", "TANH"])
def test_gram_matrix_matches_jax(kernel):
    a = RNG.standard_normal((20, 6)).astype(np.float32) * 0.5
    b = RNG.standard_normal((13, 6)).astype(np.float32) * 0.5
    tp = tdist.KernelParams(tdist.KernelType[kernel], degree=2, gamma=0.3, coef0=0.5)
    jp = jdist.KernelParams(jdist.KernelType[kernel], degree=2, gamma=0.3, coef0=0.5)
    got = tdist.gram_matrix(a, b, tp, device="cpu")
    _close(got, jdist.gram_matrix(a, b, jp))
    assert torch.equal(tdist.kernel_factory(tp, device="cpu")(a, b), got)
    assert isinstance(tdist.kernel_factory(tp), tdist.GramMatrix)
    assert [t.name for t in tdist.KernelType] == [t.name for t in jdist.KernelType]


def test_set_matmul_precision(monkeypatch):
    from jax import lax

    monkeypatch.setattr(tpairwise, "_MATMUL_PRECISION", tpairwise._MATMUL_PRECISION)
    assert tpairwise._MATMUL_PRECISION == "highest"
    a = torch.as_tensor(X)
    full = tpairwise._dot(a, a)
    tdist.set_matmul_precision(lax.Precision.DEFAULT)
    assert tpairwise._MATMUL_PRECISION == "default"
    flag = torch.backends.cuda.matmul.allow_tf32
    # on the CPU TF32 does not exist: the dot is the same, the flag restored
    assert torch.equal(tpairwise._dot(a, a), full)
    assert torch.backends.cuda.matmul.allow_tf32 == flag
    tdist.set_matmul_precision("highest")
    assert tpairwise._MATMUL_PRECISION == "highest"
    tdist.set_matmul_precision(lax.Precision.HIGH)
    assert tpairwise._MATMUL_PRECISION == "highest"
    with pytest.raises(ValueError, match="precision"):
        tdist.set_matmul_precision("bf16x9")
    np.testing.assert_allclose(full.numpy(), np.asarray(jnp.asarray(X) @ jnp.asarray(X).T),
                               rtol=RTOL, atol=RTOL * 10)
