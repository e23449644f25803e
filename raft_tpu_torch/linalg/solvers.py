"""Dense solvers (counterpart of raft_tpu/linalg/solvers.py; linalg/eig.cuh,
svd.cuh, rsvd.cuh, qr.cuh, lstsq.cuh, cholesky_r1_update.cuh).

The factorizations are `torch.linalg` calls (cuSOLVER on the card, LAPACK
on the CPU), where the JAX package calls `jnp.linalg`; f32 products keep
TF32 off. Eigen- and singular vectors are unique only up to sign
(`matrix.sign_flip` canonicalizes them). `rsvd` draws its sketch from a
`torch.Generator` (seeded by `seed`, or the caller's `generator=`), so
its draws differ from the JAX package's by construction.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core.config import strict_f32_matmul
from raft_tpu_torch.core.validation import as_input as _t, as_tensor


def eigh(A, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric eigendecomposition, ascending (linalg/eig.cuh eigDC):
    (eigenvalues, eigenvectors[:, i])."""
    return torch.linalg.eigh(_t(A, device))


eig_dc = eigh  # reference name


def svd(A, full_matrices: bool = False, device=None
        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(U, S, V) with A = U @ diag(S) @ V.T (svd.cuh svdQR convention: V,
    not V^T)."""
    u, s, vh = torch.linalg.svd(_t(A, device), full_matrices=full_matrices)
    return u, s, vh.T


def qr(A, device=None) -> Tuple[torch.Tensor, torch.Tensor]:
    return torch.linalg.qr(_t(A, device))


def rsvd(A, k: int, p: int = 10, n_iter: int = 2, seed: int = 0,
         generator: Optional[torch.Generator] = None, device=None
         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Randomized SVD (rsvd.cuh): range finding by a gaussian sketch with
    power iterations, then the exact SVD of the small projection. Returns
    rank-k (U, S, V)."""
    from raft_tpu_torch.random.rng import make_generator

    a = _t(A, device).float()
    m, n = a.shape
    l = min(k + p, min(m, n))
    gen = generator if generator is not None else make_generator(seed, a.device)
    omega = torch.randn((n, l), generator=gen, device=a.device, dtype=a.dtype)
    strict_f32_matmul()
    q, _ = torch.linalg.qr(a @ omega)
    for _ in range(n_iter):
        q, _ = torch.linalg.qr(a @ (a.T @ q))
    ub, s, vh = torch.linalg.svd(q.T @ a, full_matrices=False)  # (l, n)
    u = q @ ub
    return u[:, :k], s[:k], vh[:k].T


def lstsq(A, b, method: str = "svd", device=None) -> torch.Tensor:
    """Least squares min ||Ax - b|| (lstsq.cuh lstsqSvdQR / lstsqEig).
    "svd": the pseudo-inverse with numpy's cutoff (singular values above
    eps * max(m, n) * s_max), as `jnp.linalg.lstsq`; "eig": the normal
    equations through an eigendecomposition."""
    a = _t(A, device)
    bb = as_tensor(b, a.device)
    strict_f32_matmul()
    if method == "eig":
        w, v = torch.linalg.eigh(a.T @ a)
        winv = torch.where(w > 1e-10 * torch.max(w), 1.0 / torch.clamp(w, min=1e-30), 0.0)
        rhs = v.T @ (a.T @ bb)
        return v @ (winv.reshape((-1,) + (1,) * (rhs.ndim - 1)) * rhs)
    u, s, vh = torch.linalg.svd(a, full_matrices=False)
    cutoff = torch.finfo(s.dtype).eps * max(a.shape) * (s[0] if s.numel() else 0.0)
    sinv = torch.where(s > cutoff, 1.0 / torch.where(s > cutoff, s, 1.0), 0.0)
    rhs = u.T @ bb
    return vh.T @ (sinv.reshape((-1,) + (1,) * (rhs.ndim - 1)) * rhs)


def cholesky(A, lower: bool = True, device=None) -> torch.Tensor:
    c = torch.linalg.cholesky(_t(A, device))
    return c if lower else c.T


def cholesky_r1_update(L, x, lower: bool = True, device=None) -> torch.Tensor:
    """Rank-1 Cholesky update (cholesky_r1_update.cuh): given L with
    L @ L.T = A, return L' with L' @ L'.T = A + x x^T, by the rotation of
    each column in turn (sequential by nature; n is small in its uses)."""
    Lw = _t(L, device).float()
    xc = as_tensor(x, Lw.device).float().reshape(-1).clone()
    Lc = (Lw if lower else Lw.T).clone()
    n = Lc.shape[0]
    idx = torch.arange(n, device=Lc.device)
    for k in range(n):
        lkk, xk = Lc[k, k].clone(), xc[k].clone()
        r = torch.sqrt(lkk * lkk + xk * xk)
        c = r / lkk
        s = xk / lkk
        col = Lc[:, k].clone()
        newcol = torch.where(idx >= k, (col + s * xc) / c, col)
        newcol[k] = r
        Lc[:, k] = newcol
        xc = torch.where(idx > k, c * xc - s * newcol, xc)
    Lout = torch.tril(Lc)
    return Lout if lower else Lout.T
