"""Sparse solvers: the Borůvka MST and the Lanczos eigensolver
(counterpart of raft_tpu/sparse/solver.py; sparse/solver/mst.cuh and
sparse/solver/lanczos.cuh:68,132).

Borůvka: each round every component picks its lightest outgoing edge,
ties broken by the edge's canonical (lo, hi) endpoints and then by the
smallest directed edge id (a total order, so hooking forms 2-cycles at
most), the picked edges hook their components, 2-cycles are rooted at
the larger endpoint and 32 pointer jumps compress the forest. The JAX
package runs the rounds in one `lax.while_loop`; here the host drives
them and reads one flag a round (about log2 n rounds). The per-component
minima are `scatter_reduce(amin)`: a minimum is exact in any order, so
the `in_mst` mask is the reference's bit for bit on the same COO.

Lanczos: m steps with full reorthogonalization in f32 on a matvec
closure; the (m, m) tridiagonal eigenproblem is solved on the host in
f32 (small, the same on every run). Without `v0` the start vector is
drawn from a `torch.Generator` seeded with `seed`, so it differs from the
JAX package's draw by construction: pass the same `v0` to compare. The
JAX program takes a fixed m; from one start vector it resolves few of a
cluster of near-equal eigenvalues (a graph of blobs joined by single
edges has one a blob near 0), so the port adds an opt-in `tol` that runs
the same Krylov sequence on until the wanted pairs converge.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from raft_tpu_torch.sparse.formats import CooMatrix, CsrMatrix

_BIG = 2**31 - 1
#: the most Lanczos steps a `tol` run takes
MAX_NCV = 1024


def _segment_min(vals: torch.Tensor, seg: torch.Tensor, n: int, identity) -> torch.Tensor:
    out = torch.full((n,), identity, dtype=vals.dtype, device=vals.device)
    return out.scatter_reduce_(0, seg, vals, "amin", include_self=True)


def _boruvka(rows: torch.Tensor, cols: torch.Tensor, weights: torch.Tensor, n_vertices: int
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(component label of every vertex, in_mst mask over the edges) for
    int64 rows / cols and f32 weights."""
    dev = rows.device
    n_edges = rows.shape[0]
    lo = torch.minimum(rows, cols)
    hi = torch.maximum(rows, cols)
    eid = torch.arange(n_edges, device=dev)
    vid = torch.arange(n_vertices, device=dev)
    comp = vid.clone()
    in_mst = torch.zeros((n_edges,), dtype=torch.bool, device=dev)
    it, changed = 0, True
    while changed and it < n_vertices:
        cr, cc = comp[rows], comp[cols]
        cross = cr != cc
        key = torch.where(cross, weights, torch.inf)
        best_w = _segment_min(key, cr, n_vertices, torch.inf)
        at_min = (key == best_w[cr]) & cross
        best_lo = _segment_min(torch.where(at_min, lo, _BIG), cr, n_vertices, _BIG)
        at_lo = at_min & (lo == best_lo[cr])
        best_hi = _segment_min(torch.where(at_lo, hi, _BIG), cr, n_vertices, _BIG)
        is_best = at_lo & (hi == best_hi[cr])
        pick = _segment_min(torch.where(is_best, eid, n_edges), cr, n_vertices, n_edges)
        valid = pick < n_edges
        picked = pick[valid]
        in_mst[picked] = True
        # each valid pick's source component is its own segment: one write
        # an index
        parent = vid.clone()
        parent[comp[rows[picked]]] = comp[cols[picked]]
        p2 = parent[parent]
        parent = torch.where((p2 == vid) & (parent < vid), vid, parent)
        for _ in range(32):
            parent = parent[parent]
        new_comp = parent[comp]
        changed = bool(torch.any(new_comp != comp))
        comp = new_comp
        it += 1
    return comp, in_mst


def _mst_impl(coo: CooMatrix, n_vertices: Optional[int] = None
              ) -> Tuple[CooMatrix, torch.Tensor]:
    """(the forest, the component label of every vertex)."""
    n = coo.shape[0] if n_vertices is None else n_vertices
    rows = coo.rows.to(torch.int32)
    cols = coo.cols.to(torch.int32)
    w = coo.vals.to(torch.float32)
    comp, in_mst = _boruvka(rows.long(), cols.long(), w, n)
    r, c, v = rows[in_mst], cols[in_mst], w[in_mst]
    # one entry an undirected edge, its first occurrence, in (lo, hi) order
    # (`np.unique(return_index=True)`)
    key = torch.minimum(r, c).long() * coo.shape[1] + torch.maximum(r, c).long()
    uniq, inv = torch.unique(key, sorted=True, return_inverse=True)
    pos = torch.arange(key.shape[0], device=key.device)
    first = torch.full((uniq.shape[0],), key.shape[0], dtype=torch.int64, device=key.device)
    first.scatter_reduce_(0, inv, pos, "amin", include_self=True)
    return CooMatrix(r[first], c[first], v[first], coo.shape), comp


def mst(coo: CooMatrix, n_vertices: Optional[int] = None) -> CooMatrix:
    """Minimum spanning forest edges (sparse/solver/mst.cuh) of a
    symmetric COO graph: one direction per chosen edge, int32 ends and f32
    weights, in the order of the edges' (lo, hi) endpoints."""
    return _mst_impl(coo, n_vertices)[0]


# ---------------------------------------------------------------------------
# Lanczos
# ---------------------------------------------------------------------------


def _start_vector(n: int, seed: int, device) -> torch.Tensor:
    gen = torch.Generator(device=torch.device(device))
    gen.manual_seed(int(seed))
    return torch.randn((n,), generator=gen, dtype=torch.float32, device=device)


def _lanczos_steps(matvec: Callable, V: torch.Tensor, alphas: torch.Tensor,
                   betas: torch.Tensor, start: int, stop: int) -> None:
    """Steps start..stop-1 in place: alpha_i, beta_i and V[i + 1], each new
    vector reorthogonalized against every vector before it."""
    for i in range(start, stop):
        v = V[i]
        w = matvec(v)
        a = torch.dot(w, v)
        w = w - a * v
        if i > 0:
            w = w - betas[i - 1] * V[i - 1]
        w = w - V[:i + 1].T @ (V[:i + 1] @ w)
        b = torch.linalg.vector_norm(w)
        V[i + 1] = torch.where(b > 1e-8, w / torch.clamp(b, min=1e-30), 0.0)
        alphas[i] = a
        betas[i] = b


def _ritz_pairs(matvec: Callable, V: torch.Tensor, alphas: torch.Tensor,
                betas: torch.Tensor, m: int, k: int, which: str):
    """(eigenvalues, unit eigenvectors) of the k wanted Ritz pairs of the
    first m Lanczos vectors; the (m, m) tridiagonal eigenproblem on the
    host in f32."""
    dev = V.device
    a = alphas[:m].clone()
    a[m - 1] = torch.dot(matvec(V[m - 1]), V[m - 1])
    T = (torch.diag(a) + torch.diag(betas[:m - 1], 1) + torch.diag(betas[:m - 1], -1)).cpu()
    theta, S = torch.linalg.eigh(T)
    sel = torch.arange(k) if which == "smallest" else torch.arange(m - k, m).flip(0)
    vecs = (S[:, sel].T.to(dev) @ V[:m]).T
    vecs = vecs / torch.clamp(torch.linalg.vector_norm(vecs, dim=0, keepdim=True), min=1e-30)
    return theta[sel].to(dev), vecs


def ritz_residuals(matvec: Callable, vals: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """||A v - lambda v|| of each eigenpair (one matvec a pair)."""
    return torch.stack([torch.linalg.vector_norm(matvec(vecs[:, j]) - vals[j] * vecs[:, j])
                        for j in range(vecs.shape[1])])


def lanczos(matvec: Callable, n: int, n_components: int, which: str = "smallest",
            ncv: Optional[int] = None, seed: int = 0, v0=None, device=None,
            tol: Optional[float] = None, info: Optional[dict] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eigenpairs of a symmetric operator given as a matvec closure:
    (eigenvalues (k,), eigenvectors (n, k)), smallest first or largest
    first. Full reorthogonalization over m = min(n, ncv or max(2k + 8,
    32)) steps: the JAX package's program. The operator runs on `device`
    (the device of `v0` when it is a tensor and `device` is None).

    `tol` (None: the fixed m above) is the port's addition, the tolerance
    of RAFT's lanczos solver config: while a wanted pair's residual
    ||A v - lambda v|| is above it, the same Krylov sequence runs on to
    twice the steps, up to min(n, max(m, `MAX_NCV`)). The
    first m steps are those of the fixed run, so a run that meets `tol` at
    m returns its pairs unchanged. `info`, a dict, receives the steps
    taken ("ncv") and the residuals when `tol` is set."""
    from raft_tpu_torch.core.config import resolve_device
    from raft_tpu_torch.core.validation import as_tensor

    if device is None and isinstance(v0, torch.Tensor):
        device = v0.device
    dev = resolve_device(device)
    k = n_components
    m = min(n, ncv if ncv is not None else max(2 * k + 8, 32))
    cap = m if tol is None else min(n, max(m, MAX_NCV))
    v0 = _start_vector(n, seed, dev) if v0 is None else as_tensor(v0, dev).float()
    V = torch.zeros((cap, n), dtype=torch.float32, device=dev)
    V[0] = v0 / torch.linalg.vector_norm(v0)
    alphas = torch.zeros((cap,), dtype=torch.float32, device=dev)
    betas = torch.zeros((cap,), dtype=torch.float32, device=dev)
    _lanczos_steps(matvec, V, alphas, betas, 0, m - 1)
    vals, vecs = _ritz_pairs(matvec, V, alphas, betas, m, k, which)
    if tol is not None:
        resid = ritz_residuals(matvec, vals, vecs)
        while float(resid.max()) > tol and m < cap:
            m_next = min(cap, 2 * m)
            _lanczos_steps(matvec, V, alphas, betas, m - 1, m_next - 1)
            m = m_next
            vals, vecs = _ritz_pairs(matvec, V, alphas, betas, m, k, which)
            resid = ritz_residuals(matvec, vals, vecs)
        if info is not None:
            info["residuals"] = resid
    if info is not None:
        info["ncv"] = m
    return vals, vecs


def compute_smallest_eigenvectors(csr: CsrMatrix, k: int, seed: int = 0):
    """sparse/solver/lanczos.cuh:68 parity: the smallest eigenpairs of a CSR."""
    from raft_tpu_torch.sparse.linalg import spmv

    return lanczos(lambda v: spmv(csr, v), csr.shape[0], k, "smallest", seed=seed,
                   device=csr.device)


def compute_largest_eigenvectors(csr: CsrMatrix, k: int, seed: int = 0):
    from raft_tpu_torch.sparse.linalg import spmv

    return lanczos(lambda v: spmv(csr, v), csr.shape[0], k, "largest", seed=seed,
                   device=csr.device)
