"""Pairwise distances (counterpart of raft_tpu/distance/pairwise.py).

Every metric of the pylibraft enum, as the JAX package computes it:
  - expanded (L2, cosine, correlation, hellinger, russelrao, jaccard,
    dice, inner product): one full-float32 matmul plus row-norm
    epilogues (TF32 off: the reference runs these dots at
    Precision.HIGHEST);
  - unexpanded, an elementwise term reduced over the depth: the seven
    metrics of `_KERNEL_METRICS` go through `ops.pairwise_tiled` (the
    hand-written CUDA kernel for a CUDA tensor, as a TPU always takes the
    Pallas engine; its plain version for a CPU tensor); Lp, Jensen-Shannon
    and Bray-Curtis stay PyTorch tensor code, row-blocked by
    `_tiled_rowwise` so the (bm, n, k) broadcast stays near 2^22 elements;
  - haversine on (lat, lon) rows, with the rounding of the longitude
    difference added back (the JAX program's f32 formula loses up to
    1.5e-4 of a short distance across the antimeridian).
"""

from __future__ import annotations

from typing import Callable

import torch

from raft_tpu_torch.core.config import auto_convert_output, strict_f32_matmul
from raft_tpu_torch.core.resources import accepts_resources
from raft_tpu_torch.core.validation import check_matrix, check_same_cols
from raft_tpu_torch.distance.distance_types import DistanceType, resolve_metric

_TINY = torch.finfo(torch.float32).tiny


#: precision of the expanded-distance dots (`set_matmul_precision`):
#: "highest", full float32 with TF32 off (the default: the JAX package's
#: Precision.HIGHEST, f32 parity with the reference's cuBLAS path), or
#: "default", TF32 on the tensor cores (the JAX DEFAULT's one-pass trade,
#: ~1e-3 relative error)
_MATMUL_PRECISION = "highest"
_PRECISIONS = {"highest": "highest", "high": "highest", "default": "default"}


def set_matmul_precision(precision) -> None:
    """Set the precision of the f32 distance matmuls: "highest" (the
    default; "high" reads the same) or "default" (TF32). A
    `jax.lax.Precision` member is read by its name."""
    global _MATMUL_PRECISION
    name = str(getattr(precision, "name", precision)).lower()
    if name not in _PRECISIONS:
        raise ValueError(f"unknown matmul precision {precision!r}; use 'highest' or 'default'")
    _MATMUL_PRECISION = _PRECISIONS[name]


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """x (m, k) @ y.T (k, n) in float32 at the module's precision: full
    float32 (TF32 off) unless `set_matmul_precision("default")` asked for
    TF32, which this call then enables and restores."""
    if _MATMUL_PRECISION == "default":
        matmul = torch.backends.cuda.matmul
        prev = matmul.allow_tf32
        matmul.allow_tf32 = True
        try:
            return x.float() @ y.float().T
        finally:
            matmul.allow_tf32 = prev
    strict_f32_matmul()
    return x.float() @ y.float().T


def _row_norms_sq(x: torch.Tensor) -> torch.Tensor:
    xf = x.float()
    return torch.sum(xf * xf, dim=1)


def _block_rows(m: int, n: int, k: int, budget_elems: int = 1 << 22) -> int:
    """Rows per block so the (bm, n, k) broadcast stays near the budget."""
    bm = min(max(1, budget_elems // max(1, n * k)), m)
    if bm >= 8:
        bm = bm // 8 * 8
    return max(1, bm)


def _tiled_rowwise(x: torch.Tensor, y: torch.Tensor,
                   row_fn: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
                   budget_elems: int = 1 << 22) -> torch.Tensor:
    """row_fn((bm, k), (n, k)) -> (bm, n) over row blocks of x; each
    block's broadcast lives only for that block."""
    m, k = x.shape
    n = y.shape[0]
    bm = _block_rows(m, n, k, budget_elems)
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    for s in range(0, m, bm):
        out[s:s + bm] = row_fn(x[s:s + bm], y)
    return out


# ---------------------------------------------------------------------------
# expanded family
# ---------------------------------------------------------------------------


def _l2_expanded(x, y, sqrt: bool):
    d = _dot(x, y)
    out = torch.clamp(_row_norms_sq(x)[:, None] + _row_norms_sq(y)[None, :] - 2.0 * d, min=0.0)
    return torch.sqrt(out) if sqrt else out


def _cosine(x, y):
    d = _dot(x, y)
    xn = torch.sqrt(_row_norms_sq(x))[:, None]
    yn = torch.sqrt(_row_norms_sq(y))[None, :]
    return 1.0 - d / torch.clamp(xn * yn, min=_TINY)


def _correlation(x, y):
    xf, yf = x.float(), y.float()
    return _cosine(xf - xf.mean(1, keepdim=True), yf - yf.mean(1, keepdim=True))


def _hellinger(x, y):
    # d = sqrt(1 - sum(sqrt(x_i * y_i)))
    d = _dot(torch.sqrt(torch.abs(x.float())), torch.sqrt(torch.abs(y.float())))
    return torch.sqrt(torch.clamp(1.0 - d, min=0.0))


def _russelrao(x, y):
    k = x.shape[1]
    return (k - _dot(x, y)) / k


def _jaccard(x, y):
    # binary semantics: 1 - |x & y| / |x | y|, counts from the dot and row sums
    d = _dot(x, y)
    sx = torch.sum(x.float(), dim=1)[:, None]
    sy = torch.sum(y.float(), dim=1)[None, :]
    return 1.0 - d / torch.clamp(sx + sy - d, min=_TINY)


def _dice(x, y):
    d = _dot(x, y)
    sx = torch.sum(x.float(), dim=1)[:, None]
    sy = torch.sum(y.float(), dim=1)[None, :]
    return 1.0 - 2.0 * d / torch.clamp(sx + sy, min=_TINY)


# ---------------------------------------------------------------------------
# unexpanded family: elementwise terms
# ---------------------------------------------------------------------------


def _canberra_term(a, b):
    num = torch.abs(a - b)
    den = torch.abs(a) + torch.abs(b)
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def _kl_term(a, b):
    # sum x * log(x / y) over x > 0 (distance_ops/kl_divergence.cuh)
    safe = (a > 0) & (b > 0)
    ratio = torch.where(safe, a / torch.where(safe, b, 1.0), 1.0)
    return torch.where(safe, a * torch.log(ratio), 0.0)


def _js_term(a, b):
    m = 0.5 * (a + b)
    pos_m = m > 0
    logm = torch.where(pos_m, torch.log(torch.where(pos_m, m, 1.0)), 0.0)
    ta = torch.where(a > 0, a * (torch.log(torch.where(a > 0, a, 1.0)) - logm), 0.0)
    tb = torch.where(b > 0, b * (torch.log(torch.where(b > 0, b, 1.0)) - logm), 0.0)
    return ta + tb


def _sum_terms(term_fn, finalize=None):
    def row_fn(xb, y):
        s = torch.sum(term_fn(xb[:, None, :].float(), y[None, :, :].float()), dim=-1)
        return finalize(s) if finalize is not None else s

    return row_fn


def _braycurtis_row(xb, y):
    a, b = xb[:, None, :].float(), y[None, :, :].float()
    num = torch.sum(torch.abs(a - b), dim=-1)
    den = torch.sum(torch.abs(a + b), dim=-1)
    return torch.where(den > 0, num / torch.where(den > 0, den, 1.0), 0.0)


def _sin_half_dlon(lon1, lon2):
    """sin((lon2 - lon1) / 2) with the f32 difference's rounding added
    back. Across the antimeridian lon2 - lon1 is near +-2 pi while the
    angle is small, so its rounding (up to 2.4e-7) is a large share of a
    short distance (1.5e-4 of one near 1e-3 rad). The rounding e is exact
    (TwoSum); the correction is e / 2 cos(s / 2), and where it matters (s
    near +-2 pi) cos(s / 2) is -1 to f32 precision, while elsewhere the
    term stays within two ulps of the result."""
    s = lon2 - lon1
    b = s - lon2
    e = (lon2 - (s - b)) - (lon1 + b)
    return torch.sin(0.5 * s) - 0.5 * e


def _haversine(x, y):
    # 2-d (lat, lon) in radians (spatial/knn haversine semantics)
    xf, yf = x.float(), y.float()
    lat1, lon1 = xf[:, 0][:, None], xf[:, 1][:, None]
    lat2, lon2 = yf[:, 0][None, :], yf[:, 1][None, :]
    sdlat = torch.sin(0.5 * (lat2 - lat1))
    sdlon = _sin_half_dlon(lon1, lon2)
    h = sdlat ** 2 + torch.cos(lat1) * torch.cos(lat2) * sdlon ** 2
    return 2.0 * torch.arcsin(torch.sqrt(torch.clamp(h, 0.0, 1.0)))


# ---------------------------------------------------------------------------
# dispatch
# ---------------------------------------------------------------------------

#: DistanceType -> `ops.pairwise_tiled` metric key (the JAX _PALLAS_METRICS)
_KERNEL_METRICS = {
    DistanceType.L1: "l1",
    DistanceType.Linf: "linf",
    DistanceType.L2Unexpanded: "l2_unexpanded",
    DistanceType.L2SqrtUnexpanded: "l2_sqrt_unexpanded",
    DistanceType.Canberra: "canberra",
    DistanceType.KLDivergence: "kl_divergence",
    DistanceType.HammingUnexpanded: "hamming",
}


def _pairwise_impl(x: torch.Tensor, y: torch.Tensor, metric: DistanceType, *,
                   metric_arg: float = 2.0) -> torch.Tensor:
    """(m, n) f32 distances between the rows of x and y under `metric`."""
    key = _KERNEL_METRICS.get(metric)
    if key is not None:
        from raft_tpu_torch.ops.pairwise_tiled import pairwise_tiled

        return pairwise_tiled(x, y, key)
    D = DistanceType
    if metric == D.L2Expanded:
        return _l2_expanded(x, y, sqrt=False)
    if metric == D.L2SqrtExpanded:
        return _l2_expanded(x, y, sqrt=True)
    if metric == D.CosineExpanded:
        return _cosine(x, y)
    if metric == D.CorrelationExpanded:
        return _correlation(x, y)
    if metric == D.InnerProduct:
        return _dot(x, y)
    if metric == D.HellingerExpanded:
        return _hellinger(x, y)
    if metric == D.RusselRaoExpanded:
        return _russelrao(x, y)
    if metric == D.JaccardExpanded:
        return _jaccard(x, y)
    if metric == D.DiceExpanded:
        return _dice(x, y)
    if metric == D.LpUnexpanded:
        p = float(metric_arg)
        return _tiled_rowwise(x, y, _sum_terms(lambda a, b: torch.abs(a - b) ** p,
                                               lambda s: s ** (1.0 / p)))
    if metric == D.JensenShannon:
        return _tiled_rowwise(x, y, _sum_terms(_js_term, lambda s: torch.sqrt(0.5 * s)))
    if metric == D.BrayCurtis:
        return _tiled_rowwise(x, y, _braycurtis_row)
    if metric == D.Haversine:
        return _haversine(x, y)
    raise ValueError(f"metric {metric} not implemented")


@auto_convert_output
@accepts_resources
def pairwise_distance(X, Y, out=None, metric="euclidean", p: float = 2.0, resources=None,
                      device=None):
    """The full (m, n) f32 pairwise distance matrix (pylibraft's
    `pairwise_distance`). `metric` is a DistanceType, its value or a
    pylibraft name; `p` is the Lp exponent. DistanceType.Precomputed
    returns X as it is. `out` is accepted for API parity and checked for
    shape (m, n); a new tensor is returned."""
    x = check_matrix(X, device=device, name="X")
    y = check_matrix(Y, device=x.device, name="Y")
    m = resolve_metric(metric)
    if m == DistanceType.Precomputed:
        return x
    if m == DistanceType.Haversine and x.shape[1] != 2:
        raise ValueError("haversine requires 2-d (lat, lon) inputs")
    check_same_cols(x, y, "X", "Y")
    result = _pairwise_impl(x, y, m, metric_arg=float(p))
    if out is not None and tuple(out.shape) != (x.shape[0], y.shape[0]):
        raise ValueError("out has wrong shape")
    return result


distance = pairwise_distance  # raft::distance::distance() alias
