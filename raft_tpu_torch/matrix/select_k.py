"""select_k: batched top-k selection (counterpart of raft_tpu/matrix/select_k.py).

The order is pinned to the one `lax.top_k` gives the JAX reference: the
total order of the float bits (-0.0 strictly before +0.0, NaNs at the
ends by sign), equal values to the smaller index. `torch.topk` promises
no tie order and `torch.sort` treats the two zeros as equal, so selection
here is a stable sort of the order-preserving integer image of the bits
(`_order_key`), which keeps equal keys in index order in both directions.

`select_k` strategies: "topk" and "two_phase" (the chunked path for long
rows) select with that sort; "counting" runs the `counting_select_min`
kernel (ops/select_counting.py) on the f32 image and sorts only the k
survivors. `strategy=None` reads the tuned table (core/tuned.py) for
CUDA tensors, as the JAX package reads it on a TPU: `select_k_strategy`
may force an engine, `select_k_chunk_threshold` moves the length past
which rows go two-phase, and `select_k_auto_strategy` = "counting" (or
`select_k_strategy` = "counting") promotes every internal
`_select_k_impl` whose rows fit the kernel (`_counting_promoted`). On the
CPU, and without a tuned value, the choice is the JAX package's untuned
one.

`select_k` returns int32 indices on every strategy, as the JAX package
does (`lax.top_k`'s and the counting kernel's index type); the private
`_select_k_impl` keeps int64 positions for the callers that gather with
them.

`scan_select_k` is the operand-level door: "fused" hands scoring and
selection to the fused kernel (ops/fused_scan.py), "two_phase"
materializes the distances and selects; None/"auto" resolves through
`resolve_scan_strategy` (a tuned `select_k_strategy` = "fused" promotes
the kernel where it fits). `list_scan_select_k` is the list-geometry
door the IVF engines use, with `resolve_int8_trim_strategy` for IVF-PQ's
int8 trim, and `bitplane_scan_select_k` the RaBitQ bit-plane one
(`resolve_bitplane_strategy`); both promote their kernel only on a tuned
value, for CUDA tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from raft_tpu_torch.core import tuned
from raft_tpu_torch.core.resources import accepts_resources
from raft_tpu_torch.core.tuned import BITPLANE_SCAN_KEY, INT8_SCAN_KEY
from raft_tpu_torch.core.validation import as_tensor, check_matrix, check_same_cols
from raft_tpu_torch.distance.distance_types import (
    DistanceType,
    SIMILARITY_METRICS,
    resolve_metric,
)

# Rows longer than this go through the two-phase chunked path.
_CHUNK_THRESHOLD = 1 << 16
_CHUNK = 1 << 14

# dtypes whose values embed exactly in f32: the ones strategy="counting"
# admits (the JAX package's list)
_COUNTING_DTYPES = (torch.float32, torch.bfloat16, torch.float16,
                    torch.int8, torch.int16, torch.uint8, torch.uint16)


def _order_key(vals: torch.Tensor) -> torch.Tensor:
    """An integer image of `vals` in the total order `lax.top_k` ranks
    by: the float bits as a signed integer, the magnitude bits flipped
    where the sign is set (so -0.0 sorts strictly before +0.0). bf16 and
    f16 go through f32, which is exact. Integer rows are their own key."""
    if not vals.is_floating_point():
        return vals
    if vals.dtype == torch.float64:
        b, flip = vals.contiguous().view(torch.int64), 0x7FFFFFFFFFFFFFFF
    else:
        b, flip = vals.float().contiguous().view(torch.int32), 0x7FFFFFFF
    return torch.where(b < 0, b ^ flip, b)


def _sorted_top(vals: torch.Tensor, k: int, largest: bool):
    """The first k of a stable sort of `_order_key(vals)`, ascending or,
    for `largest`, descending: ties keep index order either way. Values
    are gathered from `vals`, so they keep its dtype and bits."""
    _, i = torch.sort(_order_key(vals), dim=-1, descending=largest, stable=True)
    i = i[..., :k]
    return torch.gather(vals, -1, i), i


def _two_phase(vals: torch.Tensor, k: int, largest: bool, chunk: int = _CHUNK):
    """Per-chunk top-k, then a merge top-k over the candidates. The
    candidates stay in chunk order, so the stable merge keeps the
    smaller-index tie rule."""
    n = vals.shape[-1]
    nchunks = -(-n // chunk)
    pad = nchunks * chunk - n
    if pad:
        fill = float("-inf") if largest else float("inf")
        vals = torch.nn.functional.pad(vals, (0, pad), value=fill)
    chunked = vals.reshape(*vals.shape[:-1], nchunks, chunk)
    cv, ci = _sorted_top(chunked, min(k, chunk), largest)
    ci = ci + (torch.arange(nchunks, device=vals.device) * chunk)[:, None]
    cv = cv.reshape(*vals.shape[:-1], -1)
    ci = ci.reshape(*vals.shape[:-1], -1)
    mv, mi = _sorted_top(cv, k, largest)
    return mv, torch.gather(ci, -1, mi)


#: matrix-input strategies the tuned `select_k_strategy` key may name
#: ("fused" is operand-level only)
_MATRIX_STRATEGIES = ("topk", "two_phase", "counting")


def _tuned_strategy(device):
    """The tuned `select_k_strategy` for work on `device`, or None (no
    value, an out-of-set value, or a device the table does not govern)."""
    if not tuned.applies(device):
        return None
    t = tuned.get("select_k_strategy")
    return t if t in _MATRIX_STRATEGIES + ("fused",) else None


def _tuned_chunk_threshold(device):
    """The tuned row length past which rows go two-phase, or None; a
    value that is not a positive number degrades to the built-in one."""
    if not tuned.applies(device):
        return None
    t = tuned.get("select_k_chunk_threshold")
    if not isinstance(t, (int, float)) or isinstance(t, bool) or t <= 0:
        return None
    return int(t)


def _counting_promoted(vals: torch.Tensor, k: int) -> bool:
    """Whether an untold select goes to the counting kernel: a tuned
    promotion (`select_k_auto_strategy` = "counting", or
    `select_k_strategy` = "counting") for a CUDA tensor of a dtype in
    `_COUNTING_DTYPES`, within the kernel's envelope
    (`ops.select_counting.fits_counting`). Rows of more than two axes
    select along the last one as one (B, L) matrix: the port's list-major
    trims select over (chunks, rows, slots) scores, where the JAX package
    calls `lax.approx_min_k`."""
    if vals.ndim < 2 or vals.dtype not in _COUNTING_DTYPES or not tuned.applies(vals.device):
        return False
    if not (tuned.get("select_k_auto_strategy") == "counting"
            or _tuned_strategy(vals.device) == "counting"):
        return False
    from raft_tpu_torch.ops.select_counting import fits_counting

    L = int(vals.shape[-1])
    return fits_counting(vals.numel() // max(1, L), L + (-L) % 128, int(k))


def _select_k_impl(vals: torch.Tensor, k: int, select_min: bool,
                   forced: Optional[str] = None):
    """(values, int64 indices) of the k best per row, best-first."""
    if forced is None and _counting_promoted(vals, k):
        return _select_k_counting(vals, k, select_min)
    n = vals.shape[-1]
    largest = not select_min
    if forced is None:
        forced = _tuned_strategy(vals.device)
    if forced == "topk":
        return _sorted_top(vals, k, largest)
    if forced == "two_phase":
        if n > 2 * _CHUNK and k <= _CHUNK // 4:
            return _two_phase(vals, k, largest)
        return _sorted_top(vals, k, largest)
    thresh = _tuned_chunk_threshold(vals.device) or _CHUNK_THRESHOLD
    if n <= thresh or n <= 2 * _CHUNK or k > _CHUNK // 4:
        return _sorted_top(vals, k, largest)
    return _two_phase(vals, k, largest)


def _select_k_counting(vals: torch.Tensor, k: int, select_min: bool):
    """The counting engine (ops/select_counting.py): exactly the k best,
    unsorted, then a stable sort of those k for the best-first contract.
    Leading axes fold into the kernel's rows. Cast to f32 BEFORE negating
    (integer negation wraps; f32 negation is exact for every admitted
    dtype), pad to a multiple of 128 with +inf; values come back in the
    input dtype (exact)."""
    from raft_tpu_torch.ops.select_counting import counting_select_min

    lead = vals.shape[:-1]
    v = vals.float().reshape(-1, vals.shape[-1])
    if not select_min:
        v = -v
    pad = (-v.shape[-1]) % 128
    if pad:
        v = torch.nn.functional.pad(v, (0, pad), value=float("inf"))
    cv, ci = counting_select_min(v.contiguous(), k)
    sv, order = _sorted_top(cv, k, largest=False)
    out = sv if select_min else -sv
    idx = torch.gather(ci, -1, order).long()
    return out.to(vals.dtype).reshape(*lead, k), idx.reshape(*lead, k)


@accepts_resources
def select_k(values, k: int, select_min: bool = True, indices=None, resources=None,
             strategy: Optional[str] = None, device=None):
    """Select the k smallest (default) or largest values per row.

    Returns (values, int32 indices), each (batch, k), best-first, in the
    total order of the float bits with ties to the smaller index.
    `strategy`: None/"auto" by row length, "topk", "two_phase", or
    "counting" (the `counting_select_min` kernel; 2-d rows of a dtype in
    `_COUNTING_DTYPES`, others raise ValueError). With `indices`, the
    positions map to the caller's ids, in the ids' dtype."""
    vals = as_tensor(values, device)
    squeeze = vals.ndim == 1
    if squeeze:
        vals = vals[None, :]
    if not (0 < k <= vals.shape[-1]):
        raise ValueError(f"k={k} out of range for row length {vals.shape[-1]}")
    if strategy not in (None, "auto", "topk", "two_phase", "counting"):
        raise ValueError(f"unknown select_k strategy {strategy!r}")
    if strategy == "counting":
        if vals.dtype not in _COUNTING_DTYPES:
            raise ValueError(
                f"strategy='counting' requires an f32-embeddable dtype, got {vals.dtype}")
        if vals.ndim != 2:
            raise ValueError(f"strategy='counting' takes 1-d or 2-d values, got {vals.ndim}-d")
        v, i = _select_k_counting(vals, int(k), bool(select_min))
    else:
        forced = strategy if strategy in ("topk", "two_phase") else None
        v, i = _select_k_impl(vals, int(k), bool(select_min), forced)
    if indices is not None:
        idx = as_tensor(indices, vals.device)
        if idx.ndim == 1:
            idx = idx[None, :]
        i = torch.gather(idx.expand(vals.shape[0], -1), -1, i)
    else:
        i = i.to(torch.int32)
    if squeeze:
        v, i = v[0], i[0]
    return v, i


# ---------------------------------------------------------------------------
# operand-level dispatch
# ---------------------------------------------------------------------------

SCAN_STRATEGIES = ("fused", "two_phase")


def _fused_metric_kind(metric):
    """("l2"|"ip", want_sqrt) when the fused kernel covers `metric`, else None."""
    D = DistanceType
    if metric == D.InnerProduct:
        return "ip", False
    if metric in (D.L2Expanded, D.L2Unexpanded):
        return "l2", False
    if metric in (D.L2SqrtExpanded, D.L2SqrtUnexpanded):
        return "l2", True
    return None


def _scan_fused_impl(queries, dataset, k: int, metric, valid=None):
    from raft_tpu_torch.ops.fused_scan import fused_topk

    kind, want_sqrt = _fused_metric_kind(metric)
    ip = kind == "ip"
    vc, ids = fused_topk(queries.float(), dataset.float(), k, inner_product=ip, valid=valid)
    vc, ids = vc[:, :k], ids[:, :k]
    ids = torch.where(torch.isfinite(vc), ids, -1)
    if ip:
        return -vc, ids
    # the kernel scores the bf16-rounded geometry; |q|^2 must come from
    # the SAME rounded rows or near-tie ranks and values drift apart
    qb = queries.float().to(torch.bfloat16).float()
    v = torch.clamp(vc + torch.sum(qb * qb, dim=1, keepdim=True), min=0.0)
    return (torch.sqrt(v) if want_sqrt else v), ids


def _scan_two_phase_impl(queries, dataset, k: int, metric, valid=None):
    from raft_tpu_torch.distance.pairwise import _pairwise_impl

    select_min = metric not in SIMILARITY_METRICS
    d = _pairwise_impl(queries, dataset, metric)
    if valid is not None:
        d = torch.where(valid[None, :], d, float("inf") if select_min else float("-inf"))
    v, i = _select_k_impl(d, k, select_min, forced="two_phase")
    # one contract on both strategies: a slot holding the worst value
    # (fewer than k survivors of `valid`) reports id -1
    i = torch.where(torch.isfinite(v), i, -1)
    return v, i.to(torch.int32)


def resolve_scan_strategy(n_rows: int, dim: int, k: int, strategy=None,
                          fused_ok: bool = True, device=None) -> str:
    """Resolve a scan_select_k strategy: explicit wins, an unknown name
    raises ValueError; None/"auto" is "fused" where a tuned
    `select_k_strategy` = "fused" governs `device` (CUDA) and the kernel
    covers the metric (`fused_ok`) and the geometry (`fits_fused`), else
    "two_phase"."""
    if strategy in SCAN_STRATEGIES:
        return strategy
    if strategy not in (None, "auto"):
        raise ValueError(f"unknown scan_select_k strategy {strategy!r}")
    if fused_ok and _tuned_strategy(device) == "fused":
        from raft_tpu_torch.ops.fused_scan import fits_fused

        if fits_fused(1, n_rows, dim, k):
            return "fused"
    return "two_phase"


@accepts_resources
def scan_select_k(queries, dataset, k: int, metric="sqeuclidean",
                  strategy: Optional[str] = None, valid=None, resources=None, device=None):
    """Top-k nearest dataset rows per query over OPERANDS; returns
    ((nq, k) values, (nq, k) int32 ids), best-first, ties to the smaller
    row id. "fused": the fused distance+select-k kernel (L2/IP, exact
    over bf16-rounded operands, k <= FUSED_MAX_K); "two_phase": f32
    pairwise distances + select; None/"auto": `resolve_scan_strategy`.
    `valid`: optional (n_rows,) bool mask; False rows are excluded before
    selection, and where fewer than k rows survive the tail holds the
    worst value with id -1 on both strategies."""
    q = check_matrix(queries, device=device, name="queries")
    ds = check_matrix(dataset, device=q.device, name="dataset")
    check_same_cols(ds, q, "dataset", "queries")
    if not (0 < k <= ds.shape[0]):
        raise ValueError(f"k={k} out of range for dataset with {ds.shape[0]} rows")
    if valid is not None:
        valid = as_tensor(valid, q.device, torch.bool)
        if tuple(valid.shape) != (ds.shape[0],):
            raise ValueError(f"valid must be ({ds.shape[0]},), got {tuple(valid.shape)}")
    m = resolve_metric(metric)
    strategy = resolve_scan_strategy(ds.shape[0], ds.shape[1], int(k), strategy,
                                     fused_ok=_fused_metric_kind(m) is not None,
                                     device=q.device)
    if strategy == "fused":
        from raft_tpu_torch.ops.fused_scan import FUSED_MAX_K, fits_fused

        if _fused_metric_kind(m) is None:
            raise ValueError(f"strategy='fused' supports L2/inner_product metrics, got {m}")
        if not fits_fused(q.shape[0], ds.shape[0], ds.shape[1], int(k)):
            raise ValueError(
                f"strategy='fused' caps k at {FUSED_MAX_K} and the dimension "
                "at the kernel's shared-memory budget; use strategy='two_phase'"
            )
        return _scan_fused_impl(q, ds, int(k), m, valid)
    return _scan_two_phase_impl(q, ds, int(k), m, valid)


# ---------------------------------------------------------------------------
# list-scan dispatch
# ---------------------------------------------------------------------------

LIST_SCAN_STRATEGIES = ("fused", "fused_int8")


def resolve_int8_trim_strategy(L: int, rot: int, k: int, kbuf: Optional[int] = None,
                               strategy: Optional[str] = None, device=None):
    """IVF-PQ's int8 list-major trim: explicit "fused_int8" wins (the call
    site checks its envelope and raises past it); None/"auto" is
    "fused_int8" where a tuned `select_k_strategy_int8` governs `device`
    (CUDA) and the int8 kernel fits the geometry, else None (the caller
    keeps its own trim)."""
    if strategy == "fused_int8":
        return strategy
    if strategy not in (None, "auto"):
        raise ValueError(f"unknown int8 trim strategy {strategy!r}")
    if not tuned.applies(device) or tuned.get(INT8_SCAN_KEY) != "fused_int8":
        return None
    from raft_tpu_torch.ops.fused_scan import fits_fused_list

    if fits_fused_list(L, rot, int(k), kbuf=kbuf, q_int8=True):
        return "fused_int8"
    return None


def check_fused_list_request(label: str, L: int, rot: int, k: int,
                             kbuf: Optional[int], fallback: str, q_int8: bool = False) -> int:
    """Validate an explicit fused list-scan request against the kernel's
    caps and shared-memory budget (the int8 kernel's own with `q_int8`);
    returns the candidate-buffer width the kernel must run with (>= the
    caller's recorded `kbuf`)."""
    from raft_tpu_torch.ops.fused_scan import FUSED_MAX_K, fits_fused_list, fused_kbuf

    if int(k) > FUSED_MAX_K:
        raise ValueError(f"{label} caps per-list candidates at {FUSED_MAX_K}; k={k}")
    kb = max(fused_kbuf(int(k)), kbuf or 0)
    if not fits_fused_list(L, rot, int(k), kbuf=kb, q_int8=q_int8):
        raise ValueError(
            f"{label}: list length {L} exceeds the kernel's shared-memory "
            f"budget; use {fallback}"
        )
    return kb


def list_scan_select_k(lof, qres, store, base, k: int, strategy: str = "fused",
                       q_scale=None, kbuf: Optional[int] = None, inner_product: bool = False,
                       chunk_valid=None, chunk_rows=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-list fused scan+select over a slot-table store: the
    `ops.fused_scan` list contract. "fused" rounds the operands to bf16
    (`fused_list_topk`); "fused_int8" takes int8 `qres` and store and the
    (ncb, chunk, 1) per-row `q_scale` (`fused_list_topk_int8`)."""
    if strategy not in LIST_SCAN_STRATEGIES:
        raise ValueError(f"unknown list-scan strategy {strategy!r}")
    if strategy == "fused_int8":
        if q_scale is None:
            raise ValueError("strategy='fused_int8' requires q_scale")
        from raft_tpu_torch.ops.fused_scan import fused_list_topk_int8

        return fused_list_topk_int8(lof, qres, store, base, q_scale, int(k), kbuf=kbuf,
                                    inner_product=inner_product, chunk_valid=chunk_valid,
                                    chunk_rows=chunk_rows)
    if q_scale is not None:
        raise ValueError("q_scale requires strategy='fused_int8'")
    from raft_tpu_torch.ops.fused_scan import fused_list_topk

    return fused_list_topk(lof, qres, store, base, int(k), kbuf=kbuf,
                           inner_product=inner_product, chunk_valid=chunk_valid,
                           chunk_rows=chunk_rows)


# ---------------------------------------------------------------------------
# bit-plane scan dispatch (IVF-RaBitQ)
# ---------------------------------------------------------------------------

BITPLANE_STRATEGIES = ("xla", "fused_bitplane")


def resolve_bitplane_strategy(L: int, words: int, bits: int, k: int,
                              kbuf: Optional[int] = None, strategy: Optional[str] = None,
                              device=None) -> str:
    """The RaBitQ scan engine: "xla" is the materializing bit-plane scan
    (`ivf_rabitq._search_impl_rabitq`), "fused_bitplane" the fused kernel.
    Explicit wins (the call site validates the envelope with
    `check_bitplane_request` and raises past it); None/"auto" is
    "fused_bitplane" where a tuned `select_k_strategy_bitplane` governs
    `device` (CUDA) and the kernel fits the geometry, else "xla"."""
    if strategy in BITPLANE_STRATEGIES:
        return strategy
    if strategy not in (None, "auto"):
        raise ValueError(f"unknown bitplane scan strategy {strategy!r}")
    if not tuned.applies(device) or tuned.get(BITPLANE_SCAN_KEY) != "fused_bitplane":
        return "xla"
    from raft_tpu_torch.ops.fused_scan import fits_fused_bitplane

    if fits_fused_bitplane(L, words, int(bits), int(k), kbuf=kbuf):
        return "fused_bitplane"
    return "xla"


def check_bitplane_request(label: str, L: int, words: int, bits: int, k: int,
                           kbuf: Optional[int], fallback: str) -> int:
    """`check_fused_list_request` for the bit-plane geometry: raises past
    the kernel's caps or envelope; returns the candidate-buffer
    width the kernel must run with (>= the caller's recorded `kbuf`)."""
    from raft_tpu_torch.ops.fused_scan import FUSED_MAX_K, fits_fused_bitplane, fused_kbuf

    if int(k) > FUSED_MAX_K:
        raise ValueError(f"{label} caps scan candidates at {FUSED_MAX_K}; rerank depth {k}")
    kb = max(fused_kbuf(int(k)), kbuf or 0)
    if not fits_fused_bitplane(L, words, int(bits), int(k), kbuf=kb):
        raise ValueError(
            f"{label}: list length {L} x {words} words x {bits} query bits is outside the "
            f"kernel's envelope; use {fallback}"
        )
    return kb


def bitplane_scan_select_k(lof, planes, codes_t, meta, base, qmeta, k: int, rot_dim: int,
                           bits: int, kbuf: Optional[int] = None, inner_product: bool = False,
                           chunk_valid=None, chunk_rows=None
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The RaBitQ bit-plane fused scan+select (strategy "fused_bitplane")
    at the select_k level: `ops.fused_scan.fused_bitplane_topk` on the
    same operands."""
    from raft_tpu_torch.ops.fused_scan import fused_bitplane_topk

    return fused_bitplane_topk(lof, planes, codes_t, meta, base, qmeta, int(k),
                               rot_dim=int(rot_dim), bits=int(bits), kbuf=kbuf,
                               inner_product=inner_product, chunk_valid=chunk_valid,
                               chunk_rows=chunk_rows)
