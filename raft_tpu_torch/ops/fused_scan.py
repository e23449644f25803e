"""Fused distance + exact select-k kernels (counterpart of raft_tpu/ops/fused_scan.py).

Four wrappers, each over a hand-written CUDA kernel for Hopper
(`csrc/fused_topk.cu`, `csrc/fused_list_topk.cu`,
`csrc/fused_list_topk_int8.cu`, `csrc/fused_bitplane_topk.cu`) with a
plain PyTorch version of the same function beside it:

  `fused_topk`           flat scan: every query against every dataset row,
                         with a running exact top-k per query; only the
                         (m, kbuf) result (and, on the card, a small
                         (m, n_ranges, k) workspace of per-range lists)
                         reaches device memory. `flat_plan` is its
                         launch plan, `fused_topk_ranges_plain` the plain
                         twin of its range split and merge.
  `fused_list_topk`      list scan: each chunk of query rows against the
                         one list `lof[chunk]` of a slot-table store, an
                         exact top-k of the (chunk, L) scores per row. On
                         the card (with `fused_list_topk_int8`,
                         `csrc/list_scan_tc.cuh`) the dots run on the
                         tensor cores and a block scans its list only up
                         to its last slot whose base is not +inf.
  `fused_list_topk_int8` the list scan on int8 query rows x an int8
                         store: int32 dots, then the per-row scale
                         (`int8_scores`, which `ops.pq_list_scan`'s int8
                         rows share, so the two int8 engines score the same
                         f32 values).
  `fused_bitplane_topk`  the RaBitQ list scan: AND+popcount of the query
                         rows' bit planes against a list's packed sign
                         codes, the unbiased estimator in-kernel
                         (`bitplane_scores`), an exact top-k per row.

Contracts (the JAX package's):
  - output (rows, kbuf) best-first, kbuf = fused_kbuf(k); slots past k,
    and slots with no candidate left, hold (+inf, _ID_SENTINEL);
  - L2 scores are `base - 2<q,v>`, inner-product scores `base - <q,v>`;
    `base` is +inf on masked or padded slots;
  - operands are rounded to bf16 (round to nearest even) and the dots
    accumulate in f32; the int8 kernel's dots are exact int32 sums, and
    its score rounds as the reference's does on the CPU (`int8_scores`);
  - ties go to the smaller slot / row id: the result is the k
    lexicographically smallest (score, id) pairs;
  - chunks with `chunk_valid == 0` write (+inf, sentinel) and do no work;
    so do the rows at or past `chunk_rows[i]` of chunk i, where the
    caller gives that count (the port's addition: a chunk's live rows are
    a prefix, and most rows of a sparsely probed list's chunk are pad).

A wrapper takes its plain version only for tensors on the CPU. For a
CUDA tensor it launches the kernel or raises. Either way its values pass
the `fused.scan.scores` fault hook (core/faults) before they return.
Each wrapper adds one to its kernel's entry of `launch_counts()` where
it launches the kernel, and nowhere else; `launch_counts()` and
`reset_launch_counts()` (from `ops._launch`) cover every kernel of the
port.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import ctypes
import math

import numpy as np
import torch

from raft_tpu_torch.core.config import strict_f32_matmul
from raft_tpu_torch.ops._launch import (  # noqa: F401  (the counters are re-exported)
    _I,
    _P,
    _check,
    _count_launch,
    _kernel_fn,
    _launches,
    _raise_on,
    _tensor_arg,
    launch_counts,
    reset_launch_counts,
)

_LANES = 128
#: hard cap on k for every fused engine (the JAX package's cap)
FUSED_MAX_K = 256
_ID_SENTINEL = 2**31 - 1
#: injection site: corrupt_in_trace on each wrapper's candidate values
FUSED_SCORES_SITE = "fused.scan.scores"

# kernel geometry: must match csrc/fused_common.cuh
_TILE_SLOTS = 128      # store rows staged per tile
_D_STRIDE = 36         # floats per staged row (32-wide depth step + 4 pad)
_D_STEP = 32
_ROWS = 16             # query rows per block
#: shared memory one Hopper block may use (227 KB)
SMEM_LIMIT = 232448

# the flat kernel's tensor-core variant: must match csrc/fused_topk.cu
_TC_TILE = 128         # dataset rows per staged tile (kBN)
_TC_MAX_RANGES = 128   # kMaxRanges: lists a row's merge takes
_TC_STAGES = 3        # dataset tiles in shared memory (kStages)
_TC_QUEUE = 128       # a warp's queue of flagged pairs (kQueue)


def _maybe_corrupt(vals, idx):
    """The chaos hook on a wrapper's candidate values (site
    `FUSED_SCORES_SITE`), on the kernel and the plain path alike, before
    any caller merges them: `vals` itself without an installed plan."""
    from raft_tpu_torch.core.faults import corrupt_in_trace

    return corrupt_in_trace(FUSED_SCORES_SITE, vals, 0), idx


def fused_kbuf(k: int) -> int:
    """Candidate-buffer width for a requested k: the 128-multiple that holds it."""
    if not 0 < k <= FUSED_MAX_K:
        raise ValueError(f"fused select-k caps k at {FUSED_MAX_K}; k={k}")
    return max(_LANES, -(-int(k) // _LANES) * _LANES)


def _dots_smem_bytes(d: int) -> int:
    """Shared memory of the CUDA-core scoring policy's staging
    (Bf16Dots::smem_bytes in csrc/fused_common.cuh): the store tile and the
    block's query rows."""
    d_pad = -(-d // _D_STEP) * _D_STEP
    return 4 * (_TILE_SLOTS * _D_STRIDE + _ROWS * d_pad)


def _topk_smem_bytes(d: int) -> int:
    """Shared memory of one block of the flat kernel's CUDA-core variant
    (topk_smem_bytes<Bf16Dots> in csrc/fused_common.cuh): the tile's
    scores, then the staging. The running top-k lists live in registers."""
    return 4 * _ROWS * _TILE_SLOTS + _dots_smem_bytes(d)


def fits_fused(m: int, n: int, d: int, k: int) -> bool:
    """Shared-memory budget of one `fused_topk` block. Any row count
    streams through."""
    if not (0 < k <= FUSED_MAX_K and m >= 1 and n >= 1 and d >= 1):
        return False
    return _topk_smem_bytes(d) <= SMEM_LIMIT


#: the list kernels' and the bit-plane kernel's selection: register lists
#: up to this k, shared-memory lists past it (kMaxRegisterK in
#: csrc/block_topk.cuh)
MAX_REGISTER_K = 32
_SC_STRIDE = _TILE_SLOTS + 4   # floats a row of the list kernels' score tile


def _list_cap(k: int) -> int:
    """Pairs a row's shared-memory list holds at this k (list_cap in
    csrc/block_topk.cuh): 0 for register lists (k <= 32), else the
    smallest of 64, 128 and 256 that holds k."""
    if k <= MAX_REGISTER_K:
        return 0
    return 64 if k <= 64 else 128 if k <= 128 else FUSED_MAX_K


def _lists_bytes(k: int) -> int:
    """Shared memory of a block's 16 rows' lists and 128-pair buffers at
    this k (block_lists_bytes in csrc/block_topk.cuh); none for register
    lists."""
    cap = _list_cap(k)
    return 0 if cap == 0 else 8 * _ROWS * (cap + _TILE_SLOTS)


def _list_tc_stages(rot: int, q_int8: bool) -> int:
    """Store tiles in a list kernel's shared memory: a ring of two that
    TMA fills for int8 rows of whole 16-byte rows, else the one that the
    block's threads fill (csrc/fused_list_topk*.cu)."""
    return 2 if q_int8 and rot % 16 == 0 else 1


def _list_tc_smem_bytes(rot: int, q_int8: bool, k: int) -> int:
    """Shared memory of one `fused_list_topk` block, or one
    `fused_list_topk_int8` block with `q_int8` (list_tc_smem_bytes in
    csrc/list_scan_tc.cuh): 1024 bytes of alignment slack, the store
    stages (128 slots x 128-byte chunks of bf16 or int8 columns), the 16
    query rows in the same chunks, the score tile (16 x 132 floats), the
    rows' scales and the stages' barriers, then, 16-byte aligned, the
    rows' shared lists at this k."""
    units = -(-rot // (16 if q_int8 else 8))    # 16-byte units a row
    chunks = -(-units // 8)                     # 128-byte chunks a row
    stages = _list_tc_stages(rot, q_int8)
    b = ((stages * _TILE_SLOTS + _ROWS) * chunks * 128 + 4 * _ROWS * (_SC_STRIDE + 1)
         + 8 * stages)
    return 1024 + -(-b // 16) * 16 + _lists_bytes(k)


def fits_fused_list(L: int, rot: int, k: int, kbuf: Optional[int] = None,
                    q_int8: bool = False) -> bool:
    """Shared-memory budget of one `fused_list_topk` block, or of one
    `fused_list_topk_int8` block with `q_int8` (the list streams through
    in tiles, so any length L that is a multiple of 128 fits). `kbuf` (the
    width the kernel will run with) must hold k."""
    if not (0 < k <= FUSED_MAX_K):
        return False
    if kbuf is not None and int(kbuf) < fused_kbuf(k):
        return False
    return L % _LANES == 0 and _list_tc_smem_bytes(rot, q_int8, int(k)) <= SMEM_LIMIT


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round to bf16 (nearest even) and hold as f32."""
    return t.to(torch.bfloat16).float()


def _lex_key(scores: torch.Tensor, ids: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A unique int64 key per element whose order is the lexicographic
    (score, column) order: the f32 bits mapped to an order-preserving
    int32 in the high word, the column (or `ids`, non-negative int32
    values, where given) in the low word. -0.0 is folded onto +0.0 first,
    since the two compare equal."""
    s = (scores.float() + 0.0).contiguous()
    b = s.view(torch.int32).to(torch.int64)
    b = torch.where(b < 0, b ^ 0x7FFFFFFF, b)
    col = (torch.arange(s.shape[-1], dtype=torch.int64, device=s.device) if ids is None
           else ids.to(torch.int64))
    return b * (1 << 32) + col


def _lex_topk(scores: torch.Tensor, k: int, kbuf: int):
    """(rows..., kbuf) lexicographic (score, column) minima, best-first,
    padded with (+inf, sentinel). The key is unique per element, so the
    k smallest keys are exactly the JAX epilogue's k extraction passes
    whatever tie order `torch.topk` would give equal scores."""
    kk = min(k, scores.shape[-1])
    _, i = torch.topk(_lex_key(scores), kk, dim=-1, largest=False, sorted=True)
    ov = torch.full((*scores.shape[:-1], kbuf), float("inf"), device=scores.device)
    oi = torch.full((*scores.shape[:-1], kbuf), _ID_SENTINEL, dtype=torch.int32,
                    device=scores.device)
    ov[..., :kk] = torch.gather(scores, -1, i)
    oi[..., :kk] = i.to(torch.int32)
    return ov, oi


# ---------------------------------------------------------------------------
# flat scan: fused_topk
# ---------------------------------------------------------------------------


def fused_topk_plain(xb, yb, base, k: int, kbuf: int, inner_product: bool,
                     block_elems: int = 1 << 27, valid=None):
    """Plain PyTorch version of the flat kernel: `xb`/`yb` already
    bf16-rounded (any float dtype), `base` (n,) f32; `valid` (n,) bool or
    None folds into `base` as +inf, as `fused_topk` does. Row blocks bound
    the materialized score strip."""
    strict_f32_matmul()
    if valid is not None:
        base = torch.where(valid, base, float("inf"))
    coef = 1.0 if inner_product else 2.0
    m, n = xb.shape[0], yb.shape[0]
    yf = yb.float()
    outs_v, outs_i = [], []
    rb = max(1, block_elems // max(1, n))
    for s in range(0, m, rb):
        scores = base[None, :] - coef * (xb[s:s + rb].float() @ yf.T)
        v, i = _lex_topk(scores, k, kbuf)
        outs_v.append(v)
        outs_i.append(i)
    return torch.cat(outs_v), torch.cat(outs_i)


class FlatPlan(NamedTuple):
    """How `fused_topk` runs on the card. `variant` "wgmma": the
    tensor-core kernel, `rows` query rows a block (two warpgroups, or one
    where the rows' k-deep heaps need the room), the dataset cut into
    `n_ranges` ranges of `range_len` rows, each (row, range) writing its
    k best to a `workspace` of that shape before the merge; rows padded
    to `dp` columns (a multiple of 8). "simt": query rows too wide, or k
    too deep, for that kernel's shared memory take the CUDA-core kernel
    (one range, no workspace)."""
    variant: str
    rows: int
    n_ranges: int
    range_len: int
    workspace: Optional[tuple]
    dp: int


def _tc_smem_bytes(dp: int, k: int, rows: int) -> int:
    """Shared memory of one tensor-core block (tc_smem_bytes in
    csrc/fused_topk.cu): 1024 bytes of alignment slack, the query rows and
    the dataset stages (chunks of 64 bf16 columns, 128 bytes a row), the
    stages' base values, and each row's heap of k (score, id) pairs."""
    nk16 = -(-dp // 16)
    nkc = -(-nk16 // 4)
    st = _TC_STAGES
    return (1024 + nkc * 128 * (rows + st * _TC_TILE) + st * _TC_TILE * 4 + st * 16
            + rows * k * 8 + rows // 16 * _TC_QUEUE * 8)


def flat_plan(m: int, n: int, d: int, k: int, num_sms: int) -> FlatPlan:
    """The launch plan of `fused_topk` on a card with `num_sms` SMs: the
    first tensor-core variant whose shared memory fits (128 query rows a
    block, then 64; with d 96 the first holds k <= 88, the second k <=
    216), else the CUDA-core kernel. The dataset is split into as
    many ranges as leave every SM a block (query blocks x ranges <=
    num_sms, at least one tile a range, at most 128 ranges)."""
    dp = -(-int(d) // 8) * 8
    for rows in (128, 64):
        if _tc_smem_bytes(dp, k, rows) <= SMEM_LIMIT:
            break
    else:
        return FlatPlan("simt", _ROWS, 1, -(-n // _TC_TILE) * _TC_TILE, None, d)
    q_blocks = max(1, -(-int(m) // rows))
    tiles = max(1, -(-int(n) // _TC_TILE))
    n_ranges = max(1, min(tiles, _TC_MAX_RANGES, int(num_sms) // q_blocks))
    range_len = -(-tiles // n_ranges) * _TC_TILE
    n_ranges = max(1, -(-int(n) // range_len))
    return FlatPlan("wgmma", rows, n_ranges, range_len, (int(m), n_ranges, int(k)), dp)


def merge_ranges_plain(ws_v: torch.Tensor, ws_i: torch.Tensor, k: int, kbuf: int):
    """Plain version of the flat kernel's merge: the k lexicographically
    smallest (score, id) pairs of each row's (n_ranges, k) lists, best
    first, padded to kbuf with (+inf, sentinel)."""
    m = ws_v.shape[0]
    v, i = ws_v.reshape(m, -1).float(), ws_i.reshape(m, -1)
    _, o = torch.topk(_lex_key(v, i), k, dim=1, largest=False, sorted=True)
    ov = torch.full((m, kbuf), float("inf"), device=v.device)
    oi = torch.full((m, kbuf), _ID_SENTINEL, dtype=torch.int32, device=v.device)
    ov[:, :k] = torch.gather(v, 1, o)
    oi[:, :k] = torch.gather(i, 1, o).to(torch.int32)
    return ov, oi


def fused_topk_ranges_plain(xb, yb, base, k: int, kbuf: int, inner_product: bool,
                            n_ranges: int, range_len: int):
    """The flat kernel's range split in plain PyTorch: `fused_topk_plain`
    over each range of `range_len` dataset rows (ids offset to the whole
    dataset, (+inf, sentinel) where a range has fewer than k rows), then
    `merge_ranges_plain`. Equal to `fused_topk_plain` whatever the split."""
    m, n = xb.shape[0], yb.shape[0]
    ws_v = torch.full((m, n_ranges, k), float("inf"), device=xb.device)
    ws_i = torch.full((m, n_ranges, k), _ID_SENTINEL, dtype=torch.int32, device=xb.device)
    for r in range(n_ranges):
        a, b = r * range_len, min(n, (r + 1) * range_len)
        if a >= b:
            continue
        v, i = fused_topk_plain(xb, yb[a:b], base[a:b], k, k, inner_product)
        ws_v[:, r] = v
        ws_i[:, r] = torch.where(i == _ID_SENTINEL, i, i + a)
    return merge_ranges_plain(ws_v, ws_i, k, kbuf)


def fused_topk(x: torch.Tensor, y: torch.Tensor, k: int, *,
               inner_product: bool = False, valid: Optional[torch.Tensor] = None):
    """Exact fused scan+select over the full (m, n) pair space.

    `x` (m, d) and `y` (n, d) are contiguous float32 on one device.
    Returns ((m, kbuf) scores, (m, kbuf) int32 row ids), best-first. L2
    scores are |y|^2 - 2<x,y> over the bf16-rounded rows (add |x|^2 at the
    call site); inner-product scores are -<x,y>. `valid` (n,) bool or
    None: False rows are excluded, folded into the base row as +inf, so
    the kernel needs no mask operand; slots past the survivors hold +inf."""
    _check(isinstance(x, torch.Tensor), "x must be a tensor")
    dev = x.device
    _tensor_arg("x", x, (torch.float32,), 2, dev)
    _tensor_arg("y", y, (torch.float32,), 2, dev)
    _check(x.shape[1] == y.shape[1], f"x has {x.shape[1]} columns, y has {y.shape[1]}")
    m, d = x.shape
    n = y.shape[0]
    kbuf = fused_kbuf(k)
    yb = y.to(torch.bfloat16)  # a fresh allocation: aligned for the kernel's 4-wide loads
    if inner_product:
        base = torch.zeros((n,), dtype=torch.float32, device=dev)
    else:
        yf = yb.float()
        base = torch.sum(yf * yf, dim=1)
    if valid is not None:
        _tensor_arg("valid", valid, (torch.bool,), 1, dev)
        _check(valid.shape[0] == n, f"valid has {valid.shape[0]} entries for {n} rows")
        base = torch.where(valid, base, float("inf"))
    if dev.type == "cpu":
        return _maybe_corrupt(*fused_topk_plain(_bf16(x), yb, base, int(k), kbuf,
                                                bool(inner_product)))
    _check(dev.type == "cuda", f"fused_topk runs on cpu or cuda, got {dev}")
    _check(fits_fused(m, n, d, int(k)),
           f"fused_topk: d={d}, k={k} exceed the kernel's shared-memory budget")
    vals = torch.empty((m, kbuf), dtype=torch.float32, device=dev)
    idx = torch.empty((m, kbuf), dtype=torch.int32, device=dev)
    plan = flat_plan(m, n, d, int(k), torch.cuda.get_device_properties(dev).multi_processor_count)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if plan.variant == "simt":
            fn = _kernel_fn("fused_topk.cu", "fused_topk_launch",
                            [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P])
            err = fn(x.data_ptr(), yb.data_ptr(), base.data_ptr(), vals.data_ptr(),
                     idx.data_ptr(), m, n, d, int(k), kbuf, int(bool(inner_product)),
                     stream)
        else:
            if plan.dp != d:  # zero columns up to the kernel's 16-byte loads
                yb = torch.nn.functional.pad(yb, (0, plan.dp - d))
            ws_v = torch.empty(plan.workspace, dtype=torch.float32, device=dev)
            ws_i = torch.empty(plan.workspace, dtype=torch.int32, device=dev)
            bound = torch.full((m,), -1, dtype=torch.int32, device=dev)  # every bit set
            fn = _kernel_fn("fused_topk.cu", "fused_topk_tc_launch",
                            [_P] * 8 + [_I] * 10 + [_P])
            err = fn(x.data_ptr(), yb.data_ptr(), base.data_ptr(), ws_v.data_ptr(),
                     ws_i.data_ptr(), bound.data_ptr(), vals.data_ptr(), idx.data_ptr(), m,
                     n, d, plan.dp,
                     int(k), kbuf, int(bool(inner_product)), plan.rows, plan.n_ranges,
                     plan.range_len, stream)
    _raise_on(err, "fused_topk")
    _count_launch("fused_topk")
    return _maybe_corrupt(vals, idx)


# ---------------------------------------------------------------------------
# list scan: fused_list_topk
# ---------------------------------------------------------------------------

_STORE_KINDS = {torch.int8: 0, torch.bfloat16: 1, torch.float32: 2}


def _live_rows(chunk_valid, chunk_rows, chunk: int):
    """(ncb,) int32 count of each chunk's live leading rows, or None when
    every row is live."""
    live = chunk_rows
    if chunk_valid is not None:
        full = torch.where(chunk_valid != 0, chunk, 0).to(torch.int32)
        live = full if live is None else torch.minimum(live, full)
    return live


def _mask_dead_rows(vals, idx, live, fill_id: int):
    """(+inf, fill_id) over the rows of each chunk at or past its live
    count; `live` None leaves every row."""
    if live is None:
        return vals, idx
    chunk = vals.shape[1]
    dead = (torch.arange(chunk, device=live.device)[None, :] >= live[:, None])[..., None]
    return torch.where(dead, float("inf"), vals), torch.where(dead, fill_id, idx)


def _check_list_store_alignment(store, rot: int, int8_rows: bool = False) -> None:
    """The list kernels' staging (csrc/list_scan_tc.cuh) loads the store
    eight elements a load when rot % 8 == 0 (RegStage: `fused_list_topk`,
    and `pq_list_scan` on f32 rows), and int8 rows of rot % 16 == 0 by TMA
    (TmaStage: `fused_list_topk_int8`, and `pq_list_scan` on int8 rows);
    each needs every row, and so the store itself, aligned to that width
    (16 bytes at most); a view at an odd offset would fault on the card."""
    if int8_rows:
        width = 16 if rot % 16 == 0 else 1
    else:
        width = min(16, 8 * store.element_size()) if rot % 8 == 0 else 1
    _check(store.data_ptr() % width == 0,
           f"store must start on a {width}-byte boundary (a view at an odd offset; "
           "pass store.clone())")


def fused_list_topk_plain(lof, qres, store, base, k: int, kbuf: int,
                          inner_product: bool, chunk_valid=None, chunk_rows=None,
                          block_elems: int = 1 << 26):
    """Plain PyTorch version of the list kernel (same operands as
    `fused_list_topk`). Chunk blocks bound the gathered store copy."""
    strict_f32_matmul()
    coef = 1.0 if inner_product else 2.0
    ncb, chunk, rot = qres.shape
    L = store.shape[1]
    qb = _bf16(qres)
    outs_v, outs_i = [], []
    cb = max(1, block_elems // max(1, L * rot))
    for s in range(0, ncb, cb):
        lids = lof[s:s + cb].long()
        st = store[lids].to(torch.bfloat16).float()  # (b, L, rot)
        scores = base[lids] - coef * torch.bmm(qb[s:s + cb], st.transpose(1, 2))
        v, i = _lex_topk(scores, k, kbuf)
        outs_v.append(v)
        outs_i.append(i)
    return _mask_dead_rows(torch.cat(outs_v), torch.cat(outs_i),
                           _live_rows(chunk_valid, chunk_rows, chunk), _ID_SENTINEL)


def fused_list_topk(lof, qres, store, base, k: int, *, kbuf: Optional[int] = None,
                    inner_product: bool = False, chunk_valid=None, chunk_rows=None):
    """Exact fused scan+select of each chunk's list.

    lof (ncb,) int32 chunk -> list id; qres (ncb, chunk, rot) f32 query
    rows; store (n_lists, L, rot) int8/bf16/f32 slot table; base
    (n_lists, 1, L) f32, +inf invalid; chunk_valid (ncb,) int32 or None
    (0 = skip the chunk); chunk_rows (ncb,) int32 or None (the count of
    each chunk's live leading rows; the rest are skipped). Returns
    ((ncb, chunk, kbuf) scores, (ncb, chunk, kbuf) int32 in-list slots),
    best-first per row; skipped rows hold (+inf, sentinel)."""
    _check(isinstance(qres, torch.Tensor), "qres must be a tensor")
    dev = qres.device
    _tensor_arg("lof", lof, (torch.int32,), 1, dev)
    _tensor_arg("qres", qres, (torch.float32,), 3, dev)
    _tensor_arg("store", store, tuple(_STORE_KINDS), 3, dev)
    _tensor_arg("base", base, (torch.float32,), 3, dev)
    ncb, chunk, rot = qres.shape
    n_lists, L, srot = store.shape
    _check(srot == rot, f"store rows have {srot} columns, qres {rot}")
    _check(lof.shape[0] == ncb, f"lof has {lof.shape[0]} entries for {ncb} chunks")
    _check(tuple(base.shape) == (n_lists, 1, L),
           f"base must be {(n_lists, 1, L)}, got {tuple(base.shape)}")
    _check(L % _LANES == 0, f"list length {L} must be a multiple of {_LANES}")
    _check_list_store_alignment(store, rot)
    if chunk_valid is not None:
        _tensor_arg("chunk_valid", chunk_valid, (torch.int32,), 1, dev)
        _check(chunk_valid.shape[0] == ncb, "chunk_valid must have one entry per chunk")
    if chunk_rows is not None:
        _tensor_arg("chunk_rows", chunk_rows, (torch.int32,), 1, dev)
        _check(chunk_rows.shape[0] == ncb, "chunk_rows must have one entry per chunk")
    kb = fused_kbuf(k) if kbuf is None else int(kbuf)
    _check(kb >= fused_kbuf(k), f"candidate buffer width {kb} cannot hold k={k}")
    if dev.type == "cpu":
        return _maybe_corrupt(*fused_list_topk_plain(lof, qres, store, base, int(k), kb,
                                                     bool(inner_product), chunk_valid,
                                                     chunk_rows))
    _check(dev.type == "cuda", f"fused_list_topk runs on cpu or cuda, got {dev}")
    _check(fits_fused_list(L, rot, int(k), kb),
           f"fused_list_topk: L={L}, rot={rot} exceed the kernel's shared-memory budget")
    vals = torch.empty((ncb, chunk, kb), dtype=torch.float32, device=dev)
    idx = torch.empty((ncb, chunk, kb), dtype=torch.int32, device=dev)
    fn = _kernel_fn("fused_list_topk.cu", "fused_list_topk_launch",
                    [_P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])
    live = _live_rows(chunk_valid, chunk_rows, chunk)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(lof.data_ptr(), qres.data_ptr(), store.data_ptr(),
                 _STORE_KINDS[store.dtype], base.data_ptr(),
                 None if live is None else live.data_ptr(), vals.data_ptr(),
                 idx.data_ptr(), ncb, chunk, rot, L, int(k), kb,
                 int(bool(inner_product)), stream)
    _raise_on(err, "fused_list_topk")
    _count_launch("fused_list_topk")
    return _maybe_corrupt(vals, idx)


# ---------------------------------------------------------------------------
# int8 list scan: fused_list_topk_int8
# ---------------------------------------------------------------------------


def _fma_f32(a, b, c):
    """f32 `a * b + c` rounded once, as a fused multiply-add rounds it,
    where the product a * b is exact in float64 (here an integer below
    2^24 times an f32). The f64 sum is rounded to odd (its error, exact by
    TwoSum, sets the last bit) before the cast to f32, so the two
    roundings give the correctly rounded f32 result."""
    p = a.double() * b.double()
    c = c.double()
    s = c + p
    pv = s - c
    err = (c - (s - pv)) + (p - pv)
    bits = s.view(torch.int64)
    to_odd = (err != 0) & torch.isfinite(s) & ((bits & 1) == 0)
    # away from zero where the exact sum lies beyond s, else towards it
    step = torch.where((err > 0) == (s > 0), 1, -1)
    return torch.where(to_odd, bits + step, bits).view(torch.float64).float()


def int8_scores(idot, rs, base, inner_product: bool):
    """Scores from exact integer dots (any dtype holding them exactly),
    rounded as the JAX kernels round them on the CPU
    (raft_tpu/ops/fused_scan.py:484-485, raft_tpu/ops/pq_list_scan.py:
    184-200): L2 `base - 2 * (f32(idot) * rs)`, two roundings; inner
    product `base - f32(idot) * rs` as one fused multiply-add. The CUDA
    kernels compute the same (csrc/fused_common.cuh: int8_score)."""
    f = idot.float()  # |idot| < 2^24: exact
    if inner_product:
        return _fma_f32(-f, rs, base)
    return base - 2.0 * (f * rs)


def _int8_list_scores(q8, store_rows, base_rows, rs, inner_product: bool):
    """(b, chunk, L) int8 scores of chunk rows q8 (b, chunk, rot) against
    their lists' rows (b, L, rot). The integer dots are exact in float64."""
    idot = torch.bmm(q8.double(), store_rows.double().transpose(1, 2))
    return int8_scores(idot, rs, base_rows, inner_product)


def fused_list_topk_int8_plain(lof, q8, store, base, q_scale, k: int, kbuf: int,
                               inner_product: bool, chunk_valid=None, chunk_rows=None,
                               block_elems: int = 1 << 25):
    """Plain PyTorch version of the int8 list kernel (same operands as
    `fused_list_topk_int8`). Chunk blocks bound the gathered store copy."""
    ncb, chunk, rot = q8.shape
    L = store.shape[1]
    outs_v, outs_i = [], []
    cb = max(1, block_elems // max(1, L * rot))
    for s in range(0, ncb, cb):
        lids = lof[s:s + cb].long()
        scores = _int8_list_scores(q8[s:s + cb], store[lids], base[lids], q_scale[s:s + cb],
                                   inner_product)
        v, i = _lex_topk(scores, k, kbuf)
        outs_v.append(v)
        outs_i.append(i)
    return _mask_dead_rows(torch.cat(outs_v), torch.cat(outs_i),
                           _live_rows(chunk_valid, chunk_rows, chunk), _ID_SENTINEL)


def fused_list_topk_int8(lof, q8, store, base, q_scale, k: int, *, kbuf: Optional[int] = None,
                         inner_product: bool = False, chunk_valid=None, chunk_rows=None):
    """Exact fused int8 scan+select of each chunk's list: the
    `fused_list_topk` contract (same outputs, same smaller-slot ties) with
    int8 x int8 -> int32 dots and the per-row f32 scale.

    lof (ncb,) int32; q8 (ncb, chunk, rot) int8 symmetric query rows;
    store (n_lists, L, rot) int8; base (n_lists, 1, L) f32, +inf invalid;
    q_scale (ncb, chunk, 1) f32 per-row scale; chunk_valid / chunk_rows as
    for `fused_list_topk`. Returns ((ncb, chunk, kbuf) scores,
    (ncb, chunk, kbuf) int32 in-list slots), best-first per row."""
    _check(isinstance(q8, torch.Tensor), "q8 must be a tensor")
    dev = q8.device
    _check(q8.dtype == torch.int8 and getattr(store, "dtype", None) == torch.int8,
           f"fused_list_topk_int8 requires int8 queries and store, got "
           f"{q8.dtype}/{getattr(store, 'dtype', None)}")
    _tensor_arg("lof", lof, (torch.int32,), 1, dev)
    _tensor_arg("q8", q8, (torch.int8,), 3, dev)
    _tensor_arg("store", store, (torch.int8,), 3, dev)
    _tensor_arg("base", base, (torch.float32,), 3, dev)
    _tensor_arg("q_scale", q_scale, (torch.float32,), 3, dev)
    ncb, chunk, rot = q8.shape
    n_lists, L, srot = store.shape
    _check(srot == rot, f"store rows have {srot} columns, q8 {rot}")
    _check(lof.shape[0] == ncb, f"lof has {lof.shape[0]} entries for {ncb} chunks")
    _check(tuple(base.shape) == (n_lists, 1, L),
           f"base must be {(n_lists, 1, L)}, got {tuple(base.shape)}")
    _check(tuple(q_scale.shape) == (ncb, chunk, 1),
           f"q_scale must be {(ncb, chunk, 1)}, got {tuple(q_scale.shape)}")
    _check(L % _LANES == 0, f"list length {L} must be a multiple of {_LANES}")
    _check_list_store_alignment(store, rot, int8_rows=True)
    if chunk_valid is not None:
        _tensor_arg("chunk_valid", chunk_valid, (torch.int32,), 1, dev)
        _check(chunk_valid.shape[0] == ncb, "chunk_valid must have one entry per chunk")
    if chunk_rows is not None:
        _tensor_arg("chunk_rows", chunk_rows, (torch.int32,), 1, dev)
        _check(chunk_rows.shape[0] == ncb, "chunk_rows must have one entry per chunk")
    kb = fused_kbuf(k) if kbuf is None else int(kbuf)
    _check(kb >= fused_kbuf(k), f"candidate buffer width {kb} cannot hold k={k}")
    if dev.type == "cpu":
        return _maybe_corrupt(*fused_list_topk_int8_plain(lof, q8, store, base, q_scale,
                                                          int(k), kb, bool(inner_product),
                                                          chunk_valid, chunk_rows))
    _check(dev.type == "cuda", f"fused_list_topk_int8 runs on cpu or cuda, got {dev}")
    _check(fits_fused_list(L, rot, int(k), kb, q_int8=True),
           f"fused_list_topk_int8: L={L}, rot={rot} exceed the kernel's shared-memory budget")
    vals = torch.empty((ncb, chunk, kb), dtype=torch.float32, device=dev)
    idx = torch.empty((ncb, chunk, kb), dtype=torch.int32, device=dev)
    fn = _kernel_fn("fused_list_topk_int8.cu", "fused_list_topk_int8_launch",
                    [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P])
    live = _live_rows(chunk_valid, chunk_rows, chunk)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(lof.data_ptr(), q8.data_ptr(), store.data_ptr(), base.data_ptr(),
                 q_scale.data_ptr(), None if live is None else live.data_ptr(),
                 vals.data_ptr(), idx.data_ptr(), ncb, chunk, rot, L, n_lists, int(k), kb,
                 int(bool(inner_product)), stream)
    _raise_on(err, "fused_list_topk_int8")
    _count_launch("fused_list_topk_int8")
    return _maybe_corrupt(vals, idx)


# ---------------------------------------------------------------------------
# bit-plane list scan: fused_bitplane_topk (RaBitQ)
# ---------------------------------------------------------------------------

#: query quantization depth cap: the kernel's plane loop runs over at most
#: this many planes (the JAX package's cap)
BITPLANE_MAX_BITS = 8


def _as_uint_values(words: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 values in [0, 2^32) (the uint32 reading)."""
    return words.to(torch.int64) & 0xFFFFFFFF


def popcount32(words: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word of an int32 tensor, as int32: torch has
    no popcount, so the SWAR count runs on int64."""
    v = _as_uint_values(words)
    v = v - ((v >> 1) & 0x55555555)
    v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
    v = (v + (v >> 4)) & 0x0F0F0F0F
    return (((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)


def rsqrt_dim(rot_dim: int) -> float:
    """The f32 reciprocal of f32(sqrt(rot_dim)): XLA compiles the
    estimator's division by the constant sqrt(D) to a multiply by it."""
    return float(np.float32(1.0) / np.float32(math.sqrt(float(rot_dim))))


def bitplane_scores(s_u, pop, rn, o_dot, lo, delta, qsum, qconst, rot_dim: int,
                    inner_product: bool) -> torch.Tensor:
    """Minimizing RaBitQ estimator scores from the integer bit-plane sums
    `s_u` (as f32; the operands broadcast), rounded as the JAX bit-plane
    kernel rounds them on the CPU (raft_tpu/ops/fused_scan.py:660-666,
    where XLA contracts the mul+add pairs and turns the division by the
    constant sqrt(D) into a multiply):
      s   = fma(lo, pop, delta * s_u)
      est = ((2 s - qsum) * rsqrt_dim(D)) / max(o_dot, 1e-12)
      L2  = fma(-(2 rn), est, fma(rn, rn, qconst))
      IP  = -fma(rn, est, qconst)   (the negated similarity)
    csrc/fused_bitplane_topk.cu computes the same with explicit
    intrinsics, so kernel and plain version agree bit for bit."""
    s = _fma_f32(lo, pop, delta * s_u)
    est = ((2.0 * s - qsum) * rsqrt_dim(rot_dim)) / torch.clamp(o_dot, min=1e-12)
    if inner_product:
        return -_fma_f32(rn, est, qconst)
    return _fma_f32(-(2.0 * rn), est, _fma_f32(rn, rn, qconst))


def _bitplane_kb_words(k: int) -> int:
    """Code words a K-block of the bit-plane kernel's scan at this k
    (bp_kb_words in csrc/fused_bitplane_topk.cu): 4 (128-byte rows of
    expanded bits a slot), or 2 (64-byte rows) with the 256-pair lists,
    where 4 would leave room for only two blocks an SM."""
    return 2 if _list_cap(k) == FUSED_MAX_K else 4


def _bitplane_smem_bytes(words: int, k: int = 1, resident: Optional[bool] = None) -> int:
    """Shared memory of one bit-plane block at this k (KBlock::smem_bytes
    in csrc/fused_bitplane_topk.cu): 1024 bytes of alignment slack, one
    K-block of the tile's expanded codes (128 slots x 32 bytes a word of
    the K-block), the query levels (16 rows x the same bytes a K-block:
    every K-block where `resident`, else one slice a warpgroup), the
    score tile (16 x 132 floats, whose pads hold the rows' qmeta), then,
    16-byte aligned, the rows' lists and buffers at this k
    (block_lists_bytes in csrc/block_topk.cuh). `resident` None: the
    launcher's own choice, resident where that fits SMEM_LIMIT
    (`bitplane_resident`)."""
    if resident is None:
        resident = bitplane_resident(words, k)
    kbw = _bitplane_kb_words(k)
    kblocks = -(-int(words) // kbw)
    b = (_TILE_SLOTS * 32 * kbw + _ROWS * 32 * kbw * (kblocks if resident else 2)
         + 4 * _ROWS * _SC_STRIDE)
    return 1024 + -(-b // 16) * 16 + _lists_bytes(k)


def bitplane_resident(words: int, k: int) -> bool:
    """Whether the bit-plane kernel holds every K-block of its query
    levels in shared memory at this width and k (built once a block), or
    streams them (each warpgroup rebuilds a K-block's slice beside its
    codes): chosen by shape alone, as the launcher chooses."""
    return _bitplane_smem_bytes(words, k, resident=True) <= SMEM_LIMIT


def fits_fused_bitplane(L: int, words: int, bits: int, k: int,
                        kbuf: Optional[int] = None) -> bool:
    """Whether one `fused_bitplane_topk` launch takes this geometry: k <=
    256, 1 <= bits <= BITPLANE_MAX_BITS, L a multiple of 128, `kbuf` (the
    width the kernel will run with) holding k, and S_u = sum of the levels
    over 32 x words positions below 2^24, so its f32 is exact. The list
    streams through in tiles and the codes in K-blocks, so shared memory
    bounds no width (`_bitplane_smem_bytes` streamed)."""
    if not (0 < k <= FUSED_MAX_K and 1 <= bits <= BITPLANE_MAX_BITS and words >= 1):
        return False
    if kbuf is not None and int(kbuf) < fused_kbuf(k):
        return False
    if ((1 << int(bits)) - 1) * 32 * int(words) >= 1 << 24:
        return False
    return L % _LANES == 0 and _bitplane_smem_bytes(words, int(k), resident=False) <= SMEM_LIMIT


def bitplane_levels(planes: torch.Tensor, bits: int) -> torch.Tensor:
    """(..., 32 W) uint8 query levels of bit planes (..., bits * W) (int32
    words): u[32 w + b] = sum_j ((planes[..., j * W + w] >> b) & 1) << j.
    S_u is the integer dot product of these with `expand_code_bits`; the
    kernel builds the same levels in another byte order (both sides
    alike). For tests and yardsticks: the card path never calls it."""
    W = planes.shape[-1] // int(bits)
    shifts = torch.arange(32, dtype=torch.int32, device=planes.device)
    u = torch.zeros(planes.shape[:-1] + (W, 32), dtype=torch.int32, device=planes.device)
    for j in range(int(bits)):  # bit b of an int32 word is bit b of its uint32 reading
        u += ((planes[..., j * W:(j + 1) * W, None] >> shifts) & 1) << j
    return u.reshape(planes.shape[:-1] + (32 * W,)).to(torch.uint8)


def expand_code_bits(codes_t: torch.Tensor) -> torch.Tensor:
    """(..., 32 W, L) uint8 code bits (0 or 1) of word-transposed codes
    (..., W, L) (int32 words): row 32 w + b is bit b of word w. For tests
    and yardsticks: the card path never calls it."""
    shifts = torch.arange(32, dtype=torch.int32, device=codes_t.device)[:, None]
    bits = ((codes_t[..., None, :] >> shifts) & 1).to(torch.uint8)  # (..., W, 32, L)
    return bits.reshape(codes_t.shape[:-2] + (32 * codes_t.shape[-2], codes_t.shape[-1]))


def bitplane_su(planes, codes, bits: int) -> torch.Tensor:
    """(b, chunk, L) int32 integer scores S_u = sum_j 2^j sum_w
    popc(planes[:, c, j*W + w] & codes[:, w, s]) of chunk rows' planes
    (b, chunk, bits*W) against their lists' word-transposed codes
    (b, W, L). Integer sums: exact in any order."""
    W = codes.shape[1]
    acc = torch.zeros((planes.shape[0], planes.shape[1], codes.shape[2]), dtype=torch.int32,
                      device=planes.device)
    for j in range(bits):
        for w in range(W):
            inter = planes[:, :, j * W + w, None] & codes[:, None, w, :]
            acc += popcount32(inter) << j
    return acc


def fused_bitplane_topk_plain(lof, planes, codes_t, meta, base, qmeta, k: int, kbuf: int,
                              rot_dim: int, bits: int, inner_product: bool, chunk_valid=None,
                              chunk_rows=None, block_elems: int = 1 << 23):
    """Plain PyTorch version of the bit-plane kernel (same operands as
    `fused_bitplane_topk`). Chunk blocks bound the (rows, L) strips."""
    ncb, chunk, _ = planes.shape
    L = codes_t.shape[2]
    outs_v, outs_i = [], []
    cb = max(1, block_elems // max(1, chunk * L))
    for s in range(0, ncb, cb):
        lids = lof[s:s + cb].long()
        s_u = bitplane_su(planes[s:s + cb], codes_t[lids], bits).float()
        m, qm = meta[lids], qmeta[s:s + cb]
        scores = bitplane_scores(s_u, m[:, 0:1], m[:, 1:2], m[:, 2:3], qm[:, 0, :, None],
                                 qm[:, 1, :, None], qm[:, 2, :, None], qm[:, 3, :, None],
                                 rot_dim, inner_product) + base[lids]
        v, i = _lex_topk(scores, k, kbuf)
        outs_v.append(v)
        outs_i.append(i)
    return _mask_dead_rows(torch.cat(outs_v), torch.cat(outs_i),
                           _live_rows(chunk_valid, chunk_rows, chunk), _ID_SENTINEL)


def fused_bitplane_topk(lof, planes, codes_t, meta, base, qmeta, k: int, *, rot_dim: int,
                        bits: int, kbuf: Optional[int] = None, inner_product: bool = False,
                        chunk_valid=None, chunk_rows=None):
    """Exact fused RaBitQ bit-plane scan+select of each chunk's list.

    lof (ncb,) int32 chunk -> list id; planes (ncb, chunk, bits*W) int32
    query bit planes (uint32 bits); codes_t (n_lists, W, L) int32
    word-transposed sign codes; meta (n_lists, 3, L) f32 [popcount, |r|,
    <o, x_bar>]; base (n_lists, 1, L) f32, 0 or +inf; qmeta (ncb, 4, chunk)
    f32 [lo, delta, qsum, qconst]; chunk_valid / chunk_rows as for
    `fused_list_topk`. Returns ((ncb, chunk, kbuf) minimizing estimator
    scores, (ncb, chunk, kbuf) int32 in-list slots), best-first per row.
    L2 scores are the full estimated distance (qconst = |q - center|^2);
    inner-product scores are the negated estimated similarity (qconst =
    q . center): negate back at the call site. The kernel computes S_u
    as a u8 x u8 product on the tensor cores (the query levels against
    the code bits, `bitplane_levels` / `expand_code_bits`) and selects
    with register lists up to k = MAX_REGISTER_K and with shared-memory
    lists merged in batches past it; all of it is exact."""
    _check(isinstance(planes, torch.Tensor), "planes must be a tensor")
    dev = planes.device
    _tensor_arg("lof", lof, (torch.int32,), 1, dev)
    _tensor_arg("planes", planes, (torch.int32,), 3, dev)
    _tensor_arg("codes_t", codes_t, (torch.int32,), 3, dev)
    _tensor_arg("meta", meta, (torch.float32,), 3, dev)
    _tensor_arg("base", base, (torch.float32,), 3, dev)
    _tensor_arg("qmeta", qmeta, (torch.float32,), 3, dev)
    ncb, chunk, pw = planes.shape
    n_lists, W, L = codes_t.shape
    _check(1 <= int(bits) <= BITPLANE_MAX_BITS,
           f"bits must be in [1, {BITPLANE_MAX_BITS}], got {bits}")
    _check(pw == int(bits) * W, f"planes width {pw} != bits*words = {int(bits) * W}")
    _check(int(rot_dim) >= 1, f"rot_dim must be positive, got {rot_dim}")
    _check(lof.shape[0] == ncb, f"lof has {lof.shape[0]} entries for {ncb} chunks")
    _check(tuple(meta.shape) == (n_lists, 3, L),
           f"meta must be {(n_lists, 3, L)}, got {tuple(meta.shape)}")
    _check(tuple(base.shape) == (n_lists, 1, L),
           f"base must be {(n_lists, 1, L)}, got {tuple(base.shape)}")
    _check(tuple(qmeta.shape) == (ncb, 4, chunk),
           f"qmeta must be {(ncb, 4, chunk)}, got {tuple(qmeta.shape)}")
    _check(L % _LANES == 0, f"list length {L} must be a multiple of {_LANES}")
    if chunk_valid is not None:
        _tensor_arg("chunk_valid", chunk_valid, (torch.int32,), 1, dev)
        _check(chunk_valid.shape[0] == ncb, "chunk_valid must have one entry per chunk")
    if chunk_rows is not None:
        _tensor_arg("chunk_rows", chunk_rows, (torch.int32,), 1, dev)
        _check(chunk_rows.shape[0] == ncb, "chunk_rows must have one entry per chunk")
    kb = fused_kbuf(k) if kbuf is None else int(kbuf)
    _check(kb >= fused_kbuf(k), f"candidate buffer width {kb} cannot hold k={k}")
    if dev.type == "cpu":
        return _maybe_corrupt(*fused_bitplane_topk_plain(lof, planes, codes_t, meta, base,
                                                         qmeta, int(k), kb, int(rot_dim),
                                                         int(bits), bool(inner_product),
                                                         chunk_valid, chunk_rows))
    _check(dev.type == "cuda", f"fused_bitplane_topk runs on cpu or cuda, got {dev}")
    _check(fits_fused_bitplane(L, W, int(bits), int(k), kb),
           f"fused_bitplane_topk: words={W}, bits={bits}, k={k} are outside the kernel's "
           f"envelope (S_u past 2^24)")
    vals = torch.empty((ncb, chunk, kb), dtype=torch.float32, device=dev)
    idx = torch.empty((ncb, chunk, kb), dtype=torch.int32, device=dev)
    fn = _kernel_fn("fused_bitplane_topk.cu", "fused_bitplane_topk_launch",
                    [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                     ctypes.c_float, _I, _P])
    live = _live_rows(chunk_valid, chunk_rows, chunk)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(lof.data_ptr(), planes.data_ptr(), codes_t.data_ptr(), meta.data_ptr(),
                 base.data_ptr(), qmeta.data_ptr(), None if live is None else live.data_ptr(),
                 vals.data_ptr(), idx.data_ptr(), ncb, chunk, W, int(bits), L, int(k), kb,
                 rsqrt_dim(int(rot_dim)), int(bool(inner_product)), stream)
    _raise_on(err, "fused_bitplane_topk")
    _count_launch("fused_bitplane_topk")
    return _maybe_corrupt(vals, idx)
