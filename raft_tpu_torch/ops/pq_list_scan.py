"""Fused list scan + bin fold (counterpart of raft_tpu/ops/pq_list_scan.py).

`pq_list_scan` is the wrapper over the hand-written CUDA kernel
`csrc/pq_list_scan.cu`; `pq_list_scan_plain` is the plain PyTorch version
of the same function beside it. The wrapper takes the plain version only
for tensors on the CPU; for a CUDA tensor it launches the kernel or
raises, and adds one to `launch_counts()["pq_list_scan"]` (`ops._launch`)
where it launches.

Contract (the JAX package's): for each chunk i the query rows score every
slot of the one list `lof[i]` of a slot-table store, L2 `base - 2<q,v>`,
inner product `base - <q,v>` (`base` +inf on invalid slots), with
bf16-rounded operands and f32 dots, or with int8 rows x an int8 store,
int32 dots and the per-row `q_scale` (scored by `fused_scan.int8_scores`,
as `fused_list_topk_int8` scores them). Each row's L scores fold into 256
bins, slot j into lane j % 128 of bank (j // 128) % 2, and each bin keeps
its best and second best: (ncb, chunk, 512) scores and int32 slots, laid
out [bank 0 best | bank 1 best | bank 0 second | bank 1 second]. The
engine's top-k over them breaks ties by position, so the layout is part
of the result.

  fold="exact"   strict-< updates in fold order: ties keep the earlier
                 fold (the smaller slot); +inf never enters; never-filled
                 entries are (+inf, 0).
  fold="packed"  the two smallest int32 packings of (bf16-coarse score
                 image | fold id) per bin (`_pack_scores`), unpacked to
                 the band's lower bound (`_unpack_scores`); a +inf score
                 takes a bin like any other, never-filled entries are
                 (+inf, 0).

The port's addition: `chunk_rows`, the count of each chunk's live leading
rows. Rows at or past it hold (+inf, 0) and cost no work; the JAX engine
scans them (pad rows) and never reads what they hold.

Left out: `rot_pad_enabled` and the `RAFT_TPU_PALLAS_ROT_PAD` rescue. They
work around a TPU Mosaic compile of a contracting dimension that is not a
multiple of 128, behind an environment variable, and their results are
bit-identical; a Hopper kernel has no such constraint. `fold_variant`
reads the tuned `pallas_fold` key (core/tuned.py) for work on a CUDA
device, and is "exact" otherwise.
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.config import strict_f32_matmul
from raft_tpu_torch.ops._launch import (_I, _P, _check, _count_launch, _kernel_fn,
                                         _raise_on, _tensor_arg)
from raft_tpu_torch.ops.fused_scan import (
    _LANES,
    _STORE_KINDS,
    SMEM_LIMIT,
    _bf16,
    _check_list_store_alignment,
    _int8_list_scores,
    _lex_key,
    _list_tc_smem_bytes,
    _mask_dead_rows,
)

_BINS = 2 * _LANES  # two interleaved lane banks; also the engine's k cap
_CANDS = 2 * _BINS  # best + second best per (lane, bank)
_FOLDS = ("exact", "packed")
_INT_MIN = -(2**31)
_INT_MAX = 2**31 - 1


def lane_padded(width: int) -> int:
    """The slot-axis width of a padded store: a multiple of 128, at least
    256, so that both candidate banks fill."""
    return max(_BINS, -(-width // _LANES) * _LANES)


def fold_variant(device=None) -> str:
    """The fold the engines use on `device`: the tuned `pallas_fold` where
    the table governs it (CUDA) and names a known fold, else "exact"."""
    from raft_tpu_torch.core import tuned

    if not tuned.applies(device):
        return "exact"
    v = tuned.get("pallas_fold", "exact")
    return v if v in _FOLDS else "exact"


def _pack_scores(scores: torch.Tensor, fold_ids: torch.Tensor) -> torch.Tensor:
    """Monotone f32 -> int32 packing: the high 16 bits carry the
    order-preserving image of the score, coarsened to bf16, the low 16
    the fold id, xor'd so that signed int32 order is the packed order."""
    i = scores.contiguous().view(torch.int32)
    u = torch.where(i < 0, ~i, i | _INT_MIN)
    return ((u & -65536) | fold_ids) ^ _INT_MIN


def _unpack_scores(packed: torch.Tensor):
    """Inverse of `_pack_scores`: (the f32 lower bound of the score's bf16
    band, the fold id)."""
    p = packed ^ _INT_MIN
    fold = p & 0xFFFF
    u = p & -65536
    i = torch.where(u < 0, u & _INT_MAX, ~u)
    return i.view(torch.float32), fold


def _fold_smem_bytes(rot: int, q_int8: bool) -> int:
    """Shared memory of one kernel block: the tensor-core list scan's
    staging without row lists (list_tc_smem_bytes(rot, i8, stages, 0) in
    csrc/list_scan_tc.cuh, as `fused_list_topk` at k <= 32 or
    `fused_list_topk_int8` with `q_int8`). The fold keeps its bins in
    registers; the layout's score tile serves only as scratch."""
    return _list_tc_smem_bytes(rot, q_int8, 1)


def fits_pq_list_scan(L: int, rot: int, q_int8: bool = False) -> bool:
    """Shared-memory budget of one kernel block (`_fold_smem_bytes`), and
    the list contract: L a multiple of 128, at least 256, and fold ids
    within the packing's 16 bits."""
    return (L % _LANES == 0 and L >= _BINS and L // _LANES <= 0xFFFF
            and _fold_smem_bytes(rot, q_int8) <= SMEM_LIMIT)


def _two_smallest(x: torch.Tensor):
    """(..., n) -> values and positions (..., 2) of the two
    lexicographically smallest (value, position) pairs along the last
    axis, best first; a missing second is (+inf, 0)."""
    kk = min(2, x.shape[-1])
    _, pos = torch.topk(_lex_key(x), kk, dim=-1, largest=False, sorted=True)
    v = torch.gather(x, -1, pos)
    if kk < 2:
        v = torch.cat([v, torch.full_like(v, float("inf"))], -1)
        pos = torch.cat([pos, torch.zeros_like(pos)], -1)
    return v, pos


def _fold_exact(scores: torch.Tensor):
    """(b, chunk, L) scores -> (b, chunk, 512) values and slots."""
    b, chunk, L = scores.shape
    lanes = torch.arange(_LANES, device=scores.device)
    folds = scores.reshape(b, chunk, L // _LANES, _LANES)
    best, second = [], []
    for bank in range(2):
        v, pos = _two_smallest(folds[:, :, bank::2, :].transpose(2, 3))  # (b, chunk, 128, 2)
        slot = (bank + 2 * pos) * _LANES + lanes[:, None]
        slot = torch.where(v == float("inf"), 0, slot)  # +inf never entered the bin
        best.append((v[..., 0], slot[..., 0]))
        second.append((v[..., 1], slot[..., 1]))
    order = best + second
    return (torch.cat([v for v, _ in order], -1),
            torch.cat([i for _, i in order], -1).to(torch.int32))


def _fold_packed(scores: torch.Tensor):
    """(b, chunk, L) scores -> (b, chunk, 512) packed-fold values and
    slots."""
    b, chunk, L = scores.shape
    n_folds = L // _LANES
    fold_ids = (torch.arange(L, device=scores.device, dtype=torch.int32) // _LANES)
    packed = _pack_scores(scores, fold_ids).reshape(b, chunk, n_folds, _LANES)
    mins = []
    for bank in range(2):
        x = packed[:, :, bank::2, :].transpose(2, 3)  # (b, chunk, 128, folds of the bank)
        m = torch.topk(x, min(2, x.shape[-1]), dim=-1, largest=False, sorted=True).values
        if m.shape[-1] < 2:
            m = torch.cat([m, torch.full_like(m, _INT_MAX)], -1)
        mins.append(m)
    allp = torch.cat([mins[0][..., 0], mins[1][..., 0], mins[0][..., 1], mins[1][..., 1]], -1)
    v, fold = _unpack_scores(allp)
    lane = torch.arange(_CANDS, device=scores.device, dtype=torch.int32) % _LANES
    invalid = fold >= n_folds  # never filled
    return (torch.where(invalid, float("inf"), v),
            torch.where(invalid, 0, fold * _LANES + lane).to(torch.int32))


def pq_list_scan_plain(lof, qres_s, store, base, inner_product: bool, q_scale=None,
                       fold: str = "exact", chunk_rows=None, block_elems: int = 1 << 25):
    """Plain PyTorch version of the kernel (same operands as
    `pq_list_scan`). Chunk blocks bound the gathered store copy and the
    score strip."""
    strict_f32_matmul()
    coef = 1.0 if inner_product else 2.0
    ncb, chunk, rot = qres_s.shape
    L = store.shape[1]
    fold_fn = _fold_packed if fold == "packed" else _fold_exact
    outs_v, outs_i = [], []
    cb = max(1, block_elems // max(1, L * max(rot, chunk)))
    for s in range(0, ncb, cb):
        lids = lof[s:s + cb].long()
        if q_scale is not None:
            scores = _int8_list_scores(qres_s[s:s + cb], store[lids], base[lids],
                                       q_scale[s:s + cb], inner_product)
        else:
            st = store[lids].to(torch.bfloat16).float()  # (b, L, rot)
            scores = base[lids] - coef * torch.bmm(_bf16(qres_s[s:s + cb]), st.transpose(1, 2))
        v, i = fold_fn(scores)
        outs_v.append(v)
        outs_i.append(i)
    return _mask_dead_rows(torch.cat(outs_v), torch.cat(outs_i), chunk_rows, 0)


def pq_list_scan(lof, qres_s, recon8, base, inner_product: bool = False, q_scale=None,
                 fold: str = "exact", *, chunk_rows=None):
    """Scan each chunk's list and fold the scores into 256 bins, best and
    second best each.

    lof (ncb,) int32 chunk -> list id; qres_s (ncb, chunk, rot) f32 query
    residuals with the store's scale folded in, or int8 rows when
    `q_scale` (ncb, chunk, 1) f32 is given (then the store must be int8);
    recon8 the store (n_lists, L, rot) int8/bf16/f32, L a multiple of 128
    and >= 256; base (n_lists, 1, L) f32, +inf on invalid slots;
    chunk_rows (ncb,) int32 or None (each chunk's live leading rows). Returns
    ((ncb, chunk, 512) f32 scores, (ncb, chunk, 512) int32 in-list
    slots), minimizing; callers add per-query constants and finish with an
    exact top-k over the candidates."""
    store = recon8
    _check(isinstance(qres_s, torch.Tensor), "qres_s must be a tensor")
    dev = qres_s.device
    q_int8 = q_scale is not None
    if q_int8:
        _check(qres_s.dtype == torch.int8 and getattr(store, "dtype", None) == torch.int8,
               "q_scale requires int8 queries and an int8 store")
        _tensor_arg("q_scale", q_scale, (torch.float32,), 3, dev)
    _check(fold in _FOLDS, f"unknown fold variant {fold!r}")
    _tensor_arg("lof", lof, (torch.int32,), 1, dev)
    _tensor_arg("qres_s", qres_s, (torch.int8,) if q_int8 else (torch.float32,), 3, dev)
    _tensor_arg("store", store, tuple(_STORE_KINDS), 3, dev)
    _tensor_arg("base", base, (torch.float32,), 3, dev)
    ncb, chunk, rot = qres_s.shape
    n_lists, L, srot = store.shape
    _check(srot == rot, f"store rows have {srot} columns, qres_s {rot}")
    _check(lof.shape[0] == ncb, f"lof has {lof.shape[0]} entries for {ncb} chunks")
    _check(tuple(base.shape) == (n_lists, 1, L),
           f"base must be {(n_lists, 1, L)}, got {tuple(base.shape)}")
    _check(L % _LANES == 0 and L >= _BINS,
           f"list length {L} must be a multiple of {_LANES} and >= {_BINS}")
    if q_int8:
        _check(tuple(q_scale.shape) == (ncb, chunk, 1),
               f"q_scale must be {(ncb, chunk, 1)}, got {tuple(q_scale.shape)}")
    _check_list_store_alignment(store, rot, int8_rows=q_int8)
    if chunk_rows is not None:
        _tensor_arg("chunk_rows", chunk_rows, (torch.int32,), 1, dev)
        _check(chunk_rows.shape[0] == ncb, "chunk_rows must have one entry per chunk")
    if dev.type == "cpu":
        return pq_list_scan_plain(lof, qres_s, store, base, bool(inner_product), q_scale, fold,
                                  chunk_rows)
    _check(dev.type == "cuda", f"pq_list_scan runs on cpu or cuda, got {dev}")
    _check(fits_pq_list_scan(L, rot, q_int8),
           f"pq_list_scan: L={L}, rot={rot} exceed the kernel's shared-memory budget")
    vals = torch.empty((ncb, chunk, _CANDS), dtype=torch.float32, device=dev)
    idx = torch.empty((ncb, chunk, _CANDS), dtype=torch.int32, device=dev)
    fn = _kernel_fn("pq_list_scan.cu", "pq_list_scan_launch",
                    [_P, _P, _P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(lof.data_ptr(), qres_s.data_ptr(), q_scale.data_ptr() if q_int8 else None,
                 store.data_ptr(), _STORE_KINDS[store.dtype], base.data_ptr(),
                 None if chunk_rows is None else chunk_rows.data_ptr(), vals.data_ptr(),
                 idx.data_ptr(), ncb, chunk, rot, L, n_lists, int(bool(inner_product)),
                 int(fold == "packed"), stream)
    _raise_on(err, "pq_list_scan")
    _count_launch("pq_list_scan")
    return vals, idx
