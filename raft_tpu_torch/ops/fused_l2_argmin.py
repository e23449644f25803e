"""Fused L2 distance + argmin, the k-means labelling loop (counterpart of
raft_tpu/ops/fused_l2_argmin.py).

`fused_l2_argmin` is the wrapper over the hand-written CUDA kernel
`csrc/fused_l2_argmin.cu`; `fused_l2_argmin_plain` is the plain PyTorch
version of the same function beside it. The wrapper takes the plain
version only for tensors on the CPU; for a CUDA tensor it launches the
kernel or raises, and adds one to `launch_counts()["fused_l2_argmin"]`
(`ops._launch`) where it launches.

Contract (the JAX kernel's): for each row x_i of an f32 (m, k) matrix, the
row j of an f32 (n, k) matrix minimizing d_ij = max(|x_i|^2 + (|y_j|^2 -
2 <x_i, y_j>), 0), the augmented product [x, 1] . [-2y, |y|^2] (-2y is
exact), clamped BEFORE the comparison, so candidates that round below
zero all tie at 0.0 and the lowest index wins; the lowest index wins
every exact tie. sqrt applies to the minimum, after the search. The
reference multiplies at Precision.HIGHEST; the kernel keeps f32 accuracy
on the tensor cores by split TF32 (three TF32 products a multiply-add,
the header of csrc/fused_l2_argmin.cu). |y|^2 and the split, packed -2y
(`pack_split`) are computed once per call, here, and handed to the
kernel; x is split by the kernel as it loads it, except past a padded
depth of RESIDENT_MAX_DEPTH, where the block's split tile does not fit in
shared memory and x is split and packed here too (an (m, kpad) hi and lo
copy, off the main path's depth 96). The kernel sums |x|^2 itself from the
raw x values it loads (another order than the plain version's
`torch.sum`: within the expanded form's f32 floor, exact on integer
grids).
"""

from __future__ import annotations

import torch

from raft_tpu_torch.core.config import strict_f32_matmul
from raft_tpu_torch.ops._launch import (_I, _P, _check, _count_launch, _kernel_fn,
                                         _raise_on, _tensor_arg)


def _norms(x: torch.Tensor, y: torch.Tensor):
    """(|x_i|^2, |y_j|^2, -2y): the epilogue and augmented operand both
    versions share."""
    return torch.sum(x * x, dim=1), torch.sum(y * y, dim=1), -2.0 * y


#: the kernel's row and column tiles (kBM = kBN in the source), its depth
#: chunk (kKC), and the padded depth up to which a block keeps its x tile
#: resident and splits it itself (kResidentDepth); past it the wrapper
#: splits x too (`pack_split`) and the kernel streams it beside y
_TILE, _KC = 128, 32
RESIDENT_MAX_DEPTH = 128


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32 (10 mantissa bits) to nearest, ties away
    from zero, the low 13 bits zero: cvt.rna.tf32.f32's rounding, as the
    kernel writes it on the f32 bits."""
    b = t.float().contiguous().view(torch.int32).to(torch.int64)
    r = (b + 0x1000) & 0xFFFFE000
    return torch.where(r >= 2**31, r - 2**32, r).to(torch.int32).view(torch.float32)


def pack_split(a: torch.Tensor) -> torch.Tensor:
    """An (r, k) f32 operand split into TF32 hi = tf32(a) and lo = tf32(a -
    hi), laid out as the kernel's shared-memory chunks in the order it
    loads them: for each tile of 128 rows and each 32-deep chunk, hi then
    lo, each 128 rows x 128 bytes, K-major, 128-byte swizzled (16-byte unit
    u of row r at position u ^ (r % 8)); (ceil(r/128), kpad/32, 2, 128, 32)
    f32, kpad = k rounded up to 32, zeros past r and k."""
    n, k = a.shape
    npad, kpad = -(-n // _TILE) * _TILE, -(-k // _KC) * _KC
    full = torch.zeros((npad, kpad), dtype=torch.float32, device=a.device)
    full[:n, :k] = a
    hi = tf32_round(full)
    lo = tf32_round(full - hi)
    nt, nkc = npad // _TILE, kpad // _KC
    r = torch.arange(_TILE, device=a.device)[:, None]
    src = torch.arange(8, device=a.device)[None, :] ^ (r % 8)  # unit stored at position p

    def chunks(h):  # (npad, kpad) -> (nt, nkc, 128, 8 units, 4), swizzled
        h = h.reshape(nt, _TILE, nkc, 8, 4).permute(0, 2, 1, 3, 4)
        return h[:, :, r, src]

    return torch.stack([chunks(hi), chunks(lo)], dim=2).reshape(nt, nkc, 2, _TILE,
                                                                _KC).contiguous()


def fused_l2_argmin_plain(x: torch.Tensor, y: torch.Tensor, *, sqrt: bool = False,
                          budget_elems: int = 1 << 22):
    """Plain PyTorch version of the kernel, blocked over rows of x so one
    (bm, n) distance tile exists at a time (the JAX `_fused_l2_nn_xla`
    form, on the kernel's augmented operands)."""
    strict_f32_matmul()
    xn, yn, y2 = _norms(x, y)
    m, n = x.shape[0], y.shape[0]
    bm = max(1, min(m, budget_elems // max(1, n)))
    dist = torch.empty((m,), dtype=torch.float32, device=x.device)
    idx = torch.empty((m,), dtype=torch.int32, device=x.device)
    for s in range(0, m, bm):
        cross = yn[None, :] + x[s:s + bm] @ y2.T
        d = torch.clamp(xn[s:s + bm, None] + cross, min=0.0)
        best, arg = torch.min(d, dim=1)  # the first minimum: lowest index on ties
        dist[s:s + bm], idx[s:s + bm] = best, arg.to(torch.int32)
    return (torch.sqrt(dist) if sqrt else dist), idx


def fused_l2_argmin(x: torch.Tensor, y: torch.Tensor, *, sqrt: bool = False):
    """((m,) f32 min distance, (m,) int32 argmin) of squared L2 (or its
    sqrt) over the rows of y, for each row of x; x (m, k) and y (n, k)
    contiguous f32 on one device, n >= 1."""
    _check(isinstance(x, torch.Tensor), "x must be a tensor")
    dev = x.device
    _tensor_arg("x", x, (torch.float32,), 2, dev)
    _tensor_arg("y", y, (torch.float32,), 2, dev)
    m, k = x.shape
    n = y.shape[0]
    _check(y.shape[1] == k, f"x has {k} columns, y has {y.shape[1]}")
    _check(n >= 1, "fused_l2_argmin needs at least one row of y")
    if dev.type == "cpu":
        return fused_l2_argmin_plain(x, y, sqrt=sqrt)
    _check(dev.type == "cuda", f"fused_l2_argmin runs on cpu or cuda, got {dev}")
    yn, y2 = torch.sum(y * y, dim=1), -2.0 * y
    dist = torch.empty((m,), dtype=torch.float32, device=dev)
    idx = torch.empty((m,), dtype=torch.int32, device=dev)
    if m == 0:
        return dist, idx
    yp = pack_split(y2)
    xp = pack_split(x) if -(-k // _KC) * _KC > RESIDENT_MAX_DEPTH else None
    fn = _kernel_fn("fused_l2_argmin.cu", "fused_l2_argmin_launch",
                    [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(x.data_ptr(), None if xp is None else xp.data_ptr(), yp.data_ptr(),
                 yn.data_ptr(), dist.data_ptr(), idx.data_ptr(), m, n, k, int(bool(sqrt)), stream)
    _raise_on(err, "fused_l2_argmin")
    _count_launch("fused_l2_argmin")
    return dist, idx
