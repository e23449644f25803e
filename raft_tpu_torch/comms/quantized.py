"""Quantized wire transport for `AxisComms` (counterpart of
raft_tpu/comms/quantized.py; EQuARX-style block-scaled collectives,
arXiv 2506.17615).

An opt-in transport behind the `quantization=` keyword of
`AxisComms.allreduce / allgather / reducescatter / bcast`, plus a top-k
candidate exchange for distributed search merges. Two codecs:

  "int8"  block-scaled int8: one f32 absmax scale a `block` of values,
          encoded before the wire and decoded after. The ring allreduce
          and reduce-scatter requantize at every hop (the EQuARX
          schedule): ~1/4 of f32's volume plus 4/block of scales. Worst
          error a value: absmax/254 an encode (round to nearest over 255
          levels).
  "bf16"  cast transport: payloads travel as bfloat16 and reductions
          accumulate in bfloat16.

`quantization=None` and "off" are the exact collectives, untouched (the
dispatch happens before any work). "auto" reads the tuned keys
`comms_quant_mode` / `comms_quant_block` where the table governs the
ranks' device (`tuned.applies`, CUDA only); the port commits no value for
them (an in-process world on one card moves no bytes over a wire), so
"auto" is exact.

Exactness fallbacks (the codec silently steps aside): integer and bool
payloads, `op_t.PROD`, and worlds of one rank.

`exchange_candidates`: round 1 allgathers only the block-quantized scores
(positions are implicit in the rank-major layout); every rank selects the
same ceil(exchange_mult * k) survivors from the decoded scores; one
masked SUM then brings each survivor's exact f32 score and int32 id from
its owning rank (zeros elsewhere: a sum with one non-zero term is exact),
and the final top-k re-ranks on exact values. Quantization picks the
shortlist, never the reported scores.

Fault surface: sites `comms.quant.encode` / `comms.quant.decode` corrupt
the scale sidecars on the faulted rank (NaN contributions, never a
crash). Wire accounting: every quantized path charges `obs.collective`
with the actual wire bytes (payload + scales, summed over ring hops) and
the wire dtype.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import faults
from raft_tpu_torch.comms.comms import AxisComms, op_t

ENCODE_SITE = "comms.quant.encode"
DECODE_SITE = "comms.quant.decode"

#: int8 codec: values per f32 absmax scale (tuned key `comms_quant_block`)
DEFAULT_BLOCK = 32
BLOCK_CHOICES = (16, 32, 64, 128)

#: exchange_candidates shortlist width multiplier: survivors = ceil(mult*k)
DEFAULT_EXCHANGE_MULT = 1.25

MODES = ("off", "int8", "bf16")


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Resolved quantization policy; hashable, so it keys the cached
    per-rank bodies (`mnmg_common.wrapper_key`)."""

    mode: str
    block: int = DEFAULT_BLOCK
    exchange_mult: float = DEFAULT_EXCHANGE_MULT

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown quantization mode {self.mode!r}; "
                             f"one of {MODES}")
        if int(self.block) < 1:
            raise ValueError(f"block must be >= 1, got {self.block}")
        if float(self.exchange_mult) < 1.0:
            raise ValueError("exchange_mult must be >= 1.0 (the shortlist "
                             f"can never be narrower than k), got "
                             f"{self.exchange_mult}")


def _tuned_mode(device) -> Optional[str]:
    from raft_tpu_torch.core import tuned

    if not tuned.applies(device):
        return None
    m = tuned.get("comms_quant_mode")
    return m if m in ("int8", "bf16") else None


def _tuned_block(device) -> int:
    from raft_tpu_torch.core import tuned

    if not tuned.applies(device):
        return DEFAULT_BLOCK
    return int(tuned.get_choice("comms_quant_block", BLOCK_CHOICES, DEFAULT_BLOCK))


def resolve(quantization, device=None) -> Optional[QuantConfig]:
    """Normalize a `quantization=` argument to a QuantConfig, or None for
    the exact path: None / False / "off" (exact), "int8" / "bf16" (block
    from the tuned key or the default), "auto" (the tuned keys where the
    table governs `device`; exact otherwise), or a QuantConfig."""
    if quantization is None or quantization is False or quantization == "off":
        return None
    if isinstance(quantization, QuantConfig):
        return None if quantization.mode == "off" else quantization
    if quantization == "auto":
        mode = _tuned_mode(device)
        if mode is None:
            return None
        return QuantConfig(mode=mode, block=_tuned_block(device))
    if quantization in ("int8", "bf16"):
        return QuantConfig(mode=quantization, block=_tuned_block(device))
    raise ValueError(
        f"unknown quantization {quantization!r}; one of None, 'off', "
        "'auto', 'int8', 'bf16', or a QuantConfig")


# -- codec --------------------------------------------------------------

def quantize_blocks(x, block: int = DEFAULT_BLOCK):
    """Block-scaled int8 encode: flatten, pad to whole `block`-value
    blocks (pads encode exact zero), quantize each block against its own
    absmax. Returns `(q, scales)`: int8 (nblk * block,), f32 (nblk,). An
    all-zero block gets scale 0 and decodes to zeros."""
    flat = torch.as_tensor(x).float().reshape(-1)
    n = flat.shape[0]
    nblk = max(1, -(-n // block))
    pad = nblk * block - n
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    b = flat.reshape(nblk, block)
    scales = torch.amax(torch.abs(b), dim=1) / 127.0
    safe = torch.where(scales > 0, scales, torch.ones_like(scales))
    q = torch.clamp(torch.round(b / safe[:, None]), -127, 127).to(torch.int8)
    return q.reshape(-1), scales


def dequantize_blocks(q, scales, shape, dtype=torch.float32):
    """Inverse of `quantize_blocks` for a logical array of `shape`."""
    nblk = scales.shape[0]
    block = q.shape[0] // nblk
    x = q.reshape(nblk, block).float() * scales[:, None]
    n = math.prod(shape) if shape else 1
    return x.reshape(-1)[:n].reshape(tuple(shape)).to(dtype)


def packet_bytes(n: int, block: int) -> int:
    """Wire bytes of one encoded packet of `n` values: int8 payload (whole
    blocks) plus the f32 scale sidecar."""
    nblk = max(1, -(-n // block))
    return nblk * block + 4 * nblk


_COMBINE = {op_t.SUM: torch.add, op_t.MIN: torch.minimum, op_t.MAX: torch.maximum}


def _quantizable(x, op: Optional[op_t], world: int) -> bool:
    """Payloads the codecs may touch: floats, SUM / MIN / MAX (or no
    reduction), worlds of two ranks or more."""
    if world < 2:
        return False
    if op is not None and op not in _COMBINE:
        return False
    return x.is_floating_point()


# -- quantized collectives (inside a run body) --------------------------

def qallreduce(ac: AxisComms, x, op: op_t, cfg: Optional[QuantConfig]):
    """Quantized allreduce. int8 ungrouped: ring reduce-scatter + ring
    allgather with per-hop requantization; int8 grouped: the intra-group
    rotation ring on one encoded packet; bf16: cast transport through the
    exact dispatch."""
    x = ac._t(x)
    w = ac._wire_world()
    if cfg is None or not _quantizable(x, op, w):
        return ac.allreduce(x, op)
    identity = ac._reduce_identity(x.dtype, op)
    if cfg.mode == "bf16":
        ac._count("allreduce", x, world=w,
                  wire_bytes=obs.perf.collective_wire_bytes("allreduce", x.numel() * 2, w),
                  wire_dtype="bfloat16")
        xi = ac._inject("comms.allreduce", x, identity)
        return ac._allreduce_raw(xi.to(torch.bfloat16), op).to(x.dtype)
    block = int(cfg.block)
    xi = ac._inject("comms.allreduce", x, identity)
    if ac.groups is not None:
        nblk = max(1, -(-x.numel() // block))
        ac._count("allreduce", x, world=w,
                  wire_bytes=(ac._max_group_size() - 1) * (nblk * block + 4 * nblk),
                  wire_dtype="int8")
        return _grouped_qallreduce_int8(ac, xi, op, block)
    n = x.numel()
    chunk = block * max(1, -(-n // (ac.size * block)))
    ac._count("allreduce", x, world=w,
              wire_bytes=2 * (ac.size - 1) * packet_bytes(chunk, block), wire_dtype="int8")
    return _ring_qallreduce_int8(ac, xi, op, block)


def _grouped_qallreduce_int8(ac: AxisComms, x, op: op_t, block: int):
    """Grouped int8 allreduce on the `_grouped_reduce_ring` rotation:
    encode once, rotate the (q, scales) packet within each group, decode
    and combine behind the `k + 1 < own size` gate (one quantization
    error a contribution; the own contribution stays exact)."""
    combine = _COMBINE[op]
    rank = ac._axis_index()
    q, sc = quantize_blocks(x, block)
    sc = faults.corrupt_in_trace(ENCODE_SITE, sc, rank)
    s_own = ac._own_group_size()
    perm = ac._ring_perm()
    acc = x.float()
    qy, scy = q, sc
    for k in range(ac._max_group_size() - 1):
        qy = ac._ppermute(qy, perm)
        scy = ac._ppermute(scy, perm)
        scd = faults.corrupt_in_trace(DECODE_SITE, scy, rank)
        y = dequantize_blocks(qy, scd, tuple(x.shape))
        if k + 1 < s_own:
            acc = combine(acc, y)
    return acc.to(x.dtype)


def _ring_qallreduce_int8(ac: AxisComms, x, op: op_t, block: int):
    """Full-axis int8 ring allreduce with per-hop requantization. Reduce-
    scatter phase: the payload splits into w chunks of whole blocks; at
    step s rank r ships its requantized accumulator for chunk (r - s) and
    receives chunk (r - 1 - s)'s; after w - 1 steps rank r holds the
    reduced chunk (r + 1) % w. Allgather phase: each rank encodes its
    chunk once and the packet circulates; every rank, owner included,
    decodes the same packet, so every rank holds the same bits."""
    w = ac.size
    combine = _COMBINE[op]
    rank = ac._axis_index()
    flat = x.float().reshape(-1)
    n = flat.shape[0]
    chunk = block * max(1, -(-n // (w * block)))
    padded = w * chunk
    if padded > n:
        flat = torch.cat([flat, flat.new_zeros(padded - n)])
    parts = flat.reshape(w, chunk)
    perm = [(i, (i + 1) % w) for i in range(w)]
    cur = parts[rank]
    for s in range(w - 1):
        q, sc = quantize_blocks(cur, block)
        sc = faults.corrupt_in_trace(ENCODE_SITE, sc, rank)
        q = ac._ppermute(q, perm)
        sc = ac._ppermute(sc, perm)
        scd = faults.corrupt_in_trace(DECODE_SITE, sc, rank)
        cur = combine(parts[(rank - 1 - s) % w], dequantize_blocks(q, scd, (chunk,)))
    q, sc = quantize_blocks(cur, block)
    sc = faults.corrupt_in_trace(ENCODE_SITE, sc, rank)
    out = flat.new_zeros((w, chunk))
    scd = faults.corrupt_in_trace(DECODE_SITE, sc, rank)
    out[(rank + 1) % w] = dequantize_blocks(q, scd, (chunk,))
    for s in range(w - 1):
        q = ac._ppermute(q, perm)
        sc = ac._ppermute(sc, perm)
        scd = faults.corrupt_in_trace(DECODE_SITE, sc, rank)
        out[(rank - s) % w] = dequantize_blocks(q, scd, (chunk,))
    return out.reshape(-1)[:n].reshape(x.shape).to(x.dtype)


def qreducescatter(ac: AxisComms, x, op: op_t, cfg: Optional[QuantConfig], axis: int = 0):
    """Quantized reduce-scatter: the ring reduce-scatter phase alone, on
    `axis`-major chunks so the layout matches the exact path's; grouped
    comms allreduce then slice, as the exact path does."""
    x = ac._t(x)
    w = ac._wire_world()
    if cfg is None or not _quantizable(x, op, w):
        return ac.reducescatter(x, op, axis=axis)
    if cfg.mode == "bf16":
        ac._count("reducescatter", x, world=w,
                  wire_bytes=obs.perf.collective_wire_bytes("reducescatter", x.numel() * 2, w),
                  wire_dtype="bfloat16")
        return ac._reducescatter_raw(x.to(torch.bfloat16), op, axis).to(x.dtype)
    block = int(cfg.block)
    if ac.groups is not None:
        m = ac._max_group_size()
        if x.shape[axis] % m:
            raise ValueError(
                f"x.shape[{axis}]={x.shape[axis]} not divisible by the "
                f"largest group size {m}")
        per = x.shape[axis] // m
        ac._count("reducescatter", x, world=w, wire_bytes=0,
                  wire_dtype="int8")  # the inner qallreduce charges
        red = qallreduce(ac, x, op, cfg)
        return red.narrow(axis, ac.get_rank() * per, per)
    if x.shape[axis] % ac.size:
        raise ValueError(
            f"x.shape[{axis}]={x.shape[axis]} not divisible by comm "
            f"size {ac.size}")
    chunk_n = x.numel() // ac.size
    ac._count("reducescatter", x, world=w,
              wire_bytes=(ac.size - 1) * packet_bytes(chunk_n, block), wire_dtype="int8")
    return _ring_qreducescatter_int8(ac, x, op, block, axis)


def _ring_qreducescatter_int8(ac: AxisComms, x, op: op_t, block: int, axis_dim: int):
    """Ring reduce-scatter with per-hop requantization: rank r starts on
    chunk (r - 1), at step s ships its accumulator for chunk (r - 1 - s)
    and receives chunk (r - 2 - s)'s; after w - 1 steps it holds the
    reduced chunk r (psum_scatter's assignment)."""
    w = ac.size
    combine = _COMBINE[op]
    rank = ac._axis_index()
    per = x.shape[axis_dim] // w
    xm = torch.movedim(x.float(), axis_dim, 0)
    parts = xm.reshape((w, per) + tuple(xm.shape[1:]))
    chunk_shape = tuple(parts.shape[1:])
    perm = [(i, (i + 1) % w) for i in range(w)]
    cur = parts[(rank - 1) % w]
    for s in range(w - 1):
        q, sc = quantize_blocks(cur, block)
        sc = faults.corrupt_in_trace(ENCODE_SITE, sc, rank)
        q = ac._ppermute(q, perm)
        sc = ac._ppermute(sc, perm)
        scd = faults.corrupt_in_trace(DECODE_SITE, sc, rank)
        cur = combine(parts[(rank - 2 - s) % w], dequantize_blocks(q, scd, chunk_shape))
    return torch.movedim(cur, 0, axis_dim).to(x.dtype)


def qallgather(ac: AxisComms, x, cfg: Optional[QuantConfig], axis: int = 0,
               tiled: bool = False):
    """Quantized allgather: encode once, gather the int8 payload and the
    scales through the exact dispatch (grouped schedules included),
    decode every slot; the exact path's output layout."""
    x = ac._t(x)
    w = ac._wire_world()
    if cfg is None or not _quantizable(x, None, w):
        return ac.allgather(x, axis=axis, tiled=tiled)
    if cfg.mode == "bf16":
        ac._count("allgather", x, world=w,
                  wire_bytes=obs.perf.collective_wire_bytes("allgather", x.numel() * 2, w),
                  wire_dtype="bfloat16")
        xi = ac._inject("comms.allgather", x, 0)
        return ac._allgather_raw(xi.to(torch.bfloat16), axis, tiled).to(x.dtype)
    block = int(cfg.block)
    rank = ac._axis_index()
    ac._count("allgather", x, world=w, wire_bytes=(w - 1) * packet_bytes(x.numel(), block),
              wire_dtype="int8")
    xi = ac._inject("comms.allgather", x, 0)
    q, sc = quantize_blocks(xi, block)
    sc = faults.corrupt_in_trace(ENCODE_SITE, sc, rank)
    qg = ac._allgather_raw(q, 0, False)
    scg = ac._allgather_raw(sc, 0, False)
    scg = faults.corrupt_in_trace(DECODE_SITE, scg, rank)
    out = torch.stack([dequantize_blocks(qg[i], scg[i], tuple(x.shape))
                       for i in range(qg.shape[0])]).to(x.dtype)
    if tiled:
        return torch.cat([out[i] for i in range(out.shape[0])], axis)
    if axis != 0:
        return torch.movedim(out, 0, axis)
    return out


def qbcast(ac: AxisComms, x, cfg: Optional[QuantConfig], root: int = 0):
    """Quantized broadcast: every rank encodes, the exact dispatch moves
    the root-masked int8 payload and scales (a sum with one non-zero
    term), and every rank decodes the root's packet."""
    xa = ac._t(x)
    w = ac._wire_world()
    if cfg is None or not _quantizable(xa, None, w):
        return ac.bcast(xa, root)
    if cfg.mode == "bf16":
        ac._count("bcast", xa, world=w,
                  wire_bytes=obs.perf.collective_wire_bytes("bcast", xa.numel() * 2, w),
                  wire_dtype="bfloat16")
        return ac._bcast_raw(xa.to(torch.bfloat16), root).to(xa.dtype)
    block = int(cfg.block)
    rank = ac._axis_index()
    ac._count("bcast", xa, world=w,
              wire_bytes=obs.perf.collective_wire_bytes(
                  "bcast", packet_bytes(xa.numel(), block), w),
              wire_dtype="int8")
    q, sc = quantize_blocks(xa, block)
    sc = faults.corrupt_in_trace(ENCODE_SITE, sc, rank)
    qb = ac._bcast_raw(q, root)
    scb = ac._bcast_raw(sc, root)
    scb = faults.corrupt_in_trace(DECODE_SITE, scb, rank)
    return dequantize_blocks(qb, scb, tuple(xa.shape)).to(xa.dtype)


# -- candidate exchange -------------------------------------------------

def _lex_order(key, pos):
    """Row-wise order by (key, pos): ascending, NaN last, -0.0 equal to
    +0.0 (lax.sort's float order), ties by position."""
    o1 = torch.argsort(pos, dim=1, stable=True)
    o2 = torch.argsort(torch.gather(key, 1, o1), dim=1, stable=True)
    return torch.gather(o1, 1, o2)


def exchange_candidates(ac: AxisComms, v, ids, k: int, select_min: bool, cfg: QuantConfig):
    """Quantized replicated top-k candidate exchange (full-axis comms
    only; callers route split comms to the exact merge).

    `v`, `ids`: this rank's (nq, kk) local candidates, ids global, invalid
    entries at the worst value. Returns `(values, ids)` of width
    min(k, world * kk), the same on every rank, with exact scores. Ties
    order by (score, rank-major position) in both the shortlist and the
    final re-rank, so a saturated shortlist gives the exact merge's set."""
    w = ac.size
    nq, kk = v.shape
    total = w * kk
    rank = ac._axis_index()
    vf = v.float()
    out_k = min(int(k), total)
    s = min(total, max(out_k, int(math.ceil(cfg.exchange_mult * out_k))))

    if cfg.mode == "bf16":
        enc = faults.corrupt_in_trace(ENCODE_SITE, vf.to(torch.bfloat16), rank)
        ac._count("allgather", vf, world=w, wire_bytes=(w - 1) * vf.numel() * 2,
                  wire_dtype="bfloat16")
        g = ac._all_gather(enc)  # (w, nq, kk)
        cand = faults.corrupt_in_trace(DECODE_SITE, g.float(), rank)
    else:
        block = int(cfg.block)
        q, sc = quantize_blocks(vf, block)
        sc = faults.corrupt_in_trace(ENCODE_SITE, sc, rank)
        ac._count("allgather", vf, world=w, wire_bytes=(w - 1) * packet_bytes(vf.numel(), block),
                  wire_dtype="int8")
        qg = ac._all_gather(q)
        scg = ac._all_gather(sc)
        scg = faults.corrupt_in_trace(DECODE_SITE, scg, rank)
        cand = torch.stack([dequantize_blocks(qg[i], scg[i], (nq, kk)) for i in range(w)])
    cat = torch.movedim(cand, 0, 1).reshape(nq, total)  # rank-major columns

    # shortlist: top-s of the decoded scores, ties by global position
    key = cat if select_min else -cat
    _, spos = torch.sort(key, dim=1, stable=True)
    pos = spos[:, :s].to(torch.int32)

    # resolve: each survivor's owner contributes its exact score and id
    owner = torch.div(pos, kk, rounding_mode="floor")
    col = (pos % kk).long()
    mine = owner == rank
    sv = torch.where(mine, torch.gather(vf, 1, col), torch.zeros((), device=vf.device))
    sid = torch.where(mine, torch.gather(ids.to(torch.int32), 1, col),
                      torch.zeros((), dtype=torch.int32, device=vf.device))
    ac._count("allreduce", sv, world=w,
              wire_bytes=obs.perf.collective_wire_bytes("allreduce", sv.numel() * 4, w),
              wire_dtype="float32")
    ac._count("allreduce", sid, world=w,
              wire_bytes=obs.perf.collective_wire_bytes("allreduce", sid.numel() * 4, w),
              wire_dtype="int32")
    sv = ac._psum(sv)
    sid = ac._psum(sid)

    # exact re-rank of the survivors, same (score, position) order
    order = _lex_order(sv if select_min else -sv, pos)
    rv = torch.gather(sv, 1, order)[:, :out_k]
    rid = torch.gather(sid, 1, order)[:, :out_k]
    return rv, rid
