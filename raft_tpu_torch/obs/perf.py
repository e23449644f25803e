"""Analytic cost model: FLOP/byte formulas per span, peaks, MFU
(counterpart of raft_tpu/obs/perf.py).

Closed-form flops/bytes formulas for the library's hot paths, registered
per span name, so a span can charge its analytic cost
(`obs.span_cost(**perf.cost_for(name, ...))`) and the report derives
FLOP/s, B/s and MFU against a per-platform peak table.

The peak table has no TPU row. Its "h100" row is the H100 SXM's
datasheet rates: 989 TFLOP/s bf16 (dense), 1,979 TOP/s int8, 3.35 TB/s
HBM3, 4.18 x 10^12 popcount or MUFU operations/s ("int": 16 a clock on
each of 132 SMs) and 66.9 TFLOP/s f32. The f32 entry is where the port
departs from the JAX rule, which charges f32 flops against the bf16 peak
because a TPU runs an f32 matmul as bf16 passes on its MXU: the port
runs f32 with TF32 off, on the CUDA cores, so 66.9 TFLOP/s is its f32
ceiling. The "cpu" row is the JAX package's nominal placeholder, tagged
`nominal`, and every MFU derived from it carries the tag to the report.

Formulas are models, not measurements: they count multiply+add as 2
and the unavoidable memory traffic (operands read once per use, outputs
written once). The JAX package pins them against XLA's cost analysis;
the port has no XLA, and its tests pin the matmul terms against
`torch.utils.flop_counter.FlopCounterMode` instead.

Pure host-side math: `platform_info()` reads `torch.cuda` and nothing
else of the device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

# -- peak table ---------------------------------------------------------

#: per-platform peaks. flops are per-device dense peaks by compute
#: dtype; hbm_Bps is peak memory bandwidth. "nominal" entries are
#: bookkeeping placeholders (an unknown host CPU has no datasheet): MFU
#: derived from them is tagged and is never a hardware claim.
PEAK_TABLE: Dict[str, dict] = {
    # H100 SXM datasheet (dense): bf16 989 TFLOP/s, int8 1,979 TOP/s,
    # HBM3 3.35 TB/s; f32 66.9 TFLOP/s on the CUDA cores (TF32 off, the
    # port's f32 rule); "int" the popcount / MUFU issue rate, 16 a clock
    # an SM (the RaBitQ bit-plane scan's op class)
    "h100": {
        "peak_flops": {"bf16": 989e12, "f32": 66.9e12, "int8": 1979e12,
                       "int": 4.18e12},
        "hbm_Bps": 3.35e12,
        "nominal": False,
    },
    # CPU fallback: nominal 200 GFLOP/s / 50 GB/s placeholders so the
    # arithmetic stays runnable off the card; tagged.
    "cpu": {
        "peak_flops": {"bf16": 200e9, "f32": 200e9, "int8": 400e9,
                       "int": 200e9},
        "hbm_Bps": 50e9,
        "nominal": True,
    },
}

_DTYPE_CANON = {
    "float32": "f32", "f32": "f32", "fp32": "f32",
    "bfloat16": "bf16", "bf16": "bf16",
    "float16": "bf16", "f16": "bf16",  # same tensor-core rate class
    "int8": "int8", "uint8": "int8",
    # 32-bit integer/logical ops (popcount, AND, shift-add): their own
    # peak row
    "int32": "int", "uint32": "int", "int": "int",
}

_DTYPE_BYTES = {"f32": 4, "bf16": 2, "int8": 1, "int": 4}


def canon_dtype(dtype) -> str:
    """Normalize a dtype spelling (str, numpy dtype, scalar type, or a
    torch dtype) onto the peak table's keys; unknown dtypes count as f32
    (the conservative rate)."""
    name = getattr(dtype, "name", None)
    if name is None and str(dtype).startswith("torch."):
        name = str(dtype)[len("torch."):]
    if name is None and not isinstance(dtype, str):
        try:
            import numpy as _np

            name = _np.dtype(dtype).name
        except Exception:
            pass
    if name is None:
        name = str(dtype)
    return _DTYPE_CANON.get(name.lower(), "f32")


def dtype_bytes(dtype) -> int:
    return _DTYPE_BYTES[canon_dtype(dtype)]


def platform_info() -> dict:
    """The current platform on the peak table: the "cpu" row when no card
    is present; on a CUDA device the "h100" row with `device_kind` set to
    `torch.cuda.get_device_name()`. A card of another kind gets the same
    row with its kind recorded, so a wrong peak is diagnosable from a
    saved snapshot (which embeds this dict)."""
    import torch

    if not torch.cuda.is_available():
        return {"platform": "cpu", "device_kind": "cpu", **PEAK_TABLE["cpu"]}
    try:
        kind = str(torch.cuda.get_device_name())
    except Exception:
        kind = "uninitialized"
    return {"platform": "h100", "device_kind": kind, **PEAK_TABLE["h100"]}


def mfu(flops_by_dtype: Dict[str, float], seconds: float,
        info: Optional[dict] = None) -> Optional[float]:
    """Model FLOP utilization: sum over dtypes of flops_d / peak_d,
    divided by wall seconds. None when no peak covers the dtypes or the
    interval is empty — an unknown platform yields no MFU, not 0%."""
    if seconds <= 0.0 or not flops_by_dtype:
        return None
    info = info if info is not None else platform_info()
    peaks = info.get("peak_flops") or {}
    peak_seconds = 0.0
    for dt, fl in flops_by_dtype.items():
        peak = peaks.get(canon_dtype(dt))
        if not peak:
            return None
        peak_seconds += float(fl) / float(peak)
    return peak_seconds / float(seconds)


# -- analytic formulas --------------------------------------------------
#
# Every formula returns {"flops": int, "bytes": int, "dtype": str} — the
# kwargs shape `obs.span_cost(**...)` takes. flops count multiply+add as
# 2; bytes count the model's unavoidable HBM traffic (operands read once
# per use, outputs written once), not cache behavior.
#
# Composite formulas built with `_add` additionally carry
# "flops_by_dtype": each stage's flops stay attributed to the dtype/peak
# of the unit that executes them (the coarse f32 matmul, the int8
# tensor-core scan, the uint32 popcount fold), so a mixed-dtype span's
# MFU weighs every component against its own peak.


def _cost(flops: float, nbytes: float, dtype) -> dict:
    return {"flops": int(flops), "bytes": int(nbytes),
            "dtype": canon_dtype(dtype)}


def pairwise_l2(n: int, m: int, d: int, dtype="f32") -> dict:
    """Expanded pairwise L2: ||x||^2 + ||y||^2 - 2<x,y> over (n, d) x
    (m, d). Dominant term is the 2nmd matmul; the norm/broadcast adds
    are kept so small shapes cross-check tightly."""
    b = dtype_bytes(dtype)
    flops = 2.0 * n * m * d          # the -2 x @ y.T matmul
    flops += 2.0 * (n + m) * d       # row norms (mul + add per element)
    flops += 3.0 * n * m             # scale + two broadcast adds
    nbytes = (n * d + m * d) * b + n * m * 4.0  # f32 score matrix out
    return _cost(flops, nbytes, dtype)


def select_k(rows: int, cols: int, k: int, fused: bool = False) -> dict:
    """Top-k selection over a (rows, cols) score matrix: one compare per
    candidate (model of a single-pass partial selection) plus the
    per-row heap/sort tail. `fused=True` models the in-kernel partial
    select (ops/fused_scan.py): the candidates are consumed where they
    are produced, so the (rows, cols) score read never hits HBM — only
    the (rows, k) result does. The flops stay (the compares still
    happen in the kernel); the bytes are what fusion deletes."""
    flops = float(rows) * cols + float(rows) * k * max(_log2(cols), 1.0)
    if fused:
        nbytes = float(rows) * k * 8.0
    else:
        nbytes = float(rows) * cols * 4.0 + float(rows) * k * 8.0
    return _cost(flops, nbytes, "f32")


def knn(n: int, nq: int, d: int, k: int, dtype="f32",
        fused: bool = False) -> dict:
    """Exact brute-force kNN = full pairwise L2 + select-k. With
    `fused=True` (the fused scan kernel) neither the score-matrix write
    of the pairwise stage nor the score-matrix read of the select stage
    is charged — the fused geometry the banked MFU must reflect."""
    pw = pairwise_l2(n, nq, d, dtype)
    if fused:
        b = dtype_bytes(dtype)
        pw = _cost(pw["flops"], (n * d + nq * d) * b, dtype)
    return _add(pw, select_k(nq, n, k, fused=fused), dtype=dtype)


def ivf_flat_scan(nq: int, n_probes: int, n_lists: int, n_rows: int,
                  dim: int, k: int, dtype="f32",
                  scanned_lists: Optional[int] = None,
                  fused: bool = False) -> dict:
    """Coarse quantizer + list scan + select. `scanned_lists` is the
    number of lists each query's scores actually stream through: the
    query-major engines touch `n_probes` lists (the default), the
    LIST-MAJOR engines stream every list and mask non-probed scores —
    pass `scanned_lists=n_lists` there, or the model undercounts the
    real work by n_lists/n_probes. `n_rows` should be the PADDED slot
    count (n_lists * max_list) when known — pad slots are scored too.
    `fused=True` (the fused engine) drops the score-matrix
    bytes: the per-chunk scores fold to the candidate buffer on chip
    (the scan's own operand-stream bytes stay — they are the store
    read fusion cannot delete)."""
    rows = _probed_rows(n_rows, n_lists,
                        n_probes if scanned_lists is None else scanned_lists)
    coarse = pairwise_l2(nq, n_lists, dim, dtype)
    scan = _cost(2.0 * nq * rows * dim,
                 nq * rows * dim * dtype_bytes(dtype), dtype)
    return _add(coarse, scan, select_k(nq, rows, k, fused=fused),
                dtype=dtype)


def ivf_pq_scan(nq: int, n_probes: int, n_lists: int, n_rows: int,
                dim: int, pq_dim: int, k: int, dtype="bf16",
                scanned_lists: Optional[int] = None,
                fused: bool = False) -> dict:
    """Coarse quantizer + PQ code scoring (reconstruct-and-dot model of
    the recon engines: one fused multiply-add per reconstructed
    dimension) + select. `scanned_lists`/`n_rows` follow the
    `ivf_flat_scan` convention (list-major engines stream EVERY padded
    list). Bytes are dominated by the per-(query, list) code reads —
    1 byte per pq_dim — which is exactly the wire the quantization
    exists to shrink. `fused=True` (the pallas/fused trims) drops the
    score-matrix bytes from the select stage, like `ivf_flat_scan`."""
    rows = _probed_rows(n_rows, n_lists,
                        n_probes if scanned_lists is None else scanned_lists)
    coarse = pairwise_l2(nq, n_lists, dim, "f32")
    scan = _cost(2.0 * nq * rows * dim, nq * rows * float(pq_dim), dtype)
    return _add(coarse, scan, select_k(nq, rows, k, fused=fused),
                dtype=dtype)


def rabitq_scan(nq: int, n_probes: int, n_lists: int, n_rows: int,
                dim: int, k: int, query_bits: int = 8,
                rerank_mult: int = 0, fused: bool = False) -> dict:
    """Binary-code integer scan: per (query, candidate) one AND+popcount
    per 32-bit word per query bit plane — charged as "int" ops (uint32
    popcount/logical class, its own peak row: these ops never touch
    the tensor cores, so weighing them against a matmul peak would be
    meaningless), plus the exact rerank of rerank_mult*k candidates when
    enabled. `fused=True` (the fused bit-plane kernel) drops the
    score-matrix bytes from the select stage AND the materialized
    bit-plane intersection tensor bytes the unfused engine pays — the
    packed-code stream itself stays (fusion cannot delete the store
    read)."""
    rows = _probed_rows(n_rows, n_lists, n_probes)
    words = (int(dim) + 31) // 32
    bits = max(1, int(query_bits))
    coarse = pairwise_l2(nq, n_lists, dim, "f32")
    # AND + popcount + shift-add per (pair, word, plane): 2 ops modeled,
    # the multiply+add convention applied to the integer unit
    scan_bytes = nq * rows * words * 4.0
    if not fused:
        # the unfused engine materializes the (nq, probes, rows, bits, W)
        # intersection tensor in blocks — charge its dominant write-out
        scan_bytes += nq * rows * bits * words * 4.0
    scan = _cost(2.0 * nq * rows * words * bits, scan_bytes, "int")
    parts = [coarse, scan,
             select_k(nq, rows, max(k, rerank_mult * k or k), fused=fused)]
    if rerank_mult:
        # exact rerank: EVERY query gathers its own distinct
        # rerank_mult*k-row shortlist from the dataset, so the bytes
        # term scales with nq (operands read once per use)
        cand = float(rerank_mult) * k
        parts.append(_cost(2.0 * nq * cand * dim + 3.0 * nq * cand,
                           nq * cand * dim * 4.0 + nq * dim * 4.0, "f32"))
    return _add(*parts, dtype="int")


def refine_rerank(nq: int, n_cand: int, dim: int, k: int, dtype="f32",
                  fused: bool = False) -> dict:
    """Exact re-rank of per-query candidate sets (neighbors/refine):
    every query gathers its own n_cand-row shortlist, one batched
    matvec scores it, select keeps k. `fused=True` (the fused rerank
    kernel) drops the (nq, n_cand) score round-trip from the select
    stage — the gathered candidate stream stays."""
    b = dtype_bytes(dtype)
    flops = 2.0 * nq * n_cand * dim + 3.0 * nq * n_cand
    nbytes = nq * n_cand * dim * b + nq * dim * b
    return _add(_cost(flops, nbytes, dtype),
                select_k(nq, n_cand, k, fused=fused), dtype=dtype)


def kmeans_step(n: int, d: int, n_clusters: int, iters: int = 1,
                dtype="f32") -> dict:
    """One Lloyd iteration: assignment (pairwise L2 vs centers) plus the
    weighted center update (2nd flops)."""
    one = _add(pairwise_l2(n, n_clusters, d, dtype),
               _cost(2.0 * n * d, n * d * dtype_bytes(dtype), dtype),
               dtype=dtype)
    return _cost(one["flops"] * max(1, int(iters)),
                 one["bytes"] * max(1, int(iters)), dtype)


#: per-rank wire-traffic factor by collective op (ring algorithms),
#: RELATIVE TO THE PAYLOAD obs.collective counts for that op — which is
#: the op's per-rank INPUT: the full buffer for allreduce/reducescatter/
#: bcast/barrier, but only the local SHARD for allgather (a ring
#: allgather forwards every other rank's shard through each rank, so
#: its factor is (w-1), not (w-1)/w). Wire-savings claims are judged
#: against exactly these counters.
WIRE_FACTORS: Dict[str, Callable[[int], float]] = {
    "allreduce": lambda w: 2.0 * (w - 1) / w,
    "allgather": lambda w: float(w - 1),
    "reducescatter": lambda w: float(w - 1) / w,
    "bcast": lambda w: float(w - 1) / w,
    "barrier": lambda w: 2.0 * (w - 1) / w,
    "device_sendrecv": lambda w: 1.0,
    "shift": lambda w: 1.0,
    "device_multicast_sendrecv": lambda w: 1.0,
}


def collective_wire_bytes(op: str, nbytes: int, world: int) -> int:
    """Modeled per-rank bytes on the wire for one collective of per-rank
    payload `nbytes` over `world` ranks (0 for world < 2 — a
    single-rank collective moves nothing)."""
    if world is None or world < 2:
        return 0
    factor = WIRE_FACTORS.get(op, lambda w: float(w - 1) / w)
    return int(float(nbytes) * factor(int(world)))


def _probed_rows(n_rows: int, n_lists: int, n_probes) -> float:
    # n_probes may be FRACTIONAL: adaptive probing charges the actual
    # per-query scanned-list mean, not the worst-case integer knob
    per_list = (float(n_rows) / max(1, int(n_lists)))
    return per_list * min(float(n_probes), float(int(n_lists)))


def _log2(x: float) -> float:
    import math

    return math.log2(max(2.0, float(x)))


def _add(*costs: dict, dtype=None) -> dict:
    flops = sum(c["flops"] for c in costs)
    nbytes = sum(c["bytes"] for c in costs)
    by: Dict[str, int] = {}
    for c in costs:
        sub = c.get("flops_by_dtype") or {c["dtype"]: c["flops"]}
        for dt, fl in sub.items():
            if fl:
                by[dt] = by.get(dt, 0) + int(fl)
    out = _cost(flops, nbytes, dtype if dtype is not None
                else costs[0]["dtype"])
    out["flops_by_dtype"] = by
    return out


# -- the per-span registry ---------------------------------------------

#: span name -> formula. Instrumented entry points resolve their span's
#: formula through here (`cost_for`), so "which spans have a cost
#: model" is one reviewable table, and the report can distinguish
#: "span with no model" from "model says zero".
SPAN_COST_MODEL: Dict[str, Callable[..., dict]] = {
    "neighbors.brute_force.knn": knn,
    "neighbors.ivf_flat.search": ivf_flat_scan,
    "neighbors.ivf_pq.search": ivf_pq_scan,
    "neighbors.refine": refine_rerank,
    "neighbors.ivf_rabitq.search": rabitq_scan,
    "mnmg.knn": knn,
    "mnmg.kmeans_fit": kmeans_step,
    "mnmg.ivf_flat_search": ivf_flat_scan,
    "mnmg.ivf_pq_search": ivf_pq_scan,
    "mnmg.ivf_rabitq_search": rabitq_scan,
}


def register(span_name: str, fn: Callable[..., dict]) -> None:
    """Register (or override) the cost formula for a span name."""
    SPAN_COST_MODEL[str(span_name)] = fn


def cost_for(span_name: str, **shape) -> dict:
    """Evaluate the registered formula for `span_name` with the given
    shape kwargs. KeyError for unregistered spans — a typo'd span name
    must fail loudly in the instrumented code path's tests, not
    silently charge nothing."""
    return SPAN_COST_MODEL[span_name](**shape)
