"""Work counts of the rooflines: the least time a piece of work needs on
the card, from a cell's parameters and its dataset's shapes alone.

A count never reads launch shapes, padding, engines or kernel names, so
it reads the same work whatever implements it. Each input byte is read
once and each output byte written once. Each operation is charged at the
fastest published peak a faithful implementation could use (`peaks.json`),
so that none reads over 100%: float32-accurate distances at the TF32 rate
(split TF32 runs on it), 8-bit codes at the int8 rate, bf16 rows at the
bf16 rate. The least time is the larger of the byte bound and the sum of
the operation bounds; `binds` says which.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).resolve().parent / "peaks.json").read_text())


def least_time(ops: dict, bytes_moved: float, peaks: dict = PEAKS) -> dict:
    """ops: {rate name: operations}; returns {"seconds", "binds",
    "ops_s", "bytes_s", "ops", "bytes"}."""
    ops_s = sum(float(n) / float(peaks["ops_per_s"][rate]) for rate, n in ops.items())
    bytes_s = float(bytes_moved) / float(peaks["hbm_bytes_per_s"])
    return {"seconds": max(ops_s, bytes_s), "binds": "bytes" if bytes_s >= ops_s else "ops",
            "ops_s": ops_s, "bytes_s": bytes_s, "ops": dict(ops), "bytes": float(bytes_moved)}


def lists_touched(n_lists: int, n_probes: int, batch: int) -> float:
    """Expected lists that `batch` queries probe, `n_probes` each, where
    each query probes each list with chance n_probes / n_lists (balanced
    lists, queries drawn like the rows)."""
    return n_lists * (1.0 - (1.0 - n_probes / n_lists) ** batch)
