"""The least time of one IVF-Flat search batch.

A batch of B queries over n rows of width d in L lists, each query
probing p lists, k answers each:
  coarse select  2 B L d          float32-accurate (TF32 rate)
  scan           2 (B n p / L) d  bf16 rows (bf16 rate)
Bytes: the queries and centres (f32), the rows of the lists the batch
touches at bf16 (the precision the configuration states for the scan),
and the (B, k) distances and ids out.
"""

from __future__ import annotations

from portbench.roofline import least_time, lists_touched


def work(config: dict, batch: int) -> dict:
    ds, ix, se = config["dataset"], config["index"], config["search"]
    n, d, k = int(ds["rows"]), int(ds["dim"]), int(ds["k"])
    L, p = int(ix["n_lists"]), int(se["n_probes"])
    B = int(batch)
    ops = {"tf32": 2.0 * B * L * d, "bf16": 2.0 * (B * n * p / L) * d}
    bytes_moved = (4.0 * B * d + 4.0 * L * d
                   + lists_touched(L, p, B) * (n / L) * d * 2.0
                   + B * k * 8.0)
    return least_time(ops, bytes_moved)
