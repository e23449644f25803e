"""The least time of one IVF-PQ search batch with its exact rerank.

A batch of B queries over n rows of width d in L lists, each query
probing p lists and keeping a shortlist of s for the rerank to k:
  coarse select  2 B L d           float32-accurate (TF32 rate)
  query rotation 2 B d r           float32-accurate (TF32 rate), r the
                                   rotated width pq_dim * ceil(d / pq_dim)
  scan           2 (B n p / L) r   8-bit reconstructions (int8 rate)
  rerank         2 B s d           bf16 rows (bf16 rate)
Bytes: the queries, rotation and centres (f32), the codebooks (f32),
the codes of the lists the batch touches (pq_dim * pq_bits / 8 a row),
the shortlist's ids and bf16 rows, and the (B, k) distances and ids out.
"""

from __future__ import annotations

import math

from portbench.roofline import least_time, lists_touched


def work(config: dict, batch: int) -> dict:
    ds, ix, se = config["dataset"], config["index"], config["search"]
    n, d, k = int(ds["rows"]), int(ds["dim"]), int(ds["k"])
    L, p, s = int(ix["n_lists"]), int(se["n_probes"]), int(se["shortlist"])
    pq_dim, bits = int(ix["pq_dim"]), int(ix["pq_bits"])
    r = pq_dim * math.ceil(d / pq_dim)
    B = int(batch)
    ops = {"tf32": 2.0 * B * L * d + 2.0 * B * d * r,
           "int8": 2.0 * (B * n * p / L) * r,
           "bf16": 2.0 * B * s * d}
    rows_touched = lists_touched(L, p, B) * n / L
    bytes_moved = (4.0 * B * d + 4.0 * r * d + 4.0 * L * r
                   + 4.0 * (2 ** bits) * r
                   + rows_touched * pq_dim * bits / 8.0
                   + B * s * (4.0 + 2.0 * d)
                   + B * k * 8.0)
    return least_time(ops, bytes_moved)
