"""The least time of one IVF-PQ build.

n rows of width d, L lists, rotated width r = pq_dim * ceil(d / pq_dim),
k-means of `kmeans_n_iters` iterations on a trainset of
max(4 L, fraction * n) rows (at most n). Balanced k-means trains in two
levels past 1024 lists (RAFT's kmeans_balanced): floor(sqrt(L))
mesoclusters, then ceil(L / floor(sqrt(L))) fine clusters in each, so an
iteration scores each training row against both levels' centres.
  rotation       2 n d r                       float32-accurate (TF32)
  k-means        iters * 2 n_train r C         float32-accurate (TF32),
                 C = L, or the two levels' centres past 1024 lists
  labels         2 n L r                       float32-accurate (TF32)
  encoding       2 n r 2^pq_bits               float32-accurate (TF32)
The codebooks' own training (a capped sample of residuals) is left out:
it is under 1% of these. Bytes: the rows read once (f32), the codes
and ids written once.
"""

from __future__ import annotations

import math

from portbench.roofline import least_time


def work(config: dict) -> dict:
    ds, ix = config["dataset"], config["index"]
    n, d = int(ds["rows"]), int(ds["dim"])
    L, pq_dim, bits = int(ix["n_lists"]), int(ix["pq_dim"]), int(ix["pq_bits"])
    iters, frac = int(ix["kmeans_n_iters"]), float(ix["kmeans_trainset_fraction"])
    r = pq_dim * math.ceil(d / pq_dim)
    n_train = min(n, max(4 * L, int(n * frac)))
    if L > 1024:
        meso = int(math.sqrt(L))
        centres = meso + math.ceil(L / meso)
    else:
        centres = L
    ops = {"tf32": (2.0 * n * d * r + iters * 2.0 * n_train * r * centres
                    + 2.0 * n * L * r + 2.0 * n * r * (2 ** bits))}
    bytes_moved = 4.0 * n * d + n * pq_dim * bits / 8.0 + 4.0 * n
    return least_time(ops, bytes_moved)
