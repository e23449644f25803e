"""How `correct` is decided: the answers the timed path returned, judged
against the plain reference once the window has closed.

Numbers compared (each with its limit from the configuration's "checks"):
  recall     recall@k of every answer against the exact neighbours,
             at least the configuration's recall limit;
  dist_gap   the widest gap between a returned distance and the exact
             float64 distance of the id it was returned with, as a share
             of the query's k-th exact distance;
  bad_rows   answers with a missing row, an id out of range or an id
             twice (limit 0);
  index_ids  (build mixes) ids that the last built index lacks or holds
             twice (limit 0);
  digests    (build mixes) list rows of the last built index whose
             integrity digest is missing or is not the CRC-32C of the
             row's bytes (limit 0).
"""

from __future__ import annotations

import torch

from portbench.reference.crc32c import crc32c_rows
from portbench.reference.exact_knn import pair_distances

#: the direction of each number's limit
NEED = {"recall": ">=", "dist_gap": "<=", "bad_rows": "<=", "index_ids": "<=", "digests": "<="}


def _bad_rows(ids: torch.Tensor, n: int) -> torch.Tensor:
    out_of_range = ((ids < 0) | (ids >= n)).any(1)
    s = torch.sort(ids, dim=1).values
    twice = (s[:, 1:] == s[:, :-1]).any(1)
    return out_of_range | twice


def judge_answers(rows, queries, answers, k: int, truth_d, truth_i) -> dict:
    """answers: [(query positions (b,), distances (b, k), ids (b, k))] on
    the host; truth_*: the reference's (nq, k) on the device."""
    dev = rows.device
    n = rows.shape[0]
    hits = total = bad = 0
    gap = 0.0
    for pos, d, i in answers:
        pos = pos.to(dev)
        b = pos.shape[0]
        if tuple(d.shape) != (b, k) or tuple(i.shape) != (b, k):
            bad += b
            total += b * k
            continue
        iv = i.to(dev).long()
        bad_row = _bad_rows(iv, n)
        bad += int(bad_row.sum())
        hits += int((iv[:, :, None] == truth_i[pos][:, None, :]).any(2).sum())
        total += b * k
        exact = pair_distances(rows, queries[pos], iv)
        scale = truth_d[pos, k - 1:k].clamp(min=torch.finfo(torch.float64).tiny)
        g = ((d.to(dev).double() - exact).abs() / scale)[~bad_row]
        if g.numel():
            gap = max(gap, float(torch.nan_to_num(g, nan=float("inf")).max()))
    return {"recall": hits / max(1, total), "dist_gap": gap, "bad_rows": bad}


def index_id_faults(ids: torch.Tensor, n: int) -> int:
    """Ids of 0..n-1 that `ids` (one per filled slot) lacks, plus ids it
    holds twice or out of range."""
    ids = ids.long()
    inside = ids[(ids >= 0) & (ids < n)]
    distinct = int(torch.unique(inside).numel())
    return (n - distinct) + (int(ids.numel()) - distinct)


def digest_faults(fields) -> int:
    """Rows of [(field, table (n_lists, ...), digests (n_lists,) or None)]
    whose digest is missing or differs from the reference CRC-32C."""
    bad = 0
    for _, table, digests in fields:
        if digests is None or len(digests) != table.shape[0]:
            bad += table.shape[0]
            continue
        bad += int((crc32c_rows(table) != digests.astype("uint32")).sum())
    return bad


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit", "need", "ok"}}) for every number
    that has a limit; a number without one fails the run."""
    out, ok_all = {}, True
    for name, value in numbers.items():
        if name not in limits:
            raise KeyError(f"no limit for {name!r} in the configuration's checks")
        lim = float(limits[name]["limit"])
        need = NEED[name]
        ok = value >= lim if need == ">=" else value <= lim
        ok_all &= bool(ok)
        out[name] = {"value": value, "limit": lim, "need": need, "ok": bool(ok)}
    return ok_all, out
