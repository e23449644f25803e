"""The inputs of a cell, made on the device.

The public vectors of a configuration's dataset are not in the checkout,
so a mixture of Gaussian blobs stands in for them, at the dataset's
shape and scale: `blobs` centres drawn uniformly from
[-center_half_width, center_half_width]^dim, each row a centre plus
N(0, noise_std^2) noise. With more blobs than lists and noise as wide as
the centres' spread, a query's true neighbours fall in more than one
list. The centres and rows come from the configuration's `rows_seed`, so
every run serves the same table, as a deployment serves its dataset, and
the queries from its `queries_seed`, drawn from the same mixture, so every
run sends the same query set, as the dataset's fixed query set is sent;
`--seed` draws the order in which they are sent. A table or a query set
drawn anew each run moved a batch's work with the lists it probed: the
seeds then spread the time, and most of all the tail, several times wider
than two runs of one seed did. The same seed gives the same rows and
queries, in the same order, on the same card.
"""

from __future__ import annotations

import torch

#: rows drawn a call: a few large calls, and no 2x peak over the table
CHUNK_ROWS = 1 << 21


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(seed) % (1 << 63))
    return g


def _draw(gen, centers, n, noise_std, out=None):
    dim = centers.shape[1]
    out = torch.empty((n, dim), dtype=torch.float32, device=centers.device) if out is None else out
    for s in range(0, n, CHUNK_ROWS):
        e = min(n, s + CHUNK_ROWS)
        which = torch.randint(0, centers.shape[0], (e - s,), generator=gen,
                              device=centers.device)
        torch.randn((e - s, dim), generator=gen, device=centers.device, out=out[s:e])
        out[s:e].mul_(noise_std).add_(centers[which])
    return out


def make_inputs(config: dict, seed: int, device, rows_seed=None, queries_seed=None):
    """(rows (n, dim) f32, queries (nq, dim) f32) of `config` on `device`,
    the queries in the order `seed` draws; `rows_seed` or `queries_seed`
    in place of the configuration's draws another table or query set."""
    ds, gp = config["dataset"], config["generator"]
    if gp["kind"] != "blobs":
        raise ValueError(f"unknown generator kind {gp['kind']!r}")
    dev = torch.device(device)
    gen = generator(gp["rows_seed"] if rows_seed is None else rows_seed, dev)
    half = float(gp["center_half_width"])
    centers = (torch.rand((int(gp["blobs"]), int(ds["dim"])), generator=gen, device=dev)
               * 2.0 - 1.0) * half
    rows = _draw(gen, centers, int(ds["rows"]), float(gp["noise_std"]))
    qseed = gp["queries_seed"] if queries_seed is None else queries_seed
    queries = _draw(generator(qseed, dev), centers, int(ds["queries"]), float(gp["noise_std"]))
    order = torch.randperm(queries.shape[0], generator=generator(seed, dev), device=dev)
    return rows, queries[order]
