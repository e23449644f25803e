"""Distributed k-means (counterpart of raft_tpu/comms/mnmg_kmeans.py):
driver-sharded and process-local (*_local) variants, Lloyd EM with the
per-iteration partial sums allreduced over the comms world (SURVEY §3.4).

Each rank's assignment and partial sums are
`cluster.kmeans_common.assign_and_reduce` over its rows; the k-means++
seeding is the port's `cluster.kmeans._kmeans_plusplus` on a torch
generator (the JAX package seeds it with `jax.random`, so from the same
seed the two packages start from different centers)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import faults
from raft_tpu_torch.comms.comms import Comms, P, ReplicatedArray, _process_index_count
from raft_tpu_torch.cluster.kmeans_common import assign_and_reduce
from raft_tpu_torch.comms.mnmg_common import (
    _cached_wrapper,
    _gather_replicated,
    _local_layout,
    _local_shard_rows_host,
    _pack_local,
    _rows,
    _shard_rows,
    _valid_global_positions,
    _valid_weights,
    rank_captured,
    wrapper_key,
)


def _as_center_tensor(c, device) -> torch.Tensor:
    if isinstance(c, ReplicatedArray):
        c = c.full()
    if isinstance(c, torch.Tensor):
        return c.float().to(device)
    return torch.as_tensor(np.asarray(c, np.float32), device=device)


def _kmeans_fit_sharded(
    comms: Comms,
    xs,
    w,
    centers=None,
    max_iter: int = 100,
    tol: float = 1e-4,
    metric_name: str = "sqeuclidean",
    balance: bool = False,
    seed: int = 0,
    balancing_ratio: float = 4.0,
    n_valid: Optional[int] = None,
    inits=None,
    valid_counts: Optional[np.ndarray] = None,
    quantization: str = "auto",
) -> Tuple[torch.Tensor, float, int]:
    """Lloyd EM over an already-sharded dataset (`xs` sharded on rows, `w`
    row-validity weights, `centers` replicated). `inits` (a sequence of
    initial center sets) runs restart trials and returns the best-inertia
    run; each iteration allreduces the partial sums (float64 partials of
    round-sized row blocks, `_partials`: the JAX package sums f32 per
    rank). Returns (centers, inertia, n_iter).

    With `balance`, undersized clusters (global count below
    n/k/balancing_ratio) are re-seeded toward a random valid row each
    iteration (kmeans_balanced's adjust_centers, distributed): each
    cluster's proposal row comes from one data-holding rank and is shared
    by a SUM, so the centers stay the same on every rank; two clean EM
    steps follow. The proposal draws come from a torch generator seeded
    with `seed` on the host, the same on every rank (the JAX package draws
    them with `jax.random`).

    For inner_product / cosine the centers are re-normalized each
    iteration: with unit-norm centers the L2 argmin of assign_and_reduce
    is the argmax-dot assignment."""
    from raft_tpu_torch.comms import quantized

    # resolved once a fit; only the O(k*d) partial-sum plane is quantized
    # (counts gate the empty-cluster guard and stay exact)
    qcfg = quantized.resolve(quantization, comms.device)
    ip = metric_name in ("inner_product", "cosine")
    r = comms.get_size()
    k = int((centers if centers is not None else inits[0]).shape[0])
    owners = None
    threshold = 0.0
    if balance:
        if n_valid is None:
            raise ValueError("balance=True requires n_valid (host-known rows)")
        per = xs.shape[0] // r
        # per-rank valid row counts are host knowledge (valid rows are a
        # prefix of each shard): exact at any scale
        if valid_counts is None:
            valid_counts = np.clip(n_valid - per * np.arange(r, dtype=np.int64), 0, per)
        valid_counts = np.asarray(valid_counts, np.int64)
        # proposals come from the data-holding ranks only
        holders = np.flatnonzero(valid_counts > 0)
        if holders.size == 0:
            holders = np.asarray([0], np.int64)
        owners = tuple(int(o) for o in holders[np.arange(k) % holders.size])
        threshold = float(n_valid) / k / balancing_ratio
        valid_counts = tuple(int(v) for v in valid_counts)

    def _norm(c):
        return c / torch.clamp(torch.linalg.norm(c, dim=1, keepdim=True), min=1e-12)

    block = _aligned_block(k, int(xs.shape[1]))
    per_rank = xs.shape[0] // r

    def body(ac, xs, w, centers, props, adjust):
        rank = ac.get_rank()
        sums, counts, inertia = _partials(xs, centers, w, rank * per_rank, block)
        # chaos site: a poisoned shard's EM contribution, before the SUM
        sums = faults.corrupt_in_trace("mnmg.kmeans.partials", sums, rank)
        sums = ac.allreduce(sums, quantization=qcfg)
        counts = ac.allreduce(counts)
        inertia = ac.allreduce(inertia)
        safe = torch.clamp(counts, min=1.0)[:, None]
        new_centers = torch.where(counts[:, None] > 0, (sums / safe).float(), centers)
        counts = counts.float()
        if adjust:
            valid = max(int(valid_counts[rank]), 1)
            idx = props % valid
            mine = torch.as_tensor([o == rank for o in owners], device=xs.device)
            local = torch.where(mine[:, None], xs[idx].float(), torch.zeros((), device=xs.device))
            proposals = ac.allreduce(local)
            small = counts < threshold
            wc = torch.clamp(counts, max=7.0)[:, None]
            adjusted = (wc * new_centers + proposals) / (wc + 1.0)
            new_centers = torch.where(small[:, None], adjusted, new_centers)
        if ip:
            new_centers = _norm(new_centers)
        shift = torch.sum((new_centers - centers) ** 2)
        return new_centers, inertia, shift

    def step(centers, props, adjust: bool):
        return comms.run(body, xs, w, centers, props, adjust,
                         in_specs=(P(comms.axis, None), P(comms.axis), P(None, None), P(None),
                                   P()),
                         out_specs=(P(None, None), P(), P()))

    pi = _process_index_count()[0]

    def run_one(centers):
        inertia = float("inf")
        it = 0
        gen = torch.Generator().manual_seed(int(seed))
        props = torch.zeros(k, dtype=torch.int64)
        for it in range(1, max_iter + 1):
            # slow / flaky drills; rank-scoped faults hit one process
            faults.fault_point("mnmg.kmeans.step", rank=pi)
            if balance:
                props = torch.randint(0, 1 << 30, (k,), generator=gen)
            centers, inertia, shift = step(centers, props, balance)
            if not balance and float(shift) < tol * tol:
                break
        if balance:  # trailing clean EM (plain Lloyd updates)
            for _ in range(2):
                centers, inertia, _ = step(centers, props, False)
        return centers, float(inertia), it

    dev = comms.device
    if inits is None:
        c0 = _as_center_tensor(centers, dev)
        return run_one(_norm(c0) if ip else c0)
    best = None
    for c0 in inits:
        c0 = _as_center_tensor(c0, dev)
        out = run_one(_norm(c0) if ip else c0)
        if best is None or out[1] < best[1]:
            best = out
    return best


#: elements of a partial-sum block's (rows, k + d) work: 2^26 is 64M (a
#: 256 MiB f32 distance tile at most), ~50,000 rows at k 1,024. Each rank
#: of an in-process world launches from its own thread, and launches from
#: several threads contend on the host, so the blocks are large.
BLOCK_BUDGET_ELEMS = 1 << 26


def _aligned_block(k: int, d: int) -> int:
    """The rows of one partial-sum block: the largest 1, 2 or 5 x 10^e
    within BLOCK_BUDGET_ELEMS / (k + d), so each block is one assignment
    GEMM and blocks of round size line up with the shards of most
    worlds."""
    budget = max(1, BLOCK_BUDGET_ELEMS // (k + d))
    return next(m * 10 ** e for e in range(12, -1, -1) for m in (5, 2, 1)
                if m * 10 ** e <= budget)


def _partials(xs, centers, w, base: int, block: int):
    """(sums, counts, inertia) of a rank's rows, float64: one
    `assign_and_reduce` a block of rows that starts at a multiple of
    `block` in the global row order (`base` is the rank's first row), each
    block's f32 partials accumulated in float64. A block then sees the
    same rows, shapes and centers in every world whose shards begin at a
    multiple of `block`, so its labels and partials are the same bits, and
    the float64 sums round to the same f32 centers almost always: the
    answer hardly depends on the world size (an f32 sum in another order
    moves near-tie rows to other clusters, and k-means iterations amplify
    that)."""
    n = xs.shape[0]
    sums = torch.zeros(tuple(centers.shape), dtype=torch.float64, device=xs.device)
    counts = torch.zeros((centers.shape[0],), dtype=torch.float64, device=xs.device)
    inertia = torch.zeros((), dtype=torch.float64, device=xs.device)
    s = 0
    while s < n:
        e = min(n, ((base + s) // block + 1) * block - base)
        _, bs, bc, bi = assign_and_reduce(xs[s:e], centers, w[s:e],
                                          budget_elems=BLOCK_BUDGET_ELEMS)
        sums += bs.double()
        counts += bc.double()
        inertia += bi.double()
        s = e
    return sums, counts, inertia


def _plusplus_init(sub: torch.Tensor, n_clusters: int, seed: int) -> torch.Tensor:
    from raft_tpu_torch.cluster.kmeans import _kmeans_plusplus
    from raft_tpu_torch.random.rng import make_generator

    return _kmeans_plusplus(make_generator(seed, sub.device), sub, n_clusters)


@rank_captured("mnmg.kmeans_fit")
@obs.spanned("mnmg.kmeans_fit")
def kmeans_fit(
    comms: Comms,
    X,
    n_clusters: int,
    max_iter: int = 100,
    tol: float = 1e-4,
    seed: int = 0,
    n_init: int = 1,
    quantization: str = "auto",
) -> Tuple[torch.Tensor, float, int]:
    """Distributed Lloyd: shard rows, allreduce the partial sums each
    iteration (SURVEY §3.4 MNMG variant). Returns (centers, inertia,
    n_iter). `n_init` restarts from k-means++ seeds `seed + t` (on a
    numpy sub-sample, the JAX package's draw) keep the best-inertia run.
    `quantization` selects the partial-sum allreduce's transport
    (comms/quantized): "off" is the exact fit; "auto" stays exact until a
    tuned `comms_quant_mode` governs the ranks' device."""
    x = _rows(X)
    xs, n, per = _shard_rows(comms, x)
    w = comms.shard(_valid_weights(n, per, comms.get_size()), axis=0)
    inits = []
    for t in range(max(1, n_init)):
        rng = np.random.default_rng(seed + t)
        sel = rng.choice(n, min(n, max(n_clusters * 8, 1024)), replace=False)
        sub = x[torch.as_tensor(sel, device=x.device)].to(comms.device)
        inits.append(comms.replicate(_plusplus_init(sub, n_clusters, seed + t)))
    centers, inertia, n_iter = _kmeans_fit_sharded(
        comms, xs, w, max_iter=max_iter, tol=tol, inits=inits, quantization=quantization)
    if obs.enabled():
        obs.span_cost(**obs.perf.cost_for(
            "mnmg.kmeans_fit", n=n, d=int(x.shape[1]), n_clusters=n_clusters,
            iters=int(n_iter)))
    return centers, inertia, n_iter


def kmeans_fit_local(
    comms: Comms,
    local_X,
    n_clusters: int,
    max_iter: int = 100,
    tol: float = 1e-4,
    seed: int = 0,
    n_init: int = 1,
    quantization: str = "auto",
) -> Tuple[torch.Tensor, float, int]:
    """Distributed Lloyd where each process passes its own partition
    (collective: every process calls with the same arguments apart from
    local_X). Returns (centers, global inertia, n_iter). In one process it
    matches kmeans_fit on the concatenated rows."""
    local = _rows(local_X)
    counts, per, lranks = _local_layout(comms, local.shape[0])
    xp, wl = _pack_local(local, per, lranks)
    xs = comms.shard_from_local(xp, axis=0)
    w = comms.shard_from_local(wl, axis=0)
    n = int(counts.sum())
    if n_clusters > n:
        raise ValueError(f"n_clusters={n_clusters} > total rows {n}")
    # init: k-means++ on a deterministic global sub-sample, the same on
    # every process (same seed, same gathered rows)
    gpos = _valid_global_positions(comms, counts, per)
    subsample = min(n, max(n_clusters * 8, 1024))
    inits = []
    for t in range(max(1, n_init)):
        rng = np.random.default_rng(seed + t)
        sel = gpos[rng.choice(n, subsample, replace=False)]
        sub = torch.as_tensor(_gather_replicated(comms, xs, sel), device=comms.device)
        inits.append(comms.replicate(_plusplus_init(sub, n_clusters, seed + t)))
    return _kmeans_fit_sharded(comms, xs, w, max_iter=max_iter, tol=tol, inits=inits,
                               quantization=quantization)


def kmeans_predict_local(comms: Comms, local_X, centers) -> np.ndarray:
    """Nearest-center labels (int32) for this process's own rows
    (collective)."""
    local = _rows(local_X)
    counts, per, lranks = _local_layout(comms, local.shape[0])
    xp, _ = _pack_local(local, per, lranks)
    xs = comms.shard_from_local(xp, axis=0)
    labels = _spmd_predict(comms, xs, centers)
    return _local_shard_rows_host(comms, labels)[: local.shape[0]]


def _spmd_predict(comms: Comms, xs, centers) -> torch.Tensor:
    """Nearest-center labels over an already-sharded dataset (pad rows
    included; callers slice to [:n])."""

    def build():
        def body(ac, xs, c):
            labels, _, _, _ = assign_and_reduce(xs, c, needs_sums=False)
            return labels.to(torch.int32)

        def run(xs, c):
            return comms.run(body, xs, c, in_specs=(P(comms.axis, None), P(None, None)),
                             out_specs=P(comms.axis))

        return run

    run = _cached_wrapper(wrapper_key("spmd_predict", comms), build)
    c = centers if isinstance(centers, ReplicatedArray) else comms.replicate(
        centers.float() if isinstance(centers, torch.Tensor) else np.asarray(centers, np.float32))
    return run(xs, c)


def kmeans_predict(comms: Comms, X, centers) -> torch.Tensor:
    """Distributed assignment; the global (n,) int32 labels in row order."""
    xs, n, per = _shard_rows(comms, X)
    return _spmd_predict(comms, xs, centers)[:n]
