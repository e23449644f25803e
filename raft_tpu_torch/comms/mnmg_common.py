"""Shared MNMG plumbing (counterpart of raft_tpu/comms/mnmg_common.py):
sharding layouts, prefilter bit-packing, the cache of built per-rank
bodies, the degraded-mode helpers, the PQ helpers of the distributed IVF
builds, and the per-rank obs capture hook the distributed trace merge
reads."""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.comms.comms import (Comms, P, ReplicatedArray, ShardedArray,
                                       _process_index_count)
from raft_tpu_torch.distance.distance_types import DistanceType

#: env var naming a directory: when set (and obs is enabled), every MNMG
#: driver entry point writes this process's span/event capture to
#: `<dir>/obs_rank<NNN>.json` on the way out, the per-rank files
#: `python -m raft_tpu_torch.obs.report --merge` aligns into one timeline.
#: A process world gives one file a process; the in-process world gives
#: the driver's view.
RANK_SNAPSHOT_ENV = "RAFT_TPU_OBS_RANK_DIR"


def rank_captured(label: str):
    """Decorator form of `maybe_save_rank_snapshot` for the MNMG driver
    entry points: after the wrapped driver returns (its `@obs.spanned`
    span closed), write this process's obs state to the per-rank file.
    Stack it outside `@obs.spanned`. The first argument is a Comms
    session or carries one as `.comms`."""
    def deco(f):
        @functools.wraps(f)
        def wrapper(*args, **kwargs):
            out = f(*args, **kwargs)
            if obs.enabled():
                first = (args[0] if args
                         else kwargs.get("comms", kwargs.get("index")))
                comms = (first if isinstance(first, Comms)
                         else getattr(first, "comms", None))
                if isinstance(comms, Comms):
                    maybe_save_rank_snapshot(comms, label)
            return out

        return wrapper

    return deco


def maybe_save_rank_snapshot(comms: Comms, label: str):
    """Env-gated per-rank obs capture (RANK_SNAPSHOT_ENV). Returns the
    path written, or None when the gate is off. Never raises: a full disk
    must not fail the search that just completed."""
    out_dir = os.environ.get(RANK_SNAPSHOT_ENV, "").strip()
    if not out_dir or not obs.enabled():
        return None
    try:
        rank, n_proc = _process_index_count()
        world = n_proc if n_proc > 1 else comms.get_size()
        path = os.path.join(out_dir, f"obs_rank{rank:03d}.json")
        obs.save_snapshot(path, rank=rank, world=world, label=label)
        return path
    except Exception:
        return None


def _metric_name(metric) -> str:
    """Coarse-trainer metric for an ANN index metric (shared by every
    distributed build)."""
    return "inner_product" if metric == DistanceType.InnerProduct else "sqeuclidean"


def _pq_geometry(params, d: int):
    """(pq_dim, pq_len, rot_dim) for a dataset dim: one derivation for the
    driver and *_local PQ builds."""
    from raft_tpu_torch.neighbors import ivf_pq as ivf_pq_mod

    pq_dim = params.pq_dim or ivf_pq_mod._auto_pq_dim(d)
    pq_len = -(-d // pq_dim)
    return pq_dim, pq_len, pq_dim * pq_len


def _rotate_fn(comms: Comms):
    """The sharded rotation a @ R.T over a row-sharded `a` and a
    replicated R; the result stays row-sharded (per-rank blocks)."""

    def body(ac, a, R):
        return a @ R.T

    def run(a, R):
        return comms.run(body, a, R, in_specs=(P(comms.axis, None), P(None, None)),
                         out_specs=P(comms.axis, None), keep_blocks=True)

    return run


def _codebook_cap(params, n_lists: int) -> int:
    """Residual-sample cap for codebook EM (the single-device build's)."""
    from raft_tpu_torch.neighbors import ivf_pq as ivf_pq_mod

    nb = 1 << params.pq_bits
    cap = max(65536, 64 * nb)
    if params.codebook_kind == ivf_pq_mod.PER_CLUSTER:
        cap = max(cap, 256 * n_lists)
    return cap


def _train_codebooks(params, gen, residuals, cb_labels, n_lists: int,
                     pq_dim: int, pq_len: int):
    """Codebook EM on a residual sample through the shared quantizer layer
    (the single-device build's trainer)."""
    from raft_tpu_torch.neighbors.quantizer import PqQuantizer

    quant = PqQuantizer(
        codebook_kind=params.codebook_kind, pq_bits=params.pq_bits,
        pq_dim=pq_dim, pq_len=pq_len, n_lists=n_lists,
    )
    return quant.train(gen, residuals, cb_labels).pq_centers


def _ranks_by_proc(comms: Comms) -> dict:
    """process index -> sorted rank positions. The *_local layout rests on
    every helper using this one ordering: the in-process world is one
    process holding every rank; a process world, one rank a process."""
    if comms.process_world:
        return {p: [p] for p in range(comms.get_size())}
    return {0: list(range(comms.get_size()))}


def _rows(x):
    """A dataset as float32 rows: a tensor stays on its device, host data
    becomes a CPU tensor (the shards then move rank by rank)."""
    if isinstance(x, torch.Tensor):
        return x.float()
    a = np.ascontiguousarray(np.asarray(x, np.float32))
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def _pad_rows(x: torch.Tensor, total: int) -> torch.Tensor:
    pad = total - x.shape[0]
    if not pad:
        return x
    return torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))])


def _shard_rows(comms: Comms, x):
    """Pad rows to a multiple of the rank count and shard; returns
    (sharded, n, rows a rank)."""
    x = _rows(x)
    n = x.shape[0]
    r = comms.get_size()
    per = -(-n // r)
    return comms.shard(_pad_rows(x, per * r), axis=0), n, per


def _valid_weights(n: int, per: int, r: int) -> np.ndarray:
    w = np.zeros(per * r, np.float32)
    w[:n] = 1.0
    return w


def _pad_queries(q, world: int):
    """Pad nq up to a multiple of the comm size (the sharded merge splits
    the query axis evenly); callers slice the result back to nq rows."""
    nq = q.shape[0]
    pad = (-nq) % world
    if pad:
        q = torch.cat([q, q.new_zeros((pad, q.shape[1]))])
    return q, nq


def _local_layout(comms: Comms, n_local: int):
    """Collective: gather every process's local row count and derive the
    uniform per-rank shard size. Returns (counts (nproc,), per, lranks);
    every process pads its rows to lranks * per."""
    lranks = len(comms.local_ranks())
    if comms.process_world and comms.get_size() > 1:
        import torch.distributed as dist

        mine = torch.tensor([int(n_local)], dtype=torch.int64, device=comms.device)
        parts = [torch.empty_like(mine) for _ in range(comms.get_size())]
        dist.all_gather(parts, mine)
        counts = np.asarray([int(p.item()) for p in parts], np.int64)
    else:
        counts = np.asarray([n_local], np.int64)
    per = max(1, -(-int(counts.max()) // lranks))
    return counts, per, lranks


def _valid_global_positions(comms: Comms, counts: np.ndarray, per: int) -> np.ndarray:
    """Global row positions of every valid row in the padded sharded
    layout, walking the ranks of each process."""
    ranks_by_proc = _ranks_by_proc(comms)
    parts = []
    for p, cnt in enumerate(np.asarray(counts, np.int64)):
        rp = np.asarray(ranks_by_proc.get(p, []), np.int64)
        li = np.arange(int(cnt), dtype=np.int64)
        parts.append(rp[li // per] * per + (li % per))
    return np.concatenate(parts) if parts else np.zeros((0,), np.int64)


def _pack_local(local, per: int, lranks: int):
    """Pad this process's rows to its lranks * per block; returns (padded
    rows, validity weights)."""
    x = _rows(local)
    block = lranks * per
    wl = np.zeros(block, np.float32)
    wl[: x.shape[0]] = 1.0
    return _pad_rows(x, block), wl


def _gather_replicated(comms: Comms, xs: ShardedArray, positions: np.ndarray) -> np.ndarray:
    """Rows `positions` of a row-sharded array, on every process, as host
    numpy: each rank contributes the rows it holds and the gather picks
    each row from its owner (bit for bit; no arithmetic touches the rows)."""
    per = xs.shape[0] // comms.get_size()
    pos = np.asarray(positions, np.int64)
    owner = pos // per

    def body(ac, x):
        rank = ac.get_rank()
        mine = np.flatnonzero(owner == rank)
        local = x.new_zeros((pos.shape[0],) + tuple(x.shape[1:]))
        if mine.size:
            idx = torch.as_tensor(pos[mine] - rank * per, device=x.device)
            local[torch.as_tensor(mine, device=x.device)] = x[idx]
        g = ac._all_gather(local)  # (R, m, ...)
        return g[torch.as_tensor(owner, device=x.device),
                 torch.arange(pos.shape[0], device=x.device)]

    out = comms.run(body, xs, in_specs=P(comms.axis, None), out_specs=P())
    return out.cpu().numpy()


def _distributed_id_bound(index) -> int:
    """One past the largest gid of a distributed index: n for normal
    builds; for bridged indexes (caller ids) the actual max."""
    if not getattr(index, "bridged", False):
        return int(index.n)
    if index.host_gids is not None:
        hg = np.asarray(index.host_gids)
        return int(hg.max()) + 1 if hg.size else 0
    gids = index.slot_gids
    gids = gids.full() if isinstance(gids, (ShardedArray, ReplicatedArray)) else gids
    return int(torch.max(gids)) + 1


def _pack_mask_words(mask_padded: np.ndarray) -> np.ndarray:
    """(R, per) bool -> (R, W) int32 per-rank bitset rows (the port's
    Bitset word type; the bits of the JAX package's uint32 words). Each
    row pads to whole 32-bit words, so the shard-local `Bitset(bits[0],
    per)` rebuild reads it directly."""
    from raft_tpu_torch.core.bitset import Bitset

    R, per = mask_padded.shape
    W = (per + 31) // 32
    pad = W * 32 - per
    mp = np.pad(mask_padded, ((0, 0), (0, pad))) if pad else mask_padded
    return Bitset.from_mask(torch.from_numpy(np.ascontiguousarray(mp.reshape(-1)))
                            ).bits.numpy().reshape(R, W)


def _pad_global_mask(mask: np.ndarray, rank_base, valid_counts, per: int) -> np.ndarray:
    """Scatter a global keep-mask into the padded (R, per) shard layout
    (pad rows stay False)."""
    R = len(rank_base)
    out = np.zeros((R, per), bool)
    for j in range(R):
        v, b = int(valid_counts[j]), int(rank_base[j])
        if v:
            out[j, :v] = mask[b: b + v]
    return out


def _knn_prefilter_words(prefilter, n: int, rank_base, valid_counts, per: int):
    """Coerce a knn prefilter (global ids 0..n-1) into per-rank packed
    bitset rows, or None."""
    if prefilter is None:
        return None
    from raft_tpu_torch.core.bitset import Bitset

    if isinstance(prefilter, Bitset):
        if prefilter.n != n:
            raise ValueError(f"prefilter covers {prefilter.n} ids but the index has {n}")
        mask = prefilter.to_mask().cpu().numpy()
    else:
        mask = (prefilter.cpu().numpy() if isinstance(prefilter, torch.Tensor)
                else np.asarray(prefilter))
        if mask.dtype != np.bool_ or mask.ndim != 1:
            raise ValueError(
                "prefilter must be a Bitset or a 1-D boolean mask, got "
                f"{mask.dtype} ndim={mask.ndim}"
            )
        if mask.shape[0] != n:
            raise ValueError(
                f"prefilter mask has {mask.shape[0]} entries but the index has {n}")
    return _pack_mask_words(_pad_global_mask(mask, rank_base, valid_counts, per))


# Per-process cache of the built per-rank bodies of the serving entry
# points. The JAX package caches jitted shard_map wrappers here (a fresh
# trace a call cost seconds); the port has no trace and keeps the cache,
# its name and its key, so the drivers build each body once. The key
# covers every non-array closure input that shapes the body; bounded
# (distinct mode / engine / geometry combinations are few in practice).
_JIT_WRAPPER_CACHE: dict = {}


def wrapper_key(tag, comms, *parts):
    """The one construction of a body-cache key: the site tag, the world's
    geometry (its devices and axis: two sessions on different worlds
    never share a body), then every non-array closure input."""
    return (tag, comms.mesh, comms.axis) + parts


def _cached_wrapper(key, build):
    from raft_tpu_torch.core import faults

    # the installed FaultPlan's fingerprint joins every key, as in the
    # JAX package (None without a plan)
    key = (key, faults.trace_key())
    f = _JIT_WRAPPER_CACHE.pop(key, None)
    if f is None:
        while len(_JIT_WRAPPER_CACHE) >= 64:
            # evict the least recently used entry (insertion order; the
            # pop / re-insert refreshes recency)
            _JIT_WRAPPER_CACHE.pop(next(iter(_JIT_WRAPPER_CACHE)))
        f = build()
    _JIT_WRAPPER_CACHE[key] = f
    return f


def _rank_valid_counts(comms: Comms, counts: np.ndarray, per: int) -> np.ndarray:
    """Per-rank valid row counts for the *_local padded layout."""
    return _rank_layout(comms, counts, per)[1]


def _rank_layout(comms: Comms, counts: np.ndarray, per: int):
    """Per-rank (caller-id base, valid row count) for the *_local padded
    layout: the one walk of the (process, local rank, rank) mapping.
    Returns (rank_base (r,), valid_counts (r,))."""
    r = comms.get_size()
    base = np.zeros(r, np.int64)
    valid = np.zeros(r, np.int64)
    ranks_by_proc = _ranks_by_proc(comms)
    counts = np.asarray(counts, np.int64)
    for p, cnt in enumerate(counts):
        off = int(counts[:p].sum())
        for li, j in enumerate(ranks_by_proc.get(p, [])):
            base[j] = off + li * per
            valid[j] = int(np.clip(cnt - li * per, 0, per))
    return base, valid


def _local_shard_rows_host(comms: Comms, arr) -> np.ndarray:
    """This process's rows of a row-sharded result (its padded local
    block) as host numpy."""
    t = arr.full() if isinstance(arr, ShardedArray) else arr
    if not comms.process_world:
        return t.cpu().numpy()
    per = t.shape[0] // comms.get_size()
    return t[comms.rank * per:(comms.rank + 1) * per].cpu().numpy()


# replicated all-ones live masks, one per world geometry: the healthy
# path (health=None) is every serving call
_ONES_MASK_CACHE: dict = {}


def _healthy_mask_rep(comms: Comms):
    key = (comms.mesh, comms.axis)
    m = _ONES_MASK_CACHE.get(key)
    if m is None:
        while len(_ONES_MASK_CACHE) >= 8:
            _ONES_MASK_CACHE.pop(next(iter(_ONES_MASK_CACHE)))
        m = comms.replicate(np.ones(comms.get_size(), np.float32))
        _ONES_MASK_CACHE[key] = m
    return m


def _resolve_health(comms: Comms, health, query_mode: str, mode: str):
    """Degraded-mode plumbing shared by every distributed search: an
    optional `resilience.RankHealth` becomes (replicated (R,) f32 live
    mask, final query mode, coverage or None). With unhealthy ranks the
    merge topology is forced to "replicated" (a dead owner of a query
    block would drop the block); an explicit "sharded" request warns."""
    import warnings

    r = comms.get_size()
    if health is None:
        return _healthy_mask_rep(comms), mode, None
    if health.world != r:
        raise ValueError(f"health mask covers {health.world} ranks, mesh has {r}")
    if health.degraded and mode == "sharded":
        if query_mode == "sharded":
            warnings.warn(
                "query_mode='sharded' routes each query block to one "
                "owning rank, which degraded mode cannot mask; returning "
                "the REPLICATED layout",
                stacklevel=3,
            )
        mode = "replicated"
    return comms.replicate(health.live_f32()), mode, health.coverage()


def _pack_result(v, gid, nq: int, coverage, repaired_ranks=()):
    """The one degraded-result return shape: trim query padding back to nq
    rows, then plain `(v, gid)` without a health mask or a
    `DegradedSearchResult(v, gid, coverage, repaired_ranks)` with one."""
    from raft_tpu_torch.comms.resilience import DegradedSearchResult

    if v.shape[0] != nq:
        v, gid = v[:nq], gid[:nq]
    if coverage is None:
        return v, gid
    return DegradedSearchResult(v, gid, coverage, tuple(repaired_ranks))


def _mask_dead_rank(v, gid, live, rank, worst):
    """Inside a run body: blank an unhealthy rank's local candidates
    (worst score, id -1), what a prefilter excluding its rows produces."""
    alive = live[rank] > 0
    return (torch.where(alive, v, torch.full_like(v, worst)),
            torch.where(alive, gid, torch.full_like(gid, -1)))


def _replicated_filter_bits(comms: Comms, prefilter, id_bound: int):
    """A distributed-search prefilter as (replicated packed bits, bit
    count). Without a filter, a 1-word placeholder."""
    if prefilter is None:
        return comms.replicate(np.zeros(1, np.int32)), 1
    from raft_tpu_torch.core.bitset import as_bitset

    bs = as_bitset(prefilter, id_bound)
    return comms.replicate(bs.bits.cpu()), bs.n


def _shard_filtered(gid_tbl, bits, n: int, use_pf: bool):
    """Filtered view of a shard-local gid table (global ids; -1 pad),
    inside a run body."""
    if not use_pf:
        return gid_tbl
    from raft_tpu_torch.core.bitset import Bitset, filter_slot_table

    return filter_slot_table(gid_tbl, None, Bitset(bits, n))


def _host_np(arr) -> np.ndarray:
    """A sharded, replicated or plain array as host numpy (a sharded
    array's blocks concatenated; in a process world this process's part)."""
    if isinstance(arr, (ShardedArray, ReplicatedArray)):
        arr = arr.full()
    if isinstance(arr, torch.Tensor):
        return arr.detach().cpu().numpy()
    return np.asarray(arr)


def _map_blocks(fn, *arrs):
    """Apply `fn` to each rank's blocks of the `ShardedArray`s `arrs` (in
    the calling thread, each block on its rank's device) and return the
    results as `ShardedArray`s of the same layout: one, or a tuple where
    `fn` returns a tuple. The derived stores of the distributed indexes
    are built this way, outside any rank's body, so no two rank threads
    ever race to fill one."""
    first = arrs[0]
    outs = [fn(*bs) for bs in zip(*(a.blocks for a in arrs))]
    world = first.shape[first.dim] // first.blocks[0].shape[first.dim]
    if isinstance(outs[0], tuple):
        return tuple(ShardedArray([o[i] for o in outs], first.dim, world)
                     for i in range(len(outs[0])))
    return ShardedArray(outs, first.dim, world)
