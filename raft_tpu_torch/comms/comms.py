"""Comms: the port's communicator (counterpart of raft_tpu/comms/comms.py).

Reference parity: `raft::comms::comms_t` (core/comms.hpp:123-242), a
virtual interface with allreduce / bcast / reduce / allgather(v) /
gather(v) / reducescatter / device send-recv / barrier / comm_split and
two backends, NCCL+UCX and MPI (SURVEY §2.8). The port keeps two worlds
behind the one `AxisComms` rank view:

  the in-process world   `Comms(n_devices=R, device=...)`: R ranks, each a
                         thread of a pool that lives as long as the
                         session, each on its own `torch.device` (repeats
                         allowed: four ranks on one card). The counterpart
                         of the JAX single-controller mesh. Collectives
                         meet in a shared exchange: every rank deposits
                         its tensor, then every rank combines all R
                         deposits in rank order, so every rank holds the
                         same bits (`psum`'s replicated result). A second
                         barrier guards reuse of the slots. Every wait has
                         a deadline (`timeout_s`): a missed one raises
                         `resilience.HealthCheckTimeout`; a rank that
                         raises aborts the barrier, the other ranks raise
                         `CommsAborted` instead of waiting, and `run`
                         re-raises the first rank's own error;
  the process world      after `bootstrap_multihost` (over
                         `torch.distributed.init_process_group`: NCCL for
                         CUDA ranks, gloo for CPU ranks) `Comms()` spans
                         the processes, one rank each; `run` runs the body
                         once and the collectives are `torch.distributed`
                         calls. `comm_split` makes `dist.new_group`s, and
                         `device_sendrecv` is `batch_isend_irecv` (a pair
                         to the rank itself is a local copy). NCCL holds
                         one rank per GPU, so several ranks on one card
                         are the in-process world's job.

Two layers, as in the JAX package:
  - `AxisComms`: the rank view a `run` body receives (the comms_t
    methods). `comm_split` returns a view over static rank groups,
    reduced by the JAX package's schedules (intra-group ring or masked
    planes, `_grouped_schedule`).
  - `Comms`: the session object (raft-dask `Comms`, common/comms.py:37):
    owns the ranks' devices, places data (`shard`, `shard_from_local`,
    `replicate`, which return `ShardedArray` / `ReplicatedArray`, the
    counterparts of a jax.Array under a `NamedSharding`) and offers
    `run()` (the `shard_map` / `client.run` moment) with `PartitionSpec`
    in and out specs.

Accounting and chaos, at call time: the JAX package counts
`obs.collective` and fires `_inject` while it traces, once per compiled
program. The port has no trace: in the in-process world rank 0 alone
counts each collective, once a call (one driver call's counters equal
the JAX counters after its first, tracing, call); a process counts its
own. Faults fire on every call, on the faulted rank.

Every rank works on its device's default stream, so a tensor one rank
deposits is safe to read from another rank's thread on the same card
(stream order); reads across cards go through `.to(device)`.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import enum
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import faults

#: seconds a rank waits at any collective before the world gives up
DEFAULT_TIMEOUT_S = 600.0


def _resolve_quant(quantization, device):
    """Normalize a collective's `quantization=` argument: None / "off"
    return None without importing the codec module, so the exact path is
    the pre-quantization one; everything else defers to
    `comms.quantized.resolve` (tuned "auto" where the table governs
    `device`)."""
    if quantization is None or quantization == "off":
        return None
    from raft_tpu_torch.comms import quantized

    return quantized.resolve(quantization, device)


class op_t(enum.Enum):
    """Reduction ops (core/comms.hpp op_t)."""

    SUM = "sum"
    PROD = "prod"
    MIN = "min"
    MAX = "max"


class datatype_t(enum.Enum):
    """Kept for API parity (core/comms.hpp datatype_t); torch dtypes rule."""

    FLOAT32 = "float32"
    FLOAT64 = "float64"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"


class CommsAborted(RuntimeError):
    """Raised in a rank whose collective was abandoned because another
    rank of the same `run` raised (`run` re-raises that rank's error)."""


class PartitionSpec(tuple):
    """How a `run` argument or result lies across the ranks (the
    counterpart of `jax.sharding.PartitionSpec`): one entry per leading
    dimension, the axis name where that dimension is split into equal
    per-rank blocks, None where it is whole. `P()` / `P(None, None)` is
    replicated."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self):
        return f"P{tuple(self)!r}"

    def split_dim(self, axis: str) -> Optional[int]:
        """The dimension split along `axis`, or None (replicated)."""
        for i, d in enumerate(self):
            if d == axis:
                return i
        return None


P = PartitionSpec


class ShardedArray:
    """A global array laid out across the ranks in equal blocks along
    `dim` (what `Comms.shard` / `shard_from_local` return). `blocks` are
    this process's ranks' blocks, in rank order, each on its rank's
    device: every rank in the in-process world, the one local rank in a
    process world."""

    def __init__(self, blocks, dim: int, world: int):
        self.blocks = list(blocks)
        self.dim = int(dim)
        b = self.blocks[0]
        shape = list(b.shape)
        shape[self.dim] = shape[self.dim] * int(world)
        self.shape = tuple(shape)
        self.dtype = b.dtype
        self.ndim = b.ndim

    def full(self) -> torch.Tensor:
        """The blocks concatenated on the first block's device (in a
        process world: this process's part only)."""
        dev = self.blocks[0].device
        return torch.cat([b.to(dev) for b in self.blocks], self.dim)


class ReplicatedArray:
    """One value held on every rank (what `Comms.replicate` returns): one
    copy per distinct device, shared by the ranks on that device."""

    def __init__(self, copies: dict):
        self.copies = dict(copies)
        v = next(iter(self.copies.values()))
        self.shape = tuple(v.shape)
        self.dtype = v.dtype
        self.ndim = v.ndim

    def on(self, device) -> torch.Tensor:
        device = torch.device(device)
        t = self.copies.get(device)
        if t is None:
            t = next(iter(self.copies.values())).to(device)
            self.copies[device] = t
        return t

    def full(self) -> torch.Tensor:
        return next(iter(self.copies.values()))


def _host_tensor(x) -> torch.Tensor:
    """numpy / lists as a CPU tensor (no copy for a contiguous array);
    tensors as they are."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.ascontiguousarray(np.asarray(x))
    return torch.from_numpy(a if a.flags.writeable else a.copy())


# -- the worlds -----------------------------------------------------------

class _ThreadExchange:
    """The in-process world's meeting point for one `run`: R slots and a
    barrier. Every wait has the run's deadline."""

    def __init__(self, size: int, timeout_s: float):
        self.size = size
        self.timeout_s = float(timeout_s)
        self._slots = [None] * size
        self._barrier = threading.Barrier(size)
        self._lock = threading.Lock()
        self.error: Optional[BaseException] = None

    def fail(self, e: BaseException) -> None:
        """Record a rank's own error (the first one wins) and release the
        other ranks from the barrier."""
        with self._lock:
            if self.error is None and not isinstance(e, CommsAborted):
                self.error = e
        self._barrier.abort()

    def _wait(self) -> None:
        try:
            self._barrier.wait(self.timeout_s)
        except threading.BrokenBarrierError:
            if self.error is not None:
                raise CommsAborted("another rank of this run raised") from None
            from raft_tpu_torch.comms.resilience import HealthCheckTimeout

            raise HealthCheckTimeout(
                f"a rank missed the collective's {self.timeout_s}s deadline") from None

    def exchange(self, rank: int, x):
        """Deposit `x`, return every rank's deposit in rank order."""
        self._slots[rank] = x
        self._wait()
        out = list(self._slots)
        self._wait()
        return out


class _RankCtx:
    """One rank's handle on its world: its position, device, whether it
    counts collectives, and the primitives the `AxisComms` methods are
    built from (full-axis reductions, gathers, permutations)."""

    process = False

    def __init__(self, rank: int, size: int, device: torch.device, counts: bool):
        self.rank = rank
        self.size = size
        self.device = device
        self.counts = counts

    def group_allreduce(self, x, groups, op):
        """A comm_split's allreduce where the world has one of its own, or
        None: the grouped schedules of AxisComms then run it."""
        return None


class _ThreadRank(_RankCtx):
    def __init__(self, exchange: _ThreadExchange, rank: int, device: torch.device):
        super().__init__(rank, exchange.size, device, rank == 0)
        self._ex = exchange

    def _parts(self, x):
        return [p.to(self.device) for p in self._ex.exchange(self.rank, x)]

    def reduce(self, x, combine):
        parts = self._parts(x)
        acc = parts[0].clone() if len(parts) == 1 else parts[0]
        for p in parts[1:]:
            acc = combine(acc, p)
        return acc

    def all_gather(self, x):
        return [p.clone() for p in self._parts(x)]

    def ppermute(self, x, perm):
        parts = self._ex.exchange(self.rank, x)
        for src, dst in perm:
            if dst == self.rank:
                return parts[src].to(self.device, copy=True)
        return torch.zeros_like(x)

    def all_to_all(self, x, axis: int):
        per = x.shape[axis] // self.size
        parts = self._parts(x)
        return torch.cat([p.narrow(axis, self.rank * per, per) for p in parts], axis)

    def psum_scatter(self, x, axis: int):
        per = x.shape[axis] // self.size
        return self.reduce(x, torch.add).narrow(axis, self.rank * per, per).clone()


class _ProcessRank(_RankCtx):
    """A process world's rank: the collectives are torch.distributed
    calls on the default group (or a comm_split's `new_group`)."""

    process = True

    def __init__(self, rank: int, size: int, device: torch.device):
        super().__init__(rank, size, device, True)

    @staticmethod
    def _dist():
        import torch.distributed as dist

        return dist

    def _all_reduce(self, x, op, group=None):
        dist = self._dist()
        red = {op_t.SUM: dist.ReduceOp.SUM, op_t.MIN: dist.ReduceOp.MIN,
               op_t.MAX: dist.ReduceOp.MAX}[op]
        y = x.contiguous().clone()
        if y.dtype == torch.bool:
            y8 = y.to(torch.uint8)
            dist.all_reduce(y8, op=red, group=group)
            return y8.to(torch.bool)
        dist.all_reduce(y, op=red, group=group)
        return y

    def reduce(self, x, combine):
        op = {torch.add: op_t.SUM, torch.minimum: op_t.MIN, torch.maximum: op_t.MAX}[combine]
        return self._all_reduce(x, op)

    def all_gather(self, x):
        dist = self._dist()
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self.size)]
        dist.all_gather(parts, x)
        return parts

    def ppermute(self, x, perm):
        dist = self._dist()
        x = x.contiguous()
        out = torch.zeros_like(x)
        ops = []
        for src, dst in perm:
            if src == self.rank and dst == self.rank:
                out = x.clone()
            elif src == self.rank:
                ops.append(dist.P2POp(dist.isend, x, dst))
            elif dst == self.rank:
                ops.append(dist.P2POp(dist.irecv, out, src))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def all_to_all(self, x, axis: int):
        dist = self._dist()
        inp = x.movedim(axis, 0).contiguous()
        out = torch.empty_like(inp)
        dist.all_to_all_single(out, inp)
        return out.movedim(0, axis)

    def psum_scatter(self, x, axis: int):
        dist = self._dist()
        chunks = [c.contiguous() for c in x.movedim(axis, 0).chunk(self.size)]
        out = torch.empty_like(chunks[0])
        dist.reduce_scatter(out, chunks)
        return out.movedim(0, axis)

    def group_allreduce(self, x, groups, op):
        """A comm_split's SUM / MIN / MAX allreduce on its `new_group`."""
        if op not in (op_t.SUM, op_t.MIN, op_t.MAX):
            return None
        pg = _process_groups(groups)[_group_index(groups, self.rank)]
        return self._all_reduce(x, op, group=pg)


_PROCESS_GROUPS: dict = {}


def _process_groups(groups):
    """One `dist.new_group` per comm_split group, made collectively (every
    process creates every group, in the same order) and cached."""
    pgs = _PROCESS_GROUPS.get(groups)
    if pgs is None:
        import torch.distributed as dist

        pgs = [dist.new_group(list(g)) for g in groups]
        _PROCESS_GROUPS[groups] = pgs
    return pgs


def _group_index(groups, rank: int) -> int:
    for g_i, g in enumerate(groups):
        if rank in g:
            return g_i
    raise ValueError(f"rank {rank} is in no group")


# -- the rank view --------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class AxisComms:
    """comms_t rank view over the comms axis; a `run` body receives one.

    `groups` (optional) restricts collectives to static rank groups (the
    comm_split analogue). Outside `run` (no rank bound) only the topology
    queries work."""

    axis: str
    size: int
    groups: Optional[tuple] = None
    _ctx: Optional[_RankCtx] = dataclasses.field(default=None, compare=False, repr=False)

    def _c(self) -> _RankCtx:
        if self._ctx is None:
            raise RuntimeError("collectives run inside Comms.run(fn, ...): use the rank view "
                               "the body receives")
        return self._ctx

    def _t(self, x) -> torch.Tensor:
        if isinstance(x, torch.Tensor):
            return x
        return torch.as_tensor(x, device=self._c().device)

    def _count(self, op: str, x, **kw) -> None:
        if self._c().counts:
            obs.collective(op, x, axis=self.axis, **kw)

    # -- topology ------------------------------------------------------
    def get_size(self) -> int:
        """Rank count; after an unequal comm_split, this rank's group's."""
        if self.groups is not None:
            sizes = [len(g) for g in self.groups]
            if len(set(sizes)) == 1:
                return sizes[0]
            return len(self.groups[self._group_id()])
        return self.size

    def _max_group_size(self) -> int:
        return max(len(g) for g in self.groups)

    def _wire_world(self) -> int:
        """World size the obs wire model assumes: a comm_split
        communicator moves data within its groups (worst-case group)."""
        return self._max_group_size() if self.groups is not None else self.size

    def _axis_index(self) -> int:
        return self._c().rank

    def get_rank(self) -> int:
        idx = self._axis_index()
        if self.groups is None:
            return idx
        return self.groups[self._group_id()].index(idx)

    def _group_id(self) -> int:
        return _group_index(self.groups, self._axis_index())

    # -- full-axis primitives (the lax.psum / all_gather / ppermute /
    # all_to_all / psum_scatter of the JAX package) ---------------------
    def _psum(self, x):
        return self._c().reduce(x, torch.add)

    def _pmin(self, x):
        return self._c().reduce(x, torch.minimum)

    def _pmax(self, x):
        return self._c().reduce(x, torch.maximum)

    def _all_gather(self, x, axis: int = 0, tiled: bool = False):
        parts = self._c().all_gather(x)
        return torch.cat(parts, axis) if tiled else torch.stack(parts, axis)

    def _ppermute(self, x, perm):
        return self._c().ppermute(x, list(perm))

    def _all_to_all(self, x, axis: int = 0):
        return self._c().all_to_all(x, axis)

    def _psum_scatter(self, x, axis: int = 0):
        return self._c().psum_scatter(x, axis)

    # -- grouped machinery -----------------------------------------------
    def _grouped_combine(self, x, combine):
        """Exact-PROD grouped fallback: gather the full axis, combine this
        rank's group's slice (the groups are static)."""
        g = self._all_gather(x)
        grp = self.groups[self._group_id()]
        return combine(g[list(grp)])

    def _group_planes(self, x, identity):
        """(G, ...) stack: plane g holds x on members of group g and the
        reduction identity elsewhere; one full-axis reduction of it
        reduces every group at once."""
        planes = torch.full((len(self.groups),) + tuple(x.shape), identity, dtype=x.dtype,
                            device=x.device)
        planes[self._group_id()] = x
        return planes

    @staticmethod
    def _reduce_identity(dtype, op: op_t):
        """Neutral element of `op` in `dtype` (non-members contribute it)."""
        if op == op_t.SUM:
            return 0
        if op == op_t.PROD:
            return 1
        if dtype == torch.bool:
            return op == op_t.MIN
        if dtype.is_floating_point:
            return float("inf") if op == op_t.MIN else float("-inf")
        info = torch.iinfo(dtype)
        return info.max if op == op_t.MIN else info.min

    @staticmethod
    def _prod_split(x):
        """(3, ...) planes whose per-plane SUM recombines into a product:
        zero count (exact), negative count (exact), log-magnitude (fp
        rounding only). Stays in x's dtype."""
        return torch.stack([
            (x == 0).to(x.dtype),
            (x < 0).to(x.dtype),
            torch.log(torch.where(x == 0, torch.ones_like(x), torch.abs(x))),
        ])

    @staticmethod
    def _prod_recombine(planes, dtype):
        zeros, neg, logmag = planes
        mag = torch.exp(logmag)
        signed = torch.where(torch.remainder(neg, 2) == 1, -mag, mag)
        return torch.where(zeros > 0, torch.zeros_like(signed), signed).to(dtype)

    def _allreduce_prod(self, x):
        exact = x.numel() <= 4096 or not x.is_floating_point()
        prod = lambda v: torch.prod(v, 0).to(x.dtype)  # noqa: E731
        if self.groups is None:
            if exact:
                # exact path (ints: f32 log space rounds off by one near 2^20)
                return prod(self._all_gather(x))
            return self._prod_recombine(self._psum(self._prod_split(x)), x.dtype)
        if exact:
            return self._grouped_combine(x, prod)
        planes = self._psum(self._group_planes(self._prod_split(x), 0))
        return self._prod_recombine(planes[self._group_id()], x.dtype)

    _REDUCE_PRIM = {op_t.SUM: "_psum", op_t.MAX: "_pmax", op_t.MIN: "_pmin"}
    _COMBINE = {op_t.SUM: torch.add, op_t.MIN: torch.minimum, op_t.MAX: torch.maximum}

    def _ring_perm(self):
        """(src, dst) pairs rotating each value one step forward within
        its own group (the groups are disjoint: one permutation holds
        every group's ring)."""
        perm = []
        for grp in self.groups:
            for i, r in enumerate(grp):
                perm.append((r, grp[(i + 1) % len(grp)]))
        return perm

    def _own_group_size(self) -> int:
        return len(self.groups[self._group_id()])

    def _grouped_reduce_ring(self, x, op: op_t):
        """Grouped allreduce as an intra-group rotation ring: step k moves
        the original values one slot forward within each group and a
        rank accepts the first (own size - 1) arrivals; after
        max_group_size - 1 steps every rank holds its group's reduction
        (own value first, then the arrivals in ring order)."""
        combine = self._COMBINE[op]
        s_own = self._own_group_size()
        perm = self._ring_perm()
        acc = x
        y = x
        for k in range(self._max_group_size() - 1):
            y = self._ppermute(y, perm)
            if k + 1 < s_own:
                acc = combine(acc, y)
        return acc

    def _grouped_schedule(self) -> str:
        """ring | planes for grouped SUM/MIN/MAX, by the volume model:
        ring sends (s_max - 1) x payload per rank, the planes reduction
        ~2G x payload; ring unless (s_max - 1) > c * G, c the tuned
        `grouped_reduce_crossover` (default 2.0). `grouped_reduce_schedule`
        = "ring" | "planes" is a blunt override. Tuned values govern CUDA
        ranks only (`tuned.applies`); untuned, the JAX default."""
        from raft_tpu_torch.core import tuned

        g = len(self.groups)
        c = 2.0
        if tuned.applies(self._c().device):
            key = tuned.get("grouped_reduce_schedule")
            if key in ("ring", "planes"):
                return key
            try:
                c = float(tuned.get("grouped_reduce_crossover", 2.0))
            except (TypeError, ValueError):
                c = 2.0
        return "ring" if self._max_group_size() - 1 <= c * g else "planes"

    def _inject(self, site: str, x, identity):
        """Chaos hook (core.faults): with an installed FaultPlan, drop this
        rank's contribution to the identity and/or NaN-corrupt its
        payload at the named site. Without a plan, `x` itself."""
        if not faults.active_for(site):
            return x
        r = self._axis_index()
        x = faults.drop_contribution(site, x, r, identity)
        return faults.corrupt_in_trace(site, x, r)

    # -- collectives ---------------------------------------------------
    def allreduce(self, x, op: op_t = op_t.SUM, quantization=None):
        qcfg = _resolve_quant(quantization, self._c().device)
        if qcfg is not None:
            from raft_tpu_torch.comms import quantized

            return quantized.qallreduce(self, x, op, qcfg)
        x = self._t(x)
        self._count("allreduce", x, world=self._wire_world())
        x = self._inject("comms.allreduce", x, self._reduce_identity(x.dtype, op))
        return self._allreduce_raw(x, op)

    def _allreduce_raw(self, x, op: op_t):
        """Allreduce dispatch alone: no obs accounting, no fault injection
        (the callers own both); the quantized transports reuse it."""
        if op == op_t.PROD:
            return self._allreduce_prod(x)
        if op not in self._REDUCE_PRIM:
            raise ValueError(op)
        prim = getattr(self, self._REDUCE_PRIM[op])
        if self.groups is None:
            return prim(x)
        direct = self._c().group_allreduce(x, self.groups, op)
        if direct is not None:
            return direct
        if self._grouped_schedule() == "ring":
            return self._grouped_reduce_ring(x, op)
        planes = self._group_planes(x, self._reduce_identity(x.dtype, op))
        return prim(planes)[self._group_id()]

    def _grouped_bcast_ring(self, contrib, root: int):
        """Grouped bcast on the intra-group ring: the rank at ring
        distance k from its group's root accepts arrival k."""
        s = self._own_group_size()
        d_own = (self.get_rank() - root) % s
        perm = self._ring_perm()
        acc = contrib
        y = contrib
        for k in range(self._max_group_size() - 1):
            y = self._ppermute(y, perm)
            if d_own == k + 1:
                acc = y
        return acc

    def bcast(self, x, root: int = 0, quantization=None):
        """Broadcast root's value (root is the group-local rank when split):
        one SUM of the root-masked value; on a split comm, G root-masked
        planes or the intra-group ring."""
        qcfg = _resolve_quant(quantization, self._c().device)
        if qcfg is not None:
            from raft_tpu_torch.comms import quantized

            return quantized.qbcast(self, x, qcfg, root=root)
        xa = self._t(x)
        self._count("bcast", xa, world=self._wire_world())
        return self._bcast_raw(xa, root)

    def _bcast_raw(self, xa, root: int):
        """Bcast dispatch alone (root masking and schedules), no obs
        accounting; the quantized transport reuses it."""
        contrib = xa if self.get_rank() == root else torch.zeros_like(xa)
        if self.groups is None:
            return self._psum(contrib)
        if self._grouped_schedule() == "ring":
            return self._grouped_bcast_ring(contrib, root)
        planes = self._psum(self._group_planes(contrib, 0))
        return planes[self._group_id()]

    def reduce(self, x, root: int = 0, op: op_t = op_t.SUM):
        """All ranks take part; non-roots receive zeros."""
        red = self.allreduce(x, op)
        return red if self.get_rank() == root else torch.zeros_like(red)

    def _grouped_allgather_ring(self, x):
        """(m, ...) group-slot stack by the intra-group ring: arrival k is
        the value of the member k ring steps behind, placed at its
        group-local position; slots past this group's size stay zero."""
        m = self._max_group_size()
        s_own = self._own_group_size()
        pos = self.get_rank()
        perm = self._ring_perm()
        out = torch.zeros((m,) + tuple(x.shape), dtype=x.dtype, device=x.device)
        out[pos] = x
        y = x
        for k in range(1, m):
            y = self._ppermute(y, perm)
            if k < s_own:
                out[(pos - k) % s_own] = y
        return out

    def allgather(self, x, axis: int = 0, tiled: bool = False, quantization=None):
        qcfg = _resolve_quant(quantization, self._c().device)
        if qcfg is not None:
            from raft_tpu_torch.comms import quantized

            return quantized.qallgather(self, x, qcfg, axis=axis, tiled=tiled)
        x = self._t(x)
        self._count("allgather", x, world=self._wire_world())
        x = self._inject("comms.allgather", x, 0)
        return self._allgather_raw(x, axis, tiled)

    def _allgather_raw(self, x, axis: int, tiled: bool):
        """Allgather dispatch alone, no obs accounting or injection."""
        if self.groups is None:
            return self._all_gather(x, axis, tiled)
        if self._grouped_schedule() == "ring":
            out = self._grouped_allgather_ring(x)
        else:
            g = self._all_gather(x)
            m = self._max_group_size()
            grp = self.groups[self._group_id()]
            out = torch.zeros((m,) + tuple(x.shape), dtype=x.dtype, device=x.device)
            out[:len(grp)] = g[list(grp)]
        if tiled:
            return torch.cat([out[i] for i in range(out.shape[0])], axis)
        if axis != 0:
            return torch.movedim(out, 0, axis)
        return out

    def allgatherv(self, x, counts: Sequence[int], axis: int = 0):
        """Variable-size allgather (core/comms.hpp:171). Every rank passes
        x with the same extent `x.shape[axis] >= max(counts)`, of which the
        leading `counts[rank]` slices are valid; the tail is zeroed and the
        ranks stack on a new leading dim. On an unequal split comm
        `counts` has length max-group-size, indexed by group-local rank."""
        counts = [int(c) for c in counts]
        x = self._t(x)
        need = self._max_group_size() if self.groups is not None else self.size
        if len(counts) != need:
            raise ValueError(
                f"len(counts)={len(counts)} != comm size {need}; counts is "
                "indexed by (group-local) rank"
            )
        if x.shape[axis] < max(counts):
            raise ValueError(
                f"x.shape[{axis}]={x.shape[axis]} < max(counts)={max(counts)}; "
                "allgatherv needs every rank padded to a shared static extent"
            )
        cnt = counts[self.get_rank()]
        idx_shape = [1] * x.ndim
        idx_shape[axis] = x.shape[axis]
        valid = torch.arange(x.shape[axis], device=x.device).reshape(idx_shape) < cnt
        return self.allgather(torch.where(valid, x, torch.zeros_like(x)), axis=0)

    def gather(self, x, root: int = 0, axis: int = 0):
        g = self.allgather(x, axis=axis)
        return g if self.get_rank() == root else torch.zeros_like(g)

    def gatherv(self, x, counts: Sequence[int], root: int = 0, axis: int = 0):
        """Variable-size gather to root (core/comms.hpp:182): the
        allgatherv result on root, zeros elsewhere."""
        g = self.allgatherv(x, counts, axis=axis)
        return g if self.get_rank() == root else torch.zeros_like(g)

    def reducescatter(self, x, op: op_t = op_t.SUM, axis: int = 0, quantization=None):
        """Reduce over the comm, scatter chunks of the result along `axis`
        (core/comms.hpp:192, any op_t). `x.shape[axis]` divides into the
        comm size, or on a split comm the largest group's size m; group
        rank p receives chunk p of its group's reduction."""
        qcfg = _resolve_quant(quantization, self._c().device)
        if qcfg is not None:
            from raft_tpu_torch.comms import quantized

            return quantized.qreducescatter(self, x, op, qcfg, axis=axis)
        x = self._t(x)
        self._count("reducescatter", x, world=self._wire_world())
        if self.groups is not None:
            m = self._max_group_size()
            if x.shape[axis] % m:
                raise ValueError(
                    f"x.shape[{axis}]={x.shape[axis]} not divisible by the "
                    f"largest group size {m}"
                )
            per = x.shape[axis] // m
            red = self.allreduce(x, op)
            return red.narrow(axis, self.get_rank() * per, per)
        if x.shape[axis] % self.size:
            raise ValueError(
                f"x.shape[{axis}]={x.shape[axis]} not divisible by comm "
                f"size {self.size}"
            )
        if op == op_t.PROD:
            per = x.shape[axis] // self.size
            red = self.allreduce(x, op)
            return red.narrow(axis, self._axis_index() * per, per)
        return self._reducescatter_raw(x, op, axis)

    def _reducescatter_raw(self, x, op: op_t, axis: int):
        """Reduce-scatter dispatch alone, no obs accounting (the quantized
        bf16 transport reuses it)."""
        if self.groups is not None:
            per = x.shape[axis] // self._max_group_size()
            red = self._allreduce_raw(x, op)
            return red.narrow(axis, self.get_rank() * per, per)
        if op == op_t.SUM:
            return self._psum_scatter(x, axis)
        per = x.shape[axis] // self.size
        if op in (op_t.MIN, op_t.MAX):
            # all_to_all transposes chunk ownership, then a rank-local
            # reduction (each rank ships world - 1 chunks)
            t = self._all_to_all(x, axis)
            seg = t.reshape(t.shape[:axis] + (self.size, per) + t.shape[axis + 1:])
            return (torch.amin if op == op_t.MIN else torch.amax)(seg, dim=axis)
        red = self._allreduce_raw(x, op)
        return red.narrow(axis, self._axis_index() * per, per)

    # -- p2p -----------------------------------------------------------
    def device_sendrecv(self, x, perm: Sequence[tuple]):
        """Explicit (src, dst) permutation (comms_t.device_sendrecv); a
        rank no pair sends to receives zeros."""
        x = self._t(x)
        self._count("device_sendrecv", x, world=self._wire_world())
        return self._ppermute(x, perm)

    def shift(self, x, offset: int = 1):
        """Ring shift by offset; on a split comm the ring is per group."""
        x = self._t(x)
        self._count("shift", x, world=self._wire_world())
        if self.groups is not None:
            perm = []
            for g in self.groups:
                perm += [(g[i], g[(i + offset) % len(g)]) for i in range(len(g))]
            return self._ppermute(x, perm)
        n = self.size
        return self._ppermute(x, [(i, (i + offset) % n) for i in range(n)])

    def device_multicast_sendrecv(self, x, dests: Sequence[Sequence[int]]):
        """Each rank i sends to every rank of dests[i]: the sum of one
        permutation per fan-out slot."""
        x = self._t(x)
        self._count("device_multicast_sendrecv", x, world=self._wire_world())
        out = torch.zeros_like(x)
        max_fan = max(len(d) for d in dests)
        for j in range(max_fan):
            perm = [(i, dests[i][j]) for i in range(self.size) if j < len(dests[i])]
            out = out + self._ppermute(x, perm)
        return out

    def barrier(self, token=None):
        """Synchronization point: an allreduce of a scalar."""
        t = (torch.zeros((), dtype=torch.float32, device=self._c().device) if token is None
             else torch.sum(self._t(token)) * 0)
        self._count("barrier", t if token is None else self._t(token), world=self._wire_world())
        return self.allreduce(t + 1.0, op_t.SUM)

    # -- host-side async p2p: deliberately absent -----------------------
    # The reference's UCX host p2p (comms_t.isend/irecv/waitall,
    # core/comms.hpp:154-176) and the NCCL group_start/group_end window
    # (:212-230) map, as in the JAX package, to device_sendrecv / shift
    # inside a run body: a `run` is one group, and its result is the fence.

    def isend(self, *a, **k):
        raise NotImplementedError(
            "comms_t.isend is not offered: transfers are the collectives of a "
            "Comms.run body. Use device_sendrecv/shift there; see the p2p notes "
            "in comms.py."
        )

    def irecv(self, *a, **k):
        raise NotImplementedError(
            "comms_t.irecv is not offered: transfers are the collectives of a "
            "Comms.run body. Use device_sendrecv/shift there; see the p2p notes "
            "in comms.py."
        )

    def waitall(self, *a, **k):
        raise NotImplementedError(
            "comms_t.waitall is not offered: a Comms.run returns when its "
            "collectives are done. See the p2p notes in comms.py."
        )

    def group_start(self):
        raise NotImplementedError(
            "NCCL group_start/group_end windows are not offered: the "
            "collectives of one Comms.run body are one group. See the p2p "
            "notes in comms.py."
        )

    def group_end(self):
        raise NotImplementedError(
            "NCCL group_start/group_end windows are not offered: the "
            "collectives of one Comms.run body are one group. See the p2p "
            "notes in comms.py."
        )

    # -- split ---------------------------------------------------------
    def comm_split(self, colors: Sequence[int]) -> "AxisComms":
        """Static comm_split: ranks with the same color form a sub-comm
        (core/comms.hpp comm_split). Groups may be unequal-sized. In a
        process world every process makes the groups' `dist.new_group`s."""
        colors = list(colors)
        if len(colors) != self.size:
            raise ValueError("colors must list one color per rank")
        groups = {}
        for r, c in enumerate(colors):
            groups.setdefault(c, []).append(r)
        groups = tuple(tuple(g) for g in groups.values())
        if self._ctx is not None and self._ctx.process:
            _process_groups(groups)
        return AxisComms(self.axis, self.size, groups, _ctx=self._ctx)

    def sync_stream(self):
        """Wait for this rank's device stream (comms_t.sync_stream)."""
        dev = self._c().device
        if dev.type == "cuda":
            torch.cuda.current_stream(dev).synchronize()
        return None


# -- the session ----------------------------------------------------------

_PROCESS_STATE: dict = {}


def _process_world_active() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _process_index_count():
    """(this process's rank, process count): torch.distributed's where a
    process group exists, else (0, 1)."""
    if not _process_world_active():
        return 0, 1
    import torch.distributed as dist

    return int(dist.get_rank()), int(dist.get_world_size())


class Comms:
    """Session object for SPMD execution over the ranks
    (raft-dask `Comms`, python/raft-dask/raft_dask/common/comms.py:37).

    In-process world: `mesh` is a sequence of `torch.device`s, one per
    rank (repeats allowed); or `n_devices` ranks on `device` (default:
    every visible CUDA device, one rank each, `n_devices` of them; without
    a card this raises, as `core.config.resolve_device` does). Process
    world: `Comms()` with no arguments after `bootstrap_multihost`.
    `timeout_s`: the deadline of every wait of a run (`run`'s default;
    `DEFAULT_TIMEOUT_S` where None)."""

    def __init__(self, mesh=None, axis: str = "data", n_devices: Optional[int] = None,
                 device=None, timeout_s: Optional[float] = None):
        self.axis = axis
        self.timeout_s = DEFAULT_TIMEOUT_S if timeout_s is None else float(timeout_s)
        self.nccl_initialized = True  # API parity flag (raft-dask .init())
        self.ucx_initialized = False
        self._pool: Optional[concurrent.futures.ThreadPoolExecutor] = None
        self._pool_lock = threading.Lock()
        # one run at a time in the in-process world: two concurrent runs
        # would share the pool's R threads, each holding some ranks at a
        # barrier while its other ranks queue behind the other run's
        self._run_lock = threading.RLock()
        if mesh is None and n_devices is None and device is None and _process_world_active():
            import torch.distributed as dist

            self.process_world = True
            self.rank = dist.get_rank()
            self._size = dist.get_world_size()
            self.device = _PROCESS_STATE.get("device")
            if self.device is None:  # a launcher made the process group
                self.device = (torch.device("cuda", torch.cuda.current_device())
                               if dist.get_backend() == "nccl" else torch.device("cpu"))
            self.mesh = ("process", self._size, str(self.device), dist.get_backend())
            self.devices = (self.device,)
            return
        from raft_tpu_torch.core.config import resolve_device

        self.process_world = False
        self.rank = 0
        if mesh is not None:
            devs = tuple(torch.device(d) for d in mesh)
            if n_devices is not None:
                devs = devs[:n_devices]
        elif device is not None:
            dev = resolve_device(device)
            devs = (dev,) * (1 if n_devices is None else int(n_devices))
        else:
            resolve_device(None)  # raises without a card
            count = torch.cuda.device_count()
            n = count if n_devices is None else int(n_devices)
            if n > count:
                raise ValueError(f"n_devices={n} > {count} visible CUDA devices; pass "
                                 "device= to put several ranks on one card")
            devs = tuple(torch.device("cuda", i) for i in range(n))
        for d in devs:
            resolve_device(d)
        if not devs:
            raise ValueError("a comms world needs at least one rank")
        self.devices = devs
        self.mesh = devs
        self.device = devs[0]
        self._size = len(devs)

    @property
    def comms(self) -> AxisComms:
        return AxisComms(self.axis, self._size)

    def get_size(self) -> int:
        return self._size

    def spans_processes(self) -> bool:
        """True when the ranks are processes of a job of more than one
        (the multi-controller world)."""
        return self.process_world and self._size > 1

    def local_ranks(self) -> tuple:
        """The ranks this process holds, in order."""
        return (self.rank,) if self.process_world else tuple(range(self._size))

    def rank_device(self, rank: int) -> torch.device:
        return self.device if self.process_world else self.devices[rank]

    # -- placing data ----------------------------------------------------
    def _blocks(self, x, axis: int):
        """Split a full array into per-rank blocks along `axis`, each sent
        to its rank's device one at a time (never the whole array to one
        device first)."""
        t = _host_tensor(x)
        if t.shape[axis] % self._size:
            raise ValueError(f"dimension {axis} of size {t.shape[axis]} does not split into "
                             f"{self._size} equal blocks")
        per = t.shape[axis] // self._size
        return [t.narrow(axis, r * per, per).to(self.rank_device(r))
                for r in self.local_ranks()]

    def shard(self, x, axis: int = 0) -> ShardedArray:
        """Place a full array sharded along the comms axis. In a process
        world of more than one process nobody holds the full array: use
        `shard_from_local`."""
        if isinstance(x, ShardedArray):
            if x.dim != axis:
                raise ValueError("resharding along another dimension is not supported")
            return x
        if self.spans_processes():
            raise ValueError(
                "shard(full_array) is single-controller; on a multi-process "
                "world each process holds only its partition: use "
                "shard_from_local(local_rows)"
            )
        return ShardedArray(self._blocks(x, axis), axis, self._size)

    def shard_from_local(self, local_x, axis: int = 0) -> ShardedArray:
        """Assemble a sharded array from this process's own rows (the
        raft-dask model: each worker contributes its partition). Every
        process calls it collectively; the concatenation along `axis` in
        process order is the global array. In-process, the same as
        `shard`."""
        if isinstance(local_x, ShardedArray):
            raise ValueError("shard_from_local takes this process's rows, not an "
                             "already sharded array")
        if not self.process_world:
            return self.shard(local_x, axis=axis)
        t = _host_tensor(local_x).to(self.device)
        return ShardedArray([t], axis, self._size)

    def replicate(self, x) -> ReplicatedArray:
        """The same value on every rank (in a process world every process
        passes the same value: the multi-controller contract)."""
        if isinstance(x, ReplicatedArray):
            return x
        t = _host_tensor(x)
        copies = {}
        for r in self.local_ranks():
            dev = self.rank_device(r)
            if dev not in copies:
                copies[dev] = t.to(dev)
        return ReplicatedArray(copies)

    # -- launching SPMD functions (the client.run moment) ----------------
    def _arg_block(self, arg, spec, rank: int, cache: dict):
        dev = self.rank_device(rank)
        dim = spec.split_dim(self.axis) if isinstance(spec, PartitionSpec) else None
        if isinstance(arg, ShardedArray):
            if dim is None:
                raise ValueError("a sharded argument needs a sharded in_spec")
            if dim != arg.dim:
                raise ValueError(f"argument sharded on dim {arg.dim}, in_spec splits dim {dim}")
            return arg.blocks[self.local_ranks().index(rank)]
        if isinstance(arg, ReplicatedArray):
            t = arg.on(dev)
        elif isinstance(arg, (torch.Tensor, np.ndarray)):
            key = (id(arg), dev)
            t = cache.get(key)
            if t is None:
                t = _host_tensor(arg).to(dev)
                cache[key] = t
        else:
            return arg  # host metadata (ints, tuples, None) reaches every rank as is
        if dim is None:
            return t
        per = t.shape[dim] // self._size
        return t.narrow(dim, rank * per, per)

    def _assemble(self, outs, specs, keep_blocks: bool = False):
        """Per-rank outputs -> the global results (out_specs); with
        `keep_blocks`, split results stay per-rank blocks (a
        `ShardedArray`, each block on its rank's device)."""
        single = isinstance(specs, PartitionSpec)
        spec_list = [specs] if single else list(specs)
        per_rank = [[o] if single else list(o) for o in outs]
        results = []
        for i, spec in enumerate(spec_list):
            vals = [pr[i] for pr in per_rank]
            dim = spec.split_dim(self.axis)
            if dim is None or not isinstance(vals[0], torch.Tensor):
                results.append(vals[0])
                continue
            if keep_blocks:
                results.append(ShardedArray(vals, dim, self._size))
                continue
            if self.process_world:
                ctx = _ProcessRank(self.rank, self._size, self.device)
                vals = ctx.all_gather(vals[0])
            dev = vals[0].device
            results.append(torch.cat([v.to(dev) for v in vals], dim))
        return results[0] if single else tuple(results)

    def _get_pool(self) -> concurrent.futures.ThreadPoolExecutor:
        with self._pool_lock:
            if self._pool is None:
                self._pool = concurrent.futures.ThreadPoolExecutor(
                    max_workers=self._size, thread_name_prefix="raft-comms-rank")
            return self._pool

    def run(self, fn: Callable, *args, in_specs=None, out_specs=None,
            timeout_s: Optional[float] = None, keep_blocks: bool = False):
        """Run `fn(rank_view, *blocks)` SPMD over the ranks: each rank
        gets its block of every sharded argument (`in_specs`, one
        PartitionSpec for all arguments or one per argument), its copy of
        every replicated one, and host values as they are. Results follow
        `out_specs`: split dims concatenate the ranks' outputs in rank
        order (on rank 0's device; in a process world, gathered from every
        process), replicated ones are rank 0's; with `keep_blocks` split
        results stay per-rank blocks (a `ShardedArray`, no concatenation:
        how the distributed indexes keep their per-rank tables).
        `timeout_s` (default `self.timeout_s`) bounds every collective
        wait, and in the in-process world the wait for a run of the same
        world that another thread started first (runs of one world take
        turns, as programs on one set of devices do)."""
        in_specs = in_specs if in_specs is not None else P(self.axis)
        out_specs = out_specs if out_specs is not None else P(self.axis)
        specs = ([in_specs] * len(args) if isinstance(in_specs, PartitionSpec)
                 else list(in_specs))
        if len(specs) != len(args):
            raise ValueError(f"{len(args)} arguments, {len(specs)} in_specs")
        timeout = self.timeout_s if timeout_s is None else float(timeout_s)
        cache: dict = {}
        blocks = {r: [self._arg_block(a, s, r, cache) for a, s in zip(args, specs)]
                  for r in self.local_ranks()}
        if self.process_world:
            ctx = _ProcessRank(self.rank, self._size, self.device)
            out = fn(AxisComms(self.axis, self._size, None, _ctx=ctx), *blocks[self.rank])
            return self._assemble([out], out_specs, keep_blocks)
        if not self._run_lock.acquire(timeout=timeout):
            from raft_tpu_torch.comms.resilience import HealthCheckTimeout

            raise HealthCheckTimeout(
                f"another run of this world held its ranks past the {timeout}s deadline")
        try:
            return self._run_ranks(fn, blocks, out_specs, keep_blocks, timeout)
        finally:
            self._run_lock.release()

    def _run_ranks(self, fn, blocks, out_specs, keep_blocks, timeout):
        """One in-process run: each rank's body on a thread of the pool,
        meeting in one exchange."""
        ex = _ThreadExchange(self._size, timeout)

        def rank_main(r):
            ctx = _ThreadRank(ex, r, self.devices[r])
            if ctx.device.type == "cuda":
                torch.cuda.set_device(ctx.device)  # the thread's current device, for cuBLAS
            try:
                return fn(AxisComms(self.axis, self._size, None, _ctx=ctx), *blocks[r])
            except BaseException as e:
                ex.fail(e)
                raise

        if self._size == 1:
            outs = [rank_main(0)]
        else:
            futs = [self._get_pool().submit(rank_main, r) for r in range(self._size)]
            concurrent.futures.wait(futs)
            errs = [f.exception() for f in futs]
            if any(e is not None for e in errs):
                first = ex.error or next(e for e in errs if e is not None)
                raise first
            outs = [f.result() for f in futs]
        return self._assemble(outs, out_specs, keep_blocks)

    def destroy(self):
        """API parity with raft-dask Comms.destroy (comms.py:218): stops
        the rank threads."""
        self.nccl_initialized = False
        with self._pool_lock:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None


def init_comms(resources, mesh=None, axis: str = "data", n_devices: Optional[int] = None,
               device=None) -> Comms:
    """Build a Comms session and inject it into the Resources handle
    (inject_comms_on_handle, raft-dask comms_utils.pyx:27)."""
    c = Comms(mesh=mesh, axis=axis, n_devices=n_devices, device=device)
    resources.set_comms(c)
    return c


def local_handle(resources):
    """raft-dask `local_handle` parity (comms.py:245): the handle's comms."""
    return resources.get_comms()


_MULTIHOST_INITIALIZED = False


def _init_process_group(**kwargs) -> None:
    import torch.distributed as dist

    dist.init_process_group(**kwargs)


def bootstrap_multihost(coordinator_address: Optional[str] = None,
                        num_processes: Optional[int] = None,
                        process_id: Optional[int] = None,
                        max_retries: int = 3,
                        backoff_s: float = 0.05,
                        device=None,
                        timeout_s: Optional[float] = None) -> bool:
    """Multi-controller bootstrap (the raft-dask `Comms.init` / MPI
    moment, comms.py:170) over `torch.distributed.init_process_group`,
    after which `Comms()` spans the processes, one rank each.

    `coordinator_address` is "host:port" (or a full init_method URL);
    `num_processes` and `process_id` are the world size and this rank.
    Where they are None, torch's environment variables (MASTER_ADDR /
    MASTER_PORT / WORLD_SIZE / RANK) rule. `device` is this process's
    rank device (default: cuda:LOCAL_RANK; without a card that raises,
    as `core.config.resolve_device` does: a CPU world is asked for with
    device="cpu"); CUDA ranks use NCCL, CPU ranks gloo. Idempotent: repeat
    calls (and an already-initialized process group) return False.

    Flaky init (a coordinator racing its listeners up, injected chaos at
    site "comms.bootstrap") retries up to `max_retries` times with
    backoff; persistent failures surface as `resilience.RetryExhausted`
    chaining the last error."""
    import os

    global _MULTIHOST_INITIALIZED
    if _MULTIHOST_INITIALIZED:
        return False
    if _process_world_active():
        _MULTIHOST_INITIALIZED = True
        return False
    from raft_tpu_torch.core.config import resolve_device

    device = resolve_device(f"cuda:{int(os.environ.get('LOCAL_RANK', '0'))}"
                            if device is None else device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    kwargs = {"backend": "nccl" if device.type == "cuda" else "gloo"}
    if coordinator_address is not None:
        addr = str(coordinator_address)
        kwargs["init_method"] = addr if "://" in addr else f"tcp://{addr}"
    if num_processes is not None:
        kwargs["world_size"] = int(num_processes)
    if process_id is not None:
        kwargs["rank"] = int(process_id)
    if timeout_s is not None:
        import datetime

        kwargs["timeout"] = datetime.timedelta(seconds=float(timeout_s))

    def _init_once():
        faults.fault_point("comms.bootstrap",
                           rank=process_id if process_id is not None else None)
        _init_process_group(**kwargs)

    from raft_tpu_torch.comms.resilience import retry_with_backoff

    retry_with_backoff(
        _init_once, max_retries=max_retries, base_delay_s=backoff_s,
        retry_on=(faults.FaultInjected, RuntimeError),
        describe="multihost bootstrap",
    )
    _PROCESS_STATE["device"] = device
    _MULTIHOST_INITIALIZED = True
    return True
