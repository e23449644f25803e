"""Dynamic micro-batching for online vector search (counterpart of
raft_tpu/serve/batcher.py).

The kernels reach their best rate at saturating query-batch shapes;
online traffic arrives as a trickle of small, differently-shaped
requests. This module is the bridge — the batching front-end of the
shape-bucketed serving pattern:

  coalesce   pending requests merge (row-concatenated) up to
             `max_batch` rows, waiting at most `max_wait_ms` after the
             first request so a lone caller is never parked behind an
             empty queue;
  bucket     the merged row count pads up to a small LADDER of bucket
             shapes (`buckets`, e.g. 8/32/128/512) — every batch runs at
             one of a few shapes the server warmed, the same padding
             discipline as `neighbors/batch_loader.py`'s uniform blocks;
  scatter    the merged `(values, ids)` rows slice back to per-request
             replies, delivered through `PendingResult` futures.

Only same-`k` requests merge (k is a static shape of the select
kernels), and only same-`recall_target` requests merge (the target
resolves to one probe-budget plan per batch); mixed traffic simply
splits across consecutive batches.
Expired requests are dropped at collection time — see
`serve.admission` — and `faults` sites `serve.submit` / `serve.batch`
let the chaos suite inject slow/flaky serving paths.
"""

from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch.core import faults
from raft_tpu_torch.obs import trace as _trace
from raft_tpu_torch.serve.admission import (
    AdmissionController,
    DeadlineExceeded,
    ServerClosed,
)
from raft_tpu_torch.serve.metrics import ServerMetrics

SUBMIT_SITE = "serve.submit"


class SearchReply(NamedTuple):
    """Per-request result: best-first `(values, ids)` rows plus the
    degraded-mode shard `coverage` (1.0 when every shard answered —
    mirrors `comms.resilience.DegradedSearchResult`)."""

    values: np.ndarray
    ids: np.ndarray
    coverage: float


class PendingResult:
    """Future handed back by `submit`: one event, one slot."""

    def __init__(self):
        self._event = threading.Event()
        self._value: Optional[SearchReply] = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> SearchReply:
        """Block until delivery; raises the request's failure
        (`DeadlineExceeded`, `ServerClosed`, a searcher error) or
        `TimeoutError` if `timeout` elapses first."""
        if not self._event.wait(timeout):
            raise TimeoutError("result not ready")
        if self._exc is not None:
            raise self._exc
        assert self._value is not None
        return self._value

    def _set(self, value: SearchReply) -> None:
        self._value = value
        self._event.set()

    def _set_exception(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()


@dataclasses.dataclass
class _Request:
    queries: np.ndarray  # (n, dim) f32, host-resident until merge
    k: int
    n: int
    deadline: Optional[float]  # absolute monotonic, None = no deadline
    submit_t: float
    reply: PendingResult
    recall_target: Optional[float] = None  # adaptive-probing SLO knob
    trace: Optional[_trace.TraceCtx] = None  # request-scope trace (obs on)


@dataclasses.dataclass
class Batch:
    """One collected micro-batch (all requests share `k` AND
    `recall_target` — the target resolves to one probe-budget plan per
    batch, so mixed targets split across consecutive batches exactly
    like mixed k)."""

    requests: List[_Request]
    k: int
    recall_target: Optional[float] = None

    @property
    def rows(self) -> int:
        return sum(r.n for r in self.requests)


def bucket_for(rows: int, buckets: Sequence[int]) -> int:
    """Smallest ladder bucket >= rows (rows is bounded by buckets[-1]
    because max_batch == buckets[-1])."""
    for b in buckets:
        if rows <= b:
            return int(b)
    raise ValueError(f"{rows} rows exceed the largest bucket {buckets[-1]}")


def merge(batch: Batch, dim: int, bucket: int, dtype=np.float32) -> Tuple[np.ndarray, int]:
    """Row-concatenate the batch's queries and zero-pad to `bucket`
    rows; returns (padded (bucket, dim) array, valid rows). Zero rows
    are real queries to the kernels — their results are sliced away by
    `scatter`, never delivered."""
    valid = batch.rows
    out = np.zeros((bucket, dim), dtype)
    lo = 0
    for req in batch.requests:
        out[lo:lo + req.n] = req.queries
        lo += req.n
    return out, valid


def scatter(batch: Batch, values: np.ndarray, ids: np.ndarray,
            coverage: float) -> List[Tuple[_Request, SearchReply]]:
    """Slice merged result rows back to per-request replies (row order
    is the merge order)."""
    out = []
    lo = 0
    for req in batch.requests:
        reply = SearchReply(values[lo:lo + req.n], ids[lo:lo + req.n],
                            float(coverage))
        out.append((req, reply))
        lo += req.n
    return out


class MicroBatcher:
    """The request queue: admission-gated `submit` on the caller side,
    `collect` on the worker side. One condition variable serialises
    both; `collect` holds the lock only while scanning/popping — device
    execution happens outside (in the engine), so submitters are never
    blocked behind a running batch."""

    def __init__(
        self,
        buckets: Sequence[int],
        max_wait_ms: float,
        admission: AdmissionController,
        metrics: ServerMetrics,
        dim: int,
    ):
        buckets = tuple(sorted(int(b) for b in buckets))
        if not buckets or buckets[0] <= 0:
            raise ValueError(f"need positive bucket sizes, got {buckets!r}")
        self.buckets = buckets
        self.max_batch = buckets[-1]
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.admission = admission
        self.metrics = metrics
        self.dim = int(dim)
        self._dq: collections.deque = collections.deque()
        self._cond = threading.Condition()
        self._pending_rows = 0
        self._closed = False

    # -- caller side ---------------------------------------------------

    @property
    def pending_rows(self) -> int:
        # monitoring fast path: single GIL-atomic int read, stale-by-one
        # is fine for a gauge (taking the lock here would let a slow
        # scraper contend with the submit path)
        return self._pending_rows  # raftlint: disable=lock-discipline

    @property
    def closed(self) -> bool:
        # GIL-atomic bool read; close() is one-way, a stale False only
        # delays the caller until the locked check in submit()
        return self._closed  # raftlint: disable=lock-discipline

    def submit(self, queries, k: int,
               deadline_s: Optional[float] = None,
               recall_target: Optional[float] = None) -> PendingResult:
        """Enqueue one request; returns its future. Validates shape
        here (fail fast, in the caller's thread, with the caller's
        stack) and applies admission policy under the queue lock.
        `recall_target` (0, 1]: the request's recall SLO — resolved by
        the searcher to per-query probe budgets (adaptive probing);
        only same-target requests coalesce into one batch."""
        if isinstance(queries, torch.Tensor):
            # requests are merged on the host: one copy back for a
            # caller that holds its queries on a device
            queries = queries.detach().cpu().numpy()
        q = np.asarray(queries, np.float32)
        if q.ndim == 1:
            q = q[None, :]
        if q.ndim != 2 or q.shape[0] == 0:
            raise ValueError(f"queries must be (n, dim) with n >= 1, got {q.shape}")
        if q.shape[1] != self.dim:
            raise ValueError(f"query dim {q.shape[1]} != index dim {self.dim}")
        if q.shape[0] > self.max_batch:
            raise ValueError(
                f"{q.shape[0]} query rows exceed the largest bucket "
                f"({self.max_batch}); split the request (batch_loader helps)"
            )
        k = int(k)
        if k <= 0:
            raise ValueError("k must be positive")
        if recall_target is not None:
            recall_target = float(recall_target)
            if not (0.0 < recall_target <= 1.0):
                raise ValueError(
                    f"recall_target must be in (0, 1], got {recall_target}")
        # chaos site: slow/flaky ingress (an overloaded frontend, a
        # flaky RPC hop) — no-op without an installed FaultPlan
        faults.fault_point(SUBMIT_SITE)
        req = _Request(
            queries=q,
            k=k,
            n=int(q.shape[0]),
            deadline=self.admission.deadline_for(deadline_s),
            submit_t=time.monotonic(),
            reply=PendingResult(),
            recall_target=recall_target,
            trace=_trace.begin(),
        )
        if req.trace is not None:
            req.trace.stamp("admitted", rows=req.n, k=k)
        with self._cond:
            if self._closed:
                raise ServerClosed("server is stopped")
            try:
                # the two lambdas are evaluated by Condition.wait_for
                # with this same lock RE-ACQUIRED (we are inside `with
                # self._cond`), not lock-free as they lexically appear
                self.admission.admit(
                    req.n,
                    lambda: self._pending_rows,  # raftlint: disable=lock-discipline
                    self._cond,
                    lambda: self._closed,  # raftlint: disable=lock-discipline
                )
            except Exception:
                self.metrics.observe_reject()
                _trace.complete(req.trace, outcome="rejected")
                raise
            self._dq.append(req)
            self._pending_rows += req.n
            self.metrics.observe_submit()
            self.metrics.set_queue_depth(self._pending_rows)
            self._cond.notify_all()
        return req.reply

    # -- worker side ---------------------------------------------------

    def _expire(self, req: _Request) -> None:
        wait_s = time.monotonic() - req.submit_t
        req.reply._set_exception(DeadlineExceeded(
            f"deadline passed after {wait_s:.3f}s "
            "in queue; request was dropped without executing"
        ))
        # queue-wait-until-drop: admission tuning must see the requests
        # it killed, not just the survivors' latencies
        self.metrics.observe_expired(wait_s=wait_s)
        _trace.complete(req.trace, outcome="expired")

    def _take_locked(self, now: float) -> List[_Request]:
        """Pop one batch's worth of live same-(k, recall_target)
        requests (FIFO by the oldest live request's key — the target
        resolves to ONE probe-budget plan per device batch); expired
        requests encountered on the way are failed and removed. Lock
        held by caller."""
        taken: List[_Request] = []
        keep: List[_Request] = []
        key0 = None
        rows = 0
        expired = 0
        for req in self._dq:
            if self.admission.expired(req.deadline, now):
                self._pending_rows -= req.n
                self._expire(req)
                expired += 1
                continue
            if key0 is None:
                key0 = (req.k, req.recall_target)
            if ((req.k, req.recall_target) == key0
                    and rows + req.n <= self.max_batch):
                taken.append(req)
                rows += req.n
            else:
                keep.append(req)
        self._dq = collections.deque(keep)
        for req in taken:
            self._pending_rows -= req.n
            if req.trace is not None:
                req.trace.stamp("coalesced")
        self.metrics.set_queue_depth(self._pending_rows)
        if taken or expired:
            # rows left the queue (pops or expiries): wake any blocked
            # submitters — including when EVERYTHING expired and both
            # taken and keep are empty
            self._cond.notify_all()
        return taken

    def collect(self, timeout_s: Optional[float] = None) -> Optional[Batch]:
        """Gather the next micro-batch: wait up to `timeout_s` for a
        first request, then linger `max_wait_ms` (from that request's
        arrival) for more to coalesce — returning early once the merged
        rows reach the largest bucket. None when idle past the timeout
        or closed-and-drained."""
        with self._cond:
            deadline = None if timeout_s is None else time.monotonic() + timeout_s
            while not self._dq:
                if self._closed:
                    return None
                if deadline is None:
                    self._cond.wait()
                else:
                    remaining = deadline - time.monotonic()
                    if remaining <= 0 or not self._cond.wait(timeout=remaining):
                        return None
            # linger window anchored at the oldest pending arrival so a
            # request never waits more than max_wait_ms for company
            linger_until = self._dq[0].submit_t + self.max_wait_s
            while (self._pending_rows < self.max_batch
                   and not self._closed):
                remaining = linger_until - time.monotonic()
                if remaining <= 0:
                    break
                self._cond.wait(timeout=remaining)
            taken = self._take_locked(time.monotonic())
        if not taken:
            return None
        return Batch(requests=taken, k=taken[0].k,
                     recall_target=taken[0].recall_target)

    def drain_expired(self) -> int:
        """Fail every expired queued request now (periodic hygiene for
        idle servers); returns the number dropped."""
        now = time.monotonic()
        dropped = 0
        with self._cond:
            keep = []
            for req in self._dq:
                if self.admission.expired(req.deadline, now):
                    self._pending_rows -= req.n
                    self._expire(req)
                    dropped += 1
                else:
                    keep.append(req)
            self._dq = collections.deque(keep)
            self.metrics.set_queue_depth(self._pending_rows)
            if dropped:
                self._cond.notify_all()
        return dropped

    def close(self) -> int:
        """Stop admitting; fail every queued request with
        `ServerClosed`. Returns the number failed."""
        with self._cond:
            self._closed = True
            failed = 0
            while self._dq:
                req = self._dq.popleft()
                self._pending_rows -= req.n
                req.reply._set_exception(ServerClosed(
                    "server stopped before the request was served"))
                failed += 1
            self._pending_rows = 0
            self.metrics.set_queue_depth(0)
            self._cond.notify_all()
        return failed
