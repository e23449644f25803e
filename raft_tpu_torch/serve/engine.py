"""The serving engine: worker loop + searcher adapters + lifecycle
(counterpart of raft_tpu/serve/engine.py).

`SearchServer` turns any built raft_tpu_torch index into an online
service: callers `submit(queries, k)` and get futures; a single worker
thread pulls micro-batches from the `MicroBatcher`, pads them onto the
bucket ladder, runs ONE device search per batch, and scatters rows back.
Execution is deliberately single-worker: one dispatching thread keeps
the device work of consecutive batches in order on the index's stream,
while submitters keep merging on the host meanwhile.

Device discipline: each searcher runs on its index's own device (CUDA
unless the caller built the index on the CPU) and names it on every call
— the worker is a thread of its own, and torch's current CUDA device is
per thread. The merged batch is padded on the host and moves to that
device in one copy; the reply comes back in one device-to-host copy.
Fences go through `core.interruptible.synchronize`, so a watchdog's
`interruptible.cancel` can break a wait that `torch.cuda.synchronize`
could not.

Searcher adapters normalise the three index families (plus the MNMG
distributed trio) to one call: `search(queries, k, probe_scale)` ->
`(values, ids, coverage)`. Auto-resolving engine/score modes resolve by
batch shape, which would make a request's numerics depend on who it was
batched with — the adapters therefore PIN the engine at construction
(flat defaults to the exact "query" engine, PQ to "recon8"), keeping
the serve invariant: merged batched results are bit-identical to the
same request served alone in a batch of the same bucket.

Degraded mode rides the resilience path: construct with `health=`
(a `comms.resilience.RankHealth`) or swap one in live via
`set_health()` — replies then carry `coverage < 1.0` instead of
hanging on a sick rank. Fault site "serve.batch" lets the chaos suite
slow/flake the execution path itself.

Warmup: the port compiles nothing per shape, but the first call of a
shape builds the kernels (`nvcc`) and the library handles. `warmup`
runs every bucket once so no request pays for that; the compile-cache
key set, its `serve.compile_cache.hit` / `miss` counters and the
`compile` events keep the JAX names and here count first executions of
a (bucket, k, probe token) shape.

Deterministic test mode: skip `start()` and call `step()` — it
collects (without lingering) and executes exactly one batch on the
calling thread.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import faults
from raft_tpu_torch.core.interruptible import synchronize
from raft_tpu_torch.core.tracing import trace_range
from raft_tpu_torch.obs import flight as _flight
from raft_tpu_torch.obs import trace as _trace
from raft_tpu_torch.serve.admission import (
    AdmissionConfig,
    AdmissionController,
    ServerClosed,
)
from raft_tpu_torch.serve.batcher import (
    Batch,
    MicroBatcher,
    PendingResult,
    SearchReply,
    bucket_for,
    merge,
    scatter,
)
from raft_tpu_torch.serve.metrics import ServerMetrics

BATCH_SITE = "serve.batch"


# ---------------------------------------------------------------------------
# searcher adapters
# ---------------------------------------------------------------------------

class Searcher:
    """Protocol: one device search per padded batch.

    `search(queries, k, probe_scale, recall_target)` returns
    `(values, ids, coverage)` with `coverage` = served-shard fraction
    (1.0 for local indexes). `probe_scale` in (0, 1] is the admission
    controller's overload degradation knob — adapters with probes apply
    it to n_probes (floor 1); exact searches ignore it. `recall_target`
    is the per-request adaptive-probing knob (neighbors/probe_budget):
    probed adapters resolve it to per-query budgets through the tuned
    `adaptive_probe_policy`, WITHIN the probe_scale-capped n_probes —
    overload composes as a cap on top of adaptivity. None keeps the
    searcher's configured behavior; exact searchers ignore it.
    """

    dim: int

    #: the device the searcher's index lives on: `_dispatch` moves each
    #: padded batch there in one copy. None (a custom searcher) hands
    #: it the host array as is.
    device: Optional[torch.device] = None

    def search(self, queries: np.ndarray, k: int,
               probe_scale: float = 1.0,
               recall_target: Optional[float] = None,
               ) -> Tuple[torch.Tensor, torch.Tensor, float]:
        raise NotImplementedError

    def probe_key(self, probe_scale: float = 1.0,
                  recall_target: Optional[float] = None):
        """Hashable token for how `probe_scale` / `recall_target` shape
        the device work — the compile-cache key component (the JAX
        name; here it keys first executions). Exact searchers ignore
        both (one shape per (bucket, k)); probed searchers return the
        derived n_probes plus the resolved adaptive-plan token (tau is
        a value, so only the plan's STRUCTURE keys shapes), so two
        requests that resolve to the same work share one entry."""
        return None

    # -- live mutation (zero-dip swap-in) ------------------------------

    #: committed-mutation queue (neighbors/mutation.MutationFeed); None
    #: = a static index, the mutation path adds zero work per batch
    _mutation_feed = None

    def attach_mutations(self, feed) -> None:
        """Subscribe this searcher to a `neighbors.mutation.MutationFeed`:
        committed batches published to the feed are applied BETWEEN
        device batches by the serving loop (`_heal_between_batches`),
        never on the request path."""
        self._mutation_feed = feed

    def maybe_apply_mutations(self) -> int:
        """Drain the attached feed and swap in the mutated index — one
        reference assignment, so any in-flight device batch keeps
        scanning the OLD object end to end (zero-dip: coverage never
        drops, and a query untouched by the mutations is bit-identical
        before and after the swap). Called by the server off the
        request path; returns the number of batches applied."""
        feed = self._mutation_feed
        index = getattr(self, "index", None)
        if feed is None or index is None:
            return 0  # static serving, or an exact searcher (no index)
        batches = feed.drain()
        if not batches:
            return 0
        from raft_tpu_torch.neighbors import mutation

        for batch in batches:
            index = mutation.apply_batch(index, batch)
        self.index = index
        return len(batches)

    # -- online integrity (scrub/quarantine/repair off the request path)

    #: integrity.IntegrityWatchdog; None = no scrubbing, the integrity
    #: path adds zero work per batch
    _integrity = None

    def attach_integrity(self, watchdog) -> None:
        """Subscribe this searcher to an `integrity.IntegrityWatchdog`:
        the serving loop runs one bounded scrub slice BETWEEN device
        batches (`_heal_between_batches`), and a detected-bad list is
        quarantined (masked dead) / repaired by reference swap — the
        same zero-dip discipline as mutations."""
        self._integrity = watchdog

    def maybe_scrub(self) -> None:
        """One watchdog tick: scrub slice, quarantine-on-mismatch,
        verified repair. Any index change lands as one reference
        assignment; in-flight batches keep the old object. Called by
        the server off the request path."""
        wd = self._integrity
        index = getattr(self, "index", None)
        if wd is None or index is None:
            return  # static serving, or an exact searcher (no index)
        out = wd.step(index)
        if out is not index:
            self.index = out

    def _coverage(self) -> float:
        """Served-list fraction for local adapters: 1.0 until the
        watchdog quarantines something, then honestly less — dispatch
        marks such replies degraded, exactly like MNMG shard loss."""
        wd = self._integrity
        return 1.0 if wd is None else float(wd.coverage())


def _scaled_probes(n_probes: int, probe_scale: float) -> int:
    """The ONE overload-degradation rule: floor(n_probes * scale),
    never below 1. Documented as floor (not round) so budget
    composition is deterministic: a scale of 0.25 always yields
    floor(n_probes / 4) — round() used to land ABOVE the
    min_probe_scale floor's intent at small n_probes (n_probes=6,
    scale=0.25 -> round(1.5) = 2, not the floor's 1). Pinned by
    tests/test_serve.py::test_scaled_probes_floor_rule."""
    return max(1, int(n_probes * float(probe_scale)))


def _request_params(params, probe_scale: float, recall_target):
    """One request's effective SearchParams: the admission controller's
    probe_scale CAPS n_probes first (floor-with-min-1), then a
    per-request recall_target resolves to per-query budgets WITHIN that
    cap — overload can only shrink work, adaptivity redistributes it."""
    import dataclasses as _dc

    changes = {}
    if probe_scale < 1.0:
        changes["n_probes"] = _scaled_probes(params.n_probes, probe_scale)
    if recall_target is not None:
        changes["recall_target"] = float(recall_target)
    return _dc.replace(params, **changes) if changes else params


def _probed_key(params, probe_scale: float, recall_target):
    """Compile-cache token for a probed searcher: the derived n_probes
    plus the resolved adaptive-plan structure (probe_budget.policy_token
    — tau/min_probes are traced operands, so only adaptive-vs-fixed and
    the bounds structure distinguish compiled programs)."""
    from raft_tpu_torch.neighbors import probe_budget

    p = _request_params(params, probe_scale, recall_target)
    n = _scaled_probes(params.n_probes, probe_scale)
    return (n, probe_budget.policy_token(p, n))


class BruteForceSearcher(Searcher):
    """Exact k-NN over a host/device dataset (`brute_force.knn`);
    probe_scale and recall_target are no-ops (there is nothing
    approximate to shed — every request already gets recall 1.0).

    The dataset moves to its device once, here: a tensor stays on its
    own device unless `device=` names another; a host array goes to
    `device` (CUDA unless the caller passes "cpu")."""

    def __init__(self, dataset, **knn_kwargs):
        from raft_tpu_torch.core.validation import as_input

        self.dataset = as_input(dataset, knn_kwargs.pop("device", None))
        if self.dataset.ndim != 2:
            raise ValueError(f"dataset must be 2-d, got {tuple(self.dataset.shape)}")
        self.device = self.dataset.device
        self.knn_kwargs = knn_kwargs
        self.dim = int(self.dataset.shape[1])

    def search(self, queries, k, probe_scale=1.0, recall_target=None):
        from raft_tpu_torch.neighbors import brute_force

        vals, ids = brute_force.knn(self.dataset, queries, k, device=self.device,
                                    **self.knn_kwargs)
        return vals, ids, 1.0


class IvfFlatSearcher(Searcher):
    def __init__(self, index, search_params=None):
        from raft_tpu_torch.neighbors import ivf_flat

        self.index = index
        self.params = search_params or ivf_flat.SearchParams()
        if self.params.engine == "auto":
            raise ValueError(
                "engine='auto' resolves per batch shape, which would make "
                "a request's numerics depend on its batch-mates; pin an "
                "engine in SearchParams for serving"
            )
        self.dim = int(index.dim)
        self.device = index.device

    def search(self, queries, k, probe_scale=1.0, recall_target=None):
        from raft_tpu_torch.neighbors import ivf_flat

        p = _request_params(self.params, probe_scale, recall_target)
        vals, ids = ivf_flat.search(p, self.index, queries, k)
        return vals, ids, self._coverage()

    def probe_key(self, probe_scale: float = 1.0, recall_target=None):
        return _probed_key(self.params, probe_scale, recall_target)


class IvfPqSearcher(Searcher):
    def __init__(self, index, search_params=None):
        from raft_tpu_torch.neighbors import ivf_pq

        self.index = index
        self.params = search_params or ivf_pq.SearchParams(score_mode="recon8")
        if self.params.score_mode == "auto":
            raise ValueError(
                "score_mode='auto' resolves per batch shape, which would "
                "make a request's numerics depend on its batch-mates; pin "
                "a score_mode in SearchParams for serving"
            )
        self.dim = int(index.dim)
        self.device = index.device

    def search(self, queries, k, probe_scale=1.0, recall_target=None):
        from raft_tpu_torch.neighbors import ivf_pq

        p = _request_params(self.params, probe_scale, recall_target)
        vals, ids = ivf_pq.search(p, self.index, queries, k)
        return vals, ids, self._coverage()

    def probe_key(self, probe_scale: float = 1.0, recall_target=None):
        return _probed_key(self.params, probe_scale, recall_target)


class IvfRabitqSearcher(Searcher):
    """IVF-RaBitQ adapter: the binary-code scan is query-major (per-row
    results are independent of batch-mates) and the rerank depth/query
    bits resolve from process-stable tuned state, never from batch
    shape — so merged batched results stay bit-identical to unbatched
    without pinning anything beyond the params object."""

    def __init__(self, index, search_params=None):
        from raft_tpu_torch.neighbors import ivf_rabitq

        self.index = index
        self.params = search_params or ivf_rabitq.SearchParams()
        self.dim = int(index.dim)
        self.device = index.device

    def search(self, queries, k, probe_scale=1.0, recall_target=None):
        from raft_tpu_torch.neighbors import ivf_rabitq

        p = _request_params(self.params, probe_scale, recall_target)
        vals, ids = ivf_rabitq.search(p, self.index, queries, k)
        return vals, ids, self._coverage()

    def probe_key(self, probe_scale: float = 1.0, recall_target=None):
        return _probed_key(self.params, probe_scale, recall_target)


class MnmgSearcher(Searcher):
    """Distributed IVF (flat or PQ) with the degraded-mode path and
    the replication-era heal loop: searches carry the current
    `RankHealth` mask, replies carry its coverage. `set_health` swaps
    masks atomically between batches (the mask is an array ARGUMENT to
    the SPMD program — no retrace). On a replicated index
    (`mnmg.replicate_index` / build `replication=`), a degraded mask
    fails over losslessly — in-flight traffic keeps coverage 1.0 — and
    the server calls `maybe_heal()` BETWEEN batches, so the
    repair-then-rejoin loop (comms/recovery.py) runs off the request
    path and a healed rank's primary serves again without any caller
    ever seeing a degraded reply.

    `heal_checkpoint` optionally names a checkpoint to rehydrate from
    when a shard has no surviving replica copy (beyond r-1 failures)."""

    def __init__(self, index, kind: str, n_probes: int = 20,
                 engine: Optional[str] = None, health=None,
                 heal_checkpoint: Optional[str] = None,
                 auto_heal: bool = True):
        self.index = index
        self.kind = kind  # "ivf_flat" | "ivf_pq" | "ivf_rabitq"
        self.n_probes = int(n_probes)
        if kind == "ivf_rabitq":
            # ivf_rabitq has ONE engine (the binary-code scan): an
            # explicit engine= is a config error — reject it loudly
            # rather than silently serving different semantics than the
            # caller pinned (the flat/PQ wrong-name reject, moved up
            # here because there is no search-side engine kwarg to
            # forward it to)
            if engine is not None:
                raise ValueError(
                    f"engine={engine!r} is meaningless for ivf_rabitq: "
                    "the binary-code scan is the only engine")
        elif engine is None:
            # per-kind list-major serving default (the engine vocabularies
            # differ: flat's is "list", PQ's is "recon8_list"); an
            # EXPLICIT wrong name still reaches the search's loud reject
            engine = "list" if kind == "ivf_flat" else "recon8_list"
        self.engine = engine
        self.heal_checkpoint = heal_checkpoint
        self.auto_heal = bool(auto_heal)
        self._health = health
        self._health_lock = threading.Lock()
        # the distributed indexes have no `dim` property: flat centers
        # are (n_lists, dim), the PQ/RaBitQ rotation is (rot_dim, dim)
        self.dim = int(index.centers.shape[1] if kind == "ivf_flat"
                       else index.rotation.shape[1])
        self.device = index.comms.device

    def set_health(self, health) -> None:
        with self._health_lock:
            self._health = health

    @property
    def health(self):
        with self._health_lock:
            return self._health

    def search(self, queries, k, probe_scale=1.0, recall_target=None):
        from raft_tpu_torch.comms import mnmg

        health = self.health
        n_probes = _scaled_probes(self.n_probes, probe_scale)
        ad = dict(recall_target=recall_target) if recall_target is not None \
            else {}
        if self.kind == "ivf_rabitq":
            out = mnmg.ivf_rabitq_search(
                self.index, queries, k, n_probes=n_probes,
                query_mode="replicated", health=health, **ad)
        else:
            fn = (mnmg.ivf_flat_search if self.kind == "ivf_flat"
                  else mnmg.ivf_pq_search)
            out = fn(self.index, queries, k, n_probes=n_probes,
                     engine=self.engine, query_mode="replicated",
                     health=health, **ad)
        if isinstance(out, tuple) and len(out) == 2:
            vals, ids = out
            return vals, ids, 1.0
        return out.values, out.ids, float(out.coverage)

    def probe_key(self, probe_scale: float = 1.0, recall_target=None):
        n = _scaled_probes(self.n_probes, probe_scale)
        # distributed adaptive plans are budgets-only (bounds stay off),
        # so the plan structure token is fixed whenever a target is set
        return (n, ("adaptive", False) if recall_target is not None else None)

    def maybe_heal(self) -> bool:
        """One heal-loop turn, called by the server between batches (off
        the request path): when the mask is degraded and the index
        carries replicas (or a heal checkpoint is configured), repair
        the dead ranks' shards and rejoin them behind a verified
        barrier, then publish the healthy mask. Returns True when a
        heal ran. Never raises into the serving loop — an unhealable
        mesh (no copies, barrier timeout) keeps its degraded mask and
        the failover/degraded path keeps answering."""
        if not self.auto_heal:
            return False
        health = self.health
        if health is None or not health.degraded:
            return False
        from raft_tpu_torch.comms import recovery

        if (getattr(self.index, "replicas", None) is None
                and self.heal_checkpoint is None):
            return False  # nothing to heal from; stay degraded
        try:
            with obs.span("serve.heal"):
                index, healed = recovery.heal(
                    self.index.comms, health, self.index,
                    checkpoint=self.heal_checkpoint)
        except Exception as e:  # noqa: BLE001 — the loop must survive
            obs.event("heal_failed", error=repr(e))
            return False
        self.index = index
        # publish compare-and-swap: a prober may have installed a NEWER
        # mask (another rank died) while the repair/barrier ran —
        # clobbering it would un-mask a dead rank until the next probe.
        # The newer mask stays; the next between-batches turn heals it.
        with self._health_lock:
            if self._health is health:
                self._health = healed
        return True

    def maybe_apply_mutations(self) -> int:
        """RankHealth-aware variant: while the mesh is degraded the feed
        stays queued (applying against a partial mesh would leave dead
        ranks' shards stale — replication mirrors must re-derive from
        every touched primary), and the heal loop runs first. Batches
        apply through `comms.mnmg_mutation` so rank-local stores AND
        their replica mirrors mutate coherently."""
        feed = self._mutation_feed
        if feed is None:
            return 0
        health = self.health
        if health is not None and health.degraded:
            return 0  # defer — drain nothing, the feed keeps the batches
        batches = feed.drain()
        if not batches:
            return 0
        from raft_tpu_torch.comms import mnmg_mutation

        index = self.index
        for batch in batches:
            index = mnmg_mutation.apply_batch(index, self.kind, batch)
        self.index = index
        return len(batches)


def as_searcher(index, *, search_params=None, health=None,
                n_probes: int = 20, engine: Optional[str] = None,
                heal_checkpoint: Optional[str] = None,
                auto_heal: bool = True,
                **knn_kwargs) -> Searcher:
    """Coerce `index` to a `Searcher`:

    - an existing `Searcher` passes through,
    - `ivf_flat.Index` / `ivf_pq.Index` / `ivf_rabitq.Index` ->
      pinned-engine adapters (`search_params` forwarded),
    - MNMG `DistributedIvfFlat` / `DistributedIvfPq` /
      `DistributedIvfRabitq` -> `MnmgSearcher` (`health`, `n_probes`,
      `engine`, `heal_checkpoint`, `auto_heal` forwarded),
    - a 2-D array (numpy or a tensor) -> exact `BruteForceSearcher`
      (`knn_kwargs` forwarded to `brute_force.knn`; `device=` places
      a host array, CUDA unless told otherwise).
    """
    if isinstance(index, Searcher):
        return index
    from raft_tpu_torch.neighbors import ivf_flat, ivf_pq, ivf_rabitq

    if isinstance(index, ivf_flat.Index):
        return IvfFlatSearcher(index, search_params)
    if isinstance(index, ivf_pq.Index):
        return IvfPqSearcher(index, search_params)
    if isinstance(index, ivf_rabitq.Index):
        return IvfRabitqSearcher(index, search_params)
    # distributed indexes only exist if comms was imported to build them
    kind = type(index).__name__
    mnmg_kinds = {"DistributedIvfFlat": "ivf_flat",
                  "DistributedIvfPq": "ivf_pq",
                  "DistributedIvfRabitq": "ivf_rabitq"}
    if kind in mnmg_kinds:
        return MnmgSearcher(
            index, mnmg_kinds[kind],
            n_probes=n_probes, engine=engine, health=health,
            heal_checkpoint=heal_checkpoint, auto_heal=auto_heal,
        )
    arr = np.asarray(index) if not hasattr(index, "ndim") else index
    if getattr(arr, "ndim", 0) == 2:
        return BruteForceSearcher(arr, **knn_kwargs)
    raise TypeError(f"cannot serve from {type(index).__name__!r}")


def _fence(*arrays) -> None:
    """Wait for the device work behind a batch's result tensors, through
    `interruptible` (a watchdog's `cancel` breaks the wait)."""
    synchronize(*(a for a in arrays if isinstance(a, torch.Tensor)))


def _to_host(vals, ids) -> Tuple[np.ndarray, np.ndarray]:
    """The result pair as host arrays: one device-to-host copy of both
    when they are f32 / int32 tensors on one device (the ids ride in
    the values' bits)."""
    if (isinstance(vals, torch.Tensor) and isinstance(ids, torch.Tensor)
            and vals.device == ids.device and vals.device.type != "cpu"
            and vals.dtype == torch.float32 and ids.dtype == torch.int32
            and vals.shape == ids.shape):
        both = torch.stack((vals.view(torch.int32), ids)).cpu().numpy()
        return both[0].view(np.float32), both[1]
    return _host(vals), _host(ids)


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


# ---------------------------------------------------------------------------
# the server
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServerConfig:
    """Serving knobs.

    buckets        the shape ladder; merged batches pad to the smallest
                   bucket that fits, so the device sees a few shapes
                   only, each warmed once. The largest bucket is also
                   `max_batch`.
    max_wait_ms    linger window: how long the oldest pending request
                   waits for batch-mates before dispatch.
    admission      backpressure / deadline / degradation policy.
    warmup_k       when set, `start()` runs every bucket once at this
                   k before serving (the first-use kernel build happens
                   at startup, not on the first unlucky caller).
    latency_window ring size for the latency/QPS percentiles.
    idle_poll_s    worker wake-up period when the queue is empty (also
                   bounds how long `stop()` waits for the worker).
    """

    buckets: Tuple[int, ...] = (8, 32, 128, 512)
    max_wait_ms: float = 2.0
    admission: AdmissionConfig = dataclasses.field(default_factory=AdmissionConfig)
    warmup_k: Optional[int] = None
    latency_window: int = 4096
    idle_poll_s: float = 0.05


class SearchServer:
    """Online vector-search server over one searcher/index.

    Threaded mode::

        server = SearchServer(index, config)
        server.start()                      # or `with SearchServer(...) as s:`
        fut = server.submit(queries, k=10)  # from any thread
        reply = fut.result(timeout=1.0)     # .values / .ids / .coverage
        server.metrics.snapshot()["qps"]
        server.stop()

    Deterministic single-thread test mode: never `start()`; call
    `step()` to collect+execute exactly one batch on the calling
    thread.
    """

    def __init__(self, index, config: Optional[ServerConfig] = None, *,
                 metrics: Optional[ServerMetrics] = None, **searcher_kwargs):
        self.config = config or ServerConfig()
        self.searcher = as_searcher(index, **searcher_kwargs)
        self.metrics = metrics or ServerMetrics(self.config.latency_window)
        self.admission = AdmissionController(self.config.admission)
        self.batcher = MicroBatcher(
            buckets=self.config.buckets,
            max_wait_ms=self.config.max_wait_ms,
            admission=self.admission,
            metrics=self.metrics,
            dim=self.searcher.dim,
        )
        self._worker: Optional[threading.Thread] = None
        self._running = False
        # the shapes the serve path has run, keyed the way the bucket
        # ladder is warmed: (bucket, k, probe token) — the token is the
        # searcher's DERIVED probe count (probe_key), not the raw scale,
        # so two overload scales that floor to the same n_probes key as
        # one shape. warmup() pre-populates it; _dispatch() classifies
        # each batch as a compile-cache hit (shape already run) or miss.
        # warmup runs on the caller's thread and may overlap a live
        # worker (re-warm after a mutation/heal), so the set carries
        # its own lock (threadcheck shared-state-race)
        self._compiled_lock = threading.Lock()
        self._compiled: set = set()

    # -- caller surface ------------------------------------------------

    def submit(self, queries, k: int,
               deadline_s: Optional[float] = None,
               recall_target: Optional[float] = None) -> PendingResult:
        """Enqueue one request; thread-safe. See `MicroBatcher.submit`.
        `recall_target` (0, 1]: the request's recall SLO, resolved to
        per-query probe budgets by the searcher (adaptive probing;
        1.0 = the saturated, bit-exact fixed-probe plan)."""
        return self.batcher.submit(queries, k, deadline_s=deadline_s,
                                   recall_target=recall_target)

    def search(self, queries, k: int, timeout: Optional[float] = None,
               deadline_s: Optional[float] = None,
               recall_target: Optional[float] = None) -> SearchReply:
        """Synchronous convenience: submit + wait. In single-thread test
        mode (no worker running) it also drives `step()` itself."""
        fut = self.submit(queries, k, deadline_s=deadline_s,
                          recall_target=recall_target)
        if not self._running:
            while not fut.done():
                if self.step() == 0:
                    break
        return fut.result(timeout)

    def set_health(self, health) -> None:
        """Swap the distributed searcher's liveness mask (no-op route to
        `MnmgSearcher.set_health`; raises for local searchers, which
        have no rank to degrade)."""
        if not hasattr(self.searcher, "set_health"):
            raise TypeError(
                f"{type(self.searcher).__name__} has no health mask")
        self.searcher.set_health(health)

    def attach_mutations(self, feed) -> None:
        """Subscribe the searcher to a committed-mutation feed
        (`neighbors.mutation.MutationFeed`); batches drain between
        device batches — see `Searcher.maybe_apply_mutations`."""
        self.searcher.attach_mutations(feed)

    def attach_integrity(self, watchdog) -> None:
        """Subscribe the searcher to an `integrity.IntegrityWatchdog`:
        one scrub slice runs between device batches, quarantine/repair
        swap in off the request path — see `Searcher.maybe_scrub`."""
        self.searcher.attach_integrity(watchdog)

    def attach_watchtower(self, watchtower) -> None:
        """Attach an `obs.slo.Watchtower` judging this server's traffic
        (terminal outcomes, latencies, coverage, occupancy) — see
        `ServerMetrics.attach_watchtower`."""
        self.metrics.attach_watchtower(watchtower)

    # -- lifecycle -----------------------------------------------------

    def start(self) -> "SearchServer":
        if self._running:
            return self
        if self.batcher.closed:
            raise ServerClosed(
                "SearchServer is one-shot: a stopped server failed its "
                "queued futures and cannot resume — construct a new one"
            )
        if self.config.warmup_k is not None:
            self.warmup(self.config.warmup_k)
        self._running = True
        self._worker = threading.Thread(
            target=self._run, name="raft-tpu-serve-worker", daemon=True)
        self._worker.start()
        return self

    def stop(self) -> None:
        """Stop serving and fail every queued request with
        `ServerClosed`. Terminal: the server cannot be restarted."""
        self._running = False
        self.batcher.close()
        if self._worker is not None:
            self._worker.join(timeout=max(5.0, 10 * self.config.idle_poll_s))
            self._worker = None

    def __enter__(self) -> "SearchServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def warmup(self, k: int, ks: Sequence[int] = ()) -> int:
        """Run every bucket shape for `k` (and any extra `ks`) once with
        throwaway searches; returns the number of (bucket, k) shapes
        touched. Serving then never pays a first-use kernel build or
        library handle creation."""
        import time as _time

        compiled = 0
        with trace_range("raft_tpu_torch.serve.warmup"), obs.span("serve.warmup"):
            for kk in sorted({int(k), *(int(x) for x in ks)}):
                for bucket in self.batcher.buckets:
                    q = self._to_device(
                        np.zeros((bucket, self.searcher.dim), np.float32))
                    t0 = _time.monotonic()
                    vals, ids, _ = self.searcher.search(q, kk)
                    _fence(vals, ids)
                    dur = _time.monotonic() - t0
                    with self._compiled_lock:
                        self._compiled.add(
                            (bucket, kk, self.searcher.probe_key(1.0)))
                    compiled += 1
                    if obs.enabled():
                        # per-bucket first-run time: the cold-start cost
                        # the ladder pays so callers never do
                        obs.histogram("serve.warmup_compile_s").observe(dur)
                        obs.event("compile", phase="warmup", bucket=bucket,
                                  k=kk, dur_s=dur)
        return compiled

    # -- execution -----------------------------------------------------

    def _to_device(self, padded: np.ndarray):
        """The merged host batch on the searcher's device, in one copy
        (a custom searcher without a device gets the host array)."""
        dev = getattr(self.searcher, "device", None)
        if dev is None:
            return padded
        return torch.from_numpy(padded).to(dev)

    def _run(self) -> None:
        while self._running:
            try:
                batch = self.batcher.collect(timeout_s=self.config.idle_poll_s)
                if batch is None:
                    self._heal_between_batches()
                    continue
                self._execute(batch)
                self._heal_between_batches()
            except Exception as e:  # noqa: BLE001 — the loop must survive
                # `_execute` never raises, so anything landing here is a
                # batcher/heal bug: record the last seconds of timeline
                # (the post-mortem a dead worker would otherwise take
                # with it) and keep serving — a dead worker strands
                # every queued caller.
                obs.event("serve_worker_error", error=repr(e))
                _flight.maybe_dump("serve.worker.exception", error=repr(e))
        # drain: anything still queued fails with ServerClosed in close()

    def _heal_between_batches(self) -> None:
        """Off-request-path maintenance hook: a degraded MNMG searcher
        repairs and rejoins its dead ranks BETWEEN batches (replica
        failover keeps in-flight traffic at coverage 1.0 meanwhile) —
        see `MnmgSearcher.maybe_heal` — and committed mutation batches
        swap in here too (`Searcher.maybe_apply_mutations`), so a live
        upsert/delete never touches the request path. Heal runs first:
        mutations defer while the mesh is degraded. The integrity
        watchdog ticks last (`Searcher.maybe_scrub`) so its slice hashes
        the index the NEXT batch will actually serve."""
        mh = getattr(self.searcher, "maybe_heal", None)
        if mh is not None:
            mh()
        self.searcher.maybe_apply_mutations()
        self.searcher.maybe_scrub()

    def step(self, timeout_s: float = 0.0) -> int:
        """Single-thread test mode: collect one batch (no linger beyond
        `timeout_s`) and execute it on the calling thread. Returns the
        number of requests answered (delivered, expired, or failed)."""
        expired_before = self.metrics.expired  # int read; no ring copy
        batch = self.batcher.collect(timeout_s=timeout_s)
        served = self.metrics.expired - expired_before  # collect-time drops
        if batch is not None:
            served += self._execute(batch)
            self._heal_between_batches()
        return int(served)

    def _execute(self, batch: Batch) -> int:
        """Run one merged batch on the device and deliver per-request
        replies; never raises — any failure (searcher error, injected
        chaos, even a batching bug) is delivered through the futures so
        the worker survives and no caller is stranded. Returns the
        number of requests answered (delivered, expired, or failed)."""
        total = len(batch.requests)
        try:
            self._dispatch(batch)
        except Exception as e:
            undelivered = [r for r in batch.requests if not r.reply.done()]
            for req in undelivered:
                req.reply._set_exception(e)
                _trace.complete(req.trace, outcome="failed", error=repr(e))
            self.metrics.observe_failed(len(undelivered))
        return total

    def _dispatch(self, batch: Batch) -> None:
        import time as _time

        # chaos site: a slow/flaky device dispatch (the serving analogue
        # of a straggling rank); no-op without an installed plan
        faults.fault_point(BATCH_SITE)
        now = _time.monotonic()
        live = []
        for req in batch.requests:
            # a request can expire between collection and dispatch (e.g.
            # behind an injected slow batch) — still cheaper to drop now
            # than to deliver a result its caller already abandoned
            if self.admission.expired(req.deadline, now):
                self.batcher._expire(req)
            else:
                live.append(req)
        if not live:
            return
        batch = Batch(requests=live, k=batch.k,
                      recall_target=batch.recall_target)
        bucket = bucket_for(batch.rows, self.batcher.buckets)
        padded, valid = merge(batch, self.searcher.dim, bucket)
        padded = self._to_device(padded)
        scale = self.admission.probe_scale(self.batcher.pending_rows)
        key = (bucket, batch.k,
               self.searcher.probe_key(scale, batch.recall_target))
        with self._compiled_lock:
            cached = key in self._compiled
        if obs.enabled():
            obs.counter("serve.compile_cache.hit" if cached
                        else "serve.compile_cache.miss").inc()
            obs.event("compile", phase="serve", bucket=bucket, k=batch.k,
                      cached=cached)
        for req in batch.requests:
            if req.trace is not None:
                req.trace.stamp("dispatched", bucket=bucket, k=batch.k,
                                cached=cached, probe=repr(key[2]))
        with trace_range("raft_tpu_torch.serve.batch"), \
                obs.span("serve.batch", bucket=bucket, k=batch.k,
                         rows=valid, pad_rows=bucket - valid,
                         cached=cached):
            vals, ids, coverage = self.searcher.search(
                padded, batch.k, probe_scale=scale,
                recall_target=batch.recall_target)
            _fence(vals, ids)
        # mark compiled only after the shape actually ran: a failed
        # dispatch must not fake a cache hit for the next batch
        with self._compiled_lock:
            self._compiled.add(key)
        for req in batch.requests:
            if req.trace is not None:
                req.trace.stamp("fenced")
        vals, ids = _to_host(vals, ids)
        done_t = _time.monotonic()
        outcome = "degraded" if float(coverage) < 1.0 else "ok"
        latencies = []
        for req, reply in scatter(batch, vals, ids, coverage):
            if req.trace is not None:
                req.trace.stamp("scattered", coverage=float(coverage))
                _trace.complete(req.trace, outcome=outcome)
            req.reply._set(reply)
            latencies.append(done_t - req.submit_t)
        self.metrics.observe_batch(
            n_requests=len(batch.requests),
            valid_rows=valid,
            bucket_rows=bucket,
            latencies_s=latencies,
            coverage=coverage,
        )
