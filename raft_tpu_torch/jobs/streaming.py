"""Intra-stage resume for streaming work: the batch-boundary protocol
(counterpart of raft_tpu/jobs/streaming.py).

The runner's manifest makes whole STAGES resumable; this module makes
the long stages resumable INSIDE themselves, at batch boundaries — the
difference between "a preempted 100M build restarts its 3-hour extend"
and "it loses at most one batch". Two helpers, one discipline:

- `resumable_extend_from_file`: the streaming IVF build loop
  (`io.FileBatchLoader` → repeated `ivf_*.extend`). Every
  `checkpoint_every` batches it commits the WHOLE index (kmeans
  centers + partially-filled list tables + slot ids, via the index's
  own CRC'd `save`) plus a cursor sidecar (batch number, id offset)
  into the stage's scratch dir; a killed run reloads the checkpoint,
  re-opens the loader at the cursor (`FileBatchLoader(start_batch=)`
  yields a bit-identical tail), and produces a **bit-identical** index
  to an uninterrupted build.
- `resumable_write_npy`: chunked dataset synthesis (the
  `BENCH_10M_PARTIAL` failure class): the `.npy` grows chunk by chunk
  behind a durable progress marker; a resume truncates any torn tail
  back to the last committed chunk and continues — given a
  deterministic per-chunk generator, the finished file is byte-equal
  to a one-shot write.

MNMG variants (`checkpointed_mnmg_build`, `resumable_extend_local_from_
file`) ride the replication/recovery machinery: checkpoints go through
`mnmg_ckpt` saves and resumes through `resilience.rehydrate`, so a
preempted distributed build re-enters via the same verified/healing
load path a crashed rank does. Decisions that every process of a
`torch.distributed` world must take alike (resume or build, the resume
cursor, the batch count) are agreed by a MIN / MAX all-reduce over the
process group; a single process passes its own value through.

Device: a resumed checkpoint loads onto the device of the index the
caller passed (the trained cold-start seed), ids are made there, and
the timed extend is fenced through `core.interruptible.synchronize`.
The resume is bit-identical on the card because the extend path of the
three families has no atomic scatter (no `index_add_`): the same inputs
give the same bits.

Chaos: every checkpoint commit is followed by
`faults.crash_point("job.stage.crash")` — an injected kill_rank fault
SIGKILLs the process on its count-th boundary, which is how the drills
prove the artifact on disk (not process luck) carries the resume. The
same site doubles as a flaky transient (`fault_point`) the supervised
runner retries.
"""

from __future__ import annotations

import os
import time
from typing import Callable, Optional, Tuple

import numpy as np

import torch

from raft_tpu_torch import obs
from raft_tpu_torch.core import faults
from raft_tpu_torch.core.interruptible import synchronize
from raft_tpu_torch.io import FileBatchLoader, probe_file
from raft_tpu_torch.jobs.jobdir import JobDir, fingerprint_of

STREAM_CRASH_SITE = "job.stage.crash"

#: index kinds the streaming-build checkpoint protocol understands
STREAM_KINDS = ("ivf_flat", "ivf_pq", "ivf_rabitq")


def _index_module(kind: str):
    """The `neighbors` module for a streamable index kind (lazy: jobs'
    layer allowance is core/io/comms/obs, so neighbors resolves at call
    time like every sanctioned upward reference)."""
    if kind == "ivf_flat":
        from raft_tpu_torch.neighbors import ivf_flat as mod
    elif kind == "ivf_pq":
        from raft_tpu_torch.neighbors import ivf_pq as mod
    elif kind == "ivf_rabitq":
        from raft_tpu_torch.neighbors import ivf_rabitq as mod
    else:
        raise ValueError(
            f"unknown streamable index kind {kind!r}; one of {STREAM_KINDS}")
    return mod


def _ctx_hooks(ctx, scratch, heartbeat, preempt):
    """Resolve (scratch, heartbeat, preempt) from an optional
    `StageContext` — streaming helpers run identically under the runner
    or standalone (tests, ad-hoc scripts)."""
    if ctx is not None:
        scratch = scratch or ctx.scratch()
        heartbeat = heartbeat or ctx.heartbeat
        preempt = preempt or ctx.preempt_point
    if scratch is None:
        raise ValueError("need a scratch dir: pass ctx= or scratch=")
    os.makedirs(scratch, exist_ok=True)
    return scratch, heartbeat or (lambda: None), preempt or (lambda: None)


def resumable_extend_from_file(
    kind: str,
    index,
    path: str,
    batch_rows: int,
    *,
    ctx=None,
    scratch: Optional[str] = None,
    start_id: int = 0,
    checkpoint_every: int = 1,
    depth: int = 3,
    heartbeat: Optional[Callable[[], None]] = None,
    preempt: Optional[Callable[[], None]] = None,
    on_batch: Optional[Callable[[int, int, float], None]] = None,
) -> Tuple[object, dict]:
    """Stream an on-disk dataset into `index` via repeated
    `ivf_<kind>.extend`, checkpointing at batch boundaries so a killed
    run resumes bit-identically (module docstring). `index` is the
    freshly-trained (empty-table) index; on resume it is REPLACED by the
    checkpointed one — the caller's trained state is only the cold-start
    seed. `on_batch(batch_no, valid_rows, extend_seconds)` is the bench
    timing hook (the extend is fenced before the clock stops). Returns
    (index, stats)."""
    mod = _index_module(kind)
    scratch, heartbeat, preempt = _ctx_hooks(ctx, scratch, heartbeat, preempt)
    dev = index.device

    cursor_path = os.path.join(scratch, "stream_cursor.json")
    # per-batch checkpoint names + cursor-written-LAST make the two-file
    # commit crash-atomic: a kill between the index save and the cursor
    # write leaves the cursor pointing at the PREVIOUS (intact, matching)
    # checkpoint, so the resume re-extends from exactly that state — the
    # orphan newer save is swept at the next commit. A shared mutable
    # checkpoint name would instead pair a new index with an old cursor
    # and double-ingest a batch.
    ckpt_of = lambda n: os.path.join(scratch, f"stream_index.{n}.ckpt")  # noqa: E731
    probe_rows = int(probe_file(path)[1][0])
    config = fingerprint_of({
        "kind": kind, "path": os.path.abspath(path), "n_rows": probe_rows,
        "batch_rows": int(batch_rows), "start_id": int(start_id),
    })

    b0, offset = 0, int(start_id)
    cur = JobDir.read_json(cursor_path)
    if (cur and cur.get("config") == config and int(cur.get("batch", 0)) > 0
            and os.path.exists(ckpt_of(int(cur["batch"])))):
        # a stale cursor (changed file/geometry) fails this gate and the
        # build starts over — never resumes into different inputs
        b0, offset = int(cur["batch"]), int(cur["offset"])
        index = mod.load(ckpt_of(b0), device=dev)
        obs.event("job", action="stream_resume", index_kind=kind, batch=b0,
                  offset=offset)
    run_start_offset = offset

    def commit(batch_no: int, id_offset: int) -> None:
        mod.save(ckpt_of(batch_no), index)  # CRC'd atomic container write
        JobDir.write_json(cursor_path, {"config": config, "batch": batch_no,
                                        "offset": id_offset})
        # cursor is durable: superseded checkpoints are now unreachable
        keep = os.path.basename(ckpt_of(batch_no))
        for name in os.listdir(scratch):
            if (name.startswith("stream_index.") and name.endswith(".ckpt")
                    and name != keep):
                try:
                    os.remove(os.path.join(scratch, name))
                except OSError:
                    pass  # a sweep miss only costs disk, never correctness
        obs.event("job", action="stream_checkpoint", index_kind=kind,
                  batch=batch_no, offset=id_offset)
        # AFTER the commit: the kill-and-resume drills must prove the
        # artifact on disk carries the resume, not in-process luck
        faults.crash_point(STREAM_CRASH_SITE)

    loader = FileBatchLoader(path, batch_rows, depth=depth, copy=False,
                             start_batch=b0)
    n_batches, b = loader.n_batches, b0
    for batch, valid in loader:
        # transient-failure flavor of the site: an armed flaky fault
        # raises FaultInjected here and the supervised runner retries
        # the stage, which re-enters through the cursor
        faults.fault_point(STREAM_CRASH_SITE)
        ids = torch.arange(offset, offset + valid, dtype=torch.int32, device=dev)
        t0 = time.perf_counter() if on_batch is not None else 0.0
        index = mod.extend(index, batch[:valid], ids)
        if on_batch is not None:
            synchronize(index.codes if hasattr(index, "codes") else index.list_data)
            on_batch(b, int(valid), time.perf_counter() - t0)
        offset += valid
        b += 1
        if b == n_batches or (checkpoint_every > 0
                              and b % checkpoint_every == 0):
            commit(b, offset)
            preempt()  # a pending SIGTERM suspends here, state durable
        heartbeat()
    # rows_ingested is CUMULATIVE (everything the index now holds from
    # this stream); rows_this_run is what THIS invocation ingested —
    # throughput must divide by the latter, or a resumed tail run banks
    # the whole file's rows against the tail's wall clock
    return index, {"batches": int(b - b0), "resumed_from_batch": int(b0),
                   "rows_ingested": int(offset - start_id),
                   "rows_this_run": int(offset - run_start_offset),
                   "total_rows": int(probe_rows)}


def resumable_mutate(
    kind: str,
    index,
    ops,
    *,
    ctx=None,
    scratch: Optional[str] = None,
    ckpt_every: int = 8,
    slack: int = 0,
    heartbeat: Optional[Callable[[], None]] = None,
    preempt: Optional[Callable[[], None]] = None,
    on_op: Optional[Callable[[int, str], None]] = None,
) -> Tuple[object, dict]:
    """Apply a scripted mutation sequence to `index` through a
    crash-atomic `neighbors.mutation.Mutator` rooted in the stage
    scratch, under the runner's supervision. `ops` is a sequence of
    `apply_batch` shapes: ``("upsert", vectors, ids)``, ``("delete",
    ids)``, ``("rebalance",)`` — a rebalance-only sequence IS the
    background compaction stage.

    Resume contract: the mutator's log dedupes re-issued ops by
    sequence number, so a killed/preempted run re-enters with the SAME
    `ops` list and converges on the bit-identical committed state
    (`index` is only the cold-start seed — a committed checkpoint in
    scratch replaces it, the `resumable_extend_from_file` contract).
    Preemption suspends at commit boundaries, where state is durable.
    Returns (index, stats)."""
    from raft_tpu_torch.neighbors import mutation

    scratch, heartbeat, preempt = _ctx_hooks(ctx, scratch, heartbeat, preempt)
    mut = mutation.Mutator(scratch, index, kind=kind,
                           ckpt_every=ckpt_every, slack=slack)
    resumed_at = mut.applied
    for i, op in enumerate(ops):
        before = mut.index
        if op[0] == "upsert":
            mut.upsert(op[1], op[2])
        elif op[0] == "delete":
            mut.delete(op[1])
        elif op[0] == "rebalance":
            mut.rebalance()
        else:
            raise ValueError(f"unknown mutation op {op[0]!r}")
        # transient-failure flavor: an armed flaky fault aborts the
        # stage BETWEEN ops — everything up to here is logged, so the
        # supervised retry re-enters through the log and skips it
        faults.fault_point(mutation.TOMBSTONE_SITE)
        if on_op is not None and mut.index is not before:
            on_op(i, op[0])
        heartbeat()
        if int(mut.index.mut_cursor) == mut.applied:
            preempt()  # just committed: a pending SIGTERM suspends here
    index = mut.commit()
    obs.event("job", action="mutation_commit", index_kind=kind,
              ops=len(ops), cursor=mut.applied)
    return index, {"ops": int(len(ops)), "resumed_at": int(resumed_at),
                   "applied": int(mut.applied),
                   "live_rows": int(mutation.live_rows(index)),
                   "tombstones": int(index.n_tombstones)}


def resumable_scrub(
    kind: str,
    index,
    *,
    ctx=None,
    scratch: Optional[str] = None,
    budget_lists: int = 8,
    laps: int = 1,
    skip=(),
    heartbeat: Optional[Callable[[], None]] = None,
    preempt: Optional[Callable[[], None]] = None,
    on_slice: Optional[Callable[[int, list], None]] = None,
) -> Tuple[list, dict]:
    """Walk `laps` full integrity passes over a live index in bounded
    `budget_lists` slices (raft_tpu_torch/integrity Scrubber), under the
    runner's supervision. Scrubbing is read-only, so the ONLY durable
    state is the scrub cursor — committed to `scrub_cursor.json` after
    every slice (cursor-written-LAST, the batch-boundary discipline),
    then `faults.crash_point("integrity.scrub.crash")`: a SIGKILL at
    any point resumes from the committed cursor and re-hashes at most
    one slice twice (at-least-once scanning — a repeated slice costs
    time, never correctness). The cursor is fingerprint-gated on
    (kind, geometry, committed mut_cursor), so a scrub never resumes
    into a different index state.

    Returns (mismatches, stats): mismatches are (field, list_id) pairs
    (list_id -1 = a table-granularity field), stats carries
    lists_scanned/mismatches/laps plus the resume point."""
    from raft_tpu_torch.integrity.scrub import SCRUB_CRASH_SITE, Scrubber

    scratch, heartbeat, preempt = _ctx_hooks(ctx, scratch, heartbeat, preempt)
    cursor_path = os.path.join(scratch, "scrub_cursor.json")
    n_lists = int(index.n_lists)
    config = fingerprint_of({"kind": kind, "n_lists": n_lists,
                             "width": int(index.slot_rows.shape[1]),
                             "mut_cursor": int(index.mut_cursor)})
    sc = Scrubber(kind, budget_lists=budget_lists)
    lap = 0
    cur = JobDir.read_json(cursor_path)
    if cur and cur.get("config") == config:
        # a stale cursor (different index state) fails the gate and the
        # walk starts over — never resumes into other content
        sc.cursor = int(cur.get("cursor", 0)) % max(n_lists, 1)
        lap = int(cur.get("lap", 0))
        obs.event("job", action="scrub_resume", index_kind=kind,
                  cursor=sc.cursor, lap=lap)
    resumed_at = int(lap * n_lists + sc.cursor)
    bad: list = []
    while lap < int(laps):
        # transient-failure flavor: an armed flaky fault raises here
        # and the supervised runner retries through the cursor
        faults.fault_point(SCRUB_CRASH_SITE)
        laps_before = sc.laps
        hits = sc.slice_scan(index, skip=skip)
        bad.extend(hits)
        if sc.laps > laps_before:
            lap += 1
        JobDir.write_json(cursor_path, {"config": config,
                                        "cursor": sc.cursor, "lap": lap})
        # AFTER the cursor commit: the kill-and-resume drill must prove
        # the cursor on disk carries the walk, not in-process luck
        faults.crash_point(SCRUB_CRASH_SITE)
        if on_slice is not None:
            on_slice(sc.cursor, hits)
        heartbeat()
        if sc.cursor == 0:
            preempt()  # lap boundary: a pending SIGTERM suspends here
    obs.event("job", action="scrub_done", index_kind=kind,
              lists_scanned=sc.lists_scanned, mismatches=len(bad))
    return bad, {"lists_scanned": int(sc.lists_scanned),
                 "mismatches": int(len(bad)),
                 "laps": int(lap), "resumed_at": resumed_at}


def resumable_write_npy(
    path: str,
    rows: int,
    dim: int,
    chunk_rows: int,
    make_chunk: Callable[[int, int], np.ndarray],
    *,
    ctx=None,
    scratch: Optional[str] = None,
    dtype=np.float32,
    heartbeat: Optional[Callable[[], None]] = None,
    preempt: Optional[Callable[[], None]] = None,
) -> dict:
    """Write a (rows, dim) `.npy` in chunks behind a durable progress
    marker; a killed run resumes from the last committed chunk instead
    of rewriting the file (the `BENCH_10M_PARTIAL` root fix).

    `make_chunk(lo, hi)` must be DETERMINISTIC in (lo, hi) — seed a
    fresh rng per chunk, not a sequential stream — so the resumed file
    is byte-identical to a one-shot write. Commits go fsync-then-marker:
    the marker only advances past bytes that are durable, and a resume
    truncates anything past the marker (a torn tail chunk)."""
    scratch, heartbeat, preempt = _ctx_hooks(ctx, scratch, heartbeat, preempt)
    dtype = np.dtype(dtype)
    marker_path = os.path.join(scratch, "datagen_progress.json")
    config = fingerprint_of({
        "path": os.path.abspath(path), "rows": int(rows), "dim": int(dim),
        "chunk_rows": int(chunk_rows), "dtype": dtype.str,
    })
    row_bytes = int(dim) * dtype.itemsize

    header = np.lib.format.header_data_from_array_1_0(
        np.empty((0, dim), dtype))
    header["shape"] = (int(rows), int(dim))

    def checked_chunk(lo: int, hi: int) -> np.ndarray:
        blk = np.ascontiguousarray(make_chunk(lo, hi), dtype=dtype)
        if blk.shape != (hi - lo, int(dim)):
            raise ValueError(
                f"make_chunk({lo},{hi}) returned {blk.shape}, "
                f"expected {(hi - lo, int(dim))}")
        return blk

    done = 0
    marker = JobDir.read_json(marker_path)
    if marker and marker.get("config") == config and os.path.exists(path):
        done = min(int(marker.get("rows_done", 0)), int(rows))
    pending = None
    if done == 0 and rows > 0:
        # produce + validate the FIRST chunk before the header lands: a
        # broken make_chunk must raise with no bytes on disk, not leave
        # a torn header-only .npy behind
        pending = checked_chunk(0, min(int(chunk_rows), int(rows)))
    if done == 0:
        # fresh start: header + no rows. Deliberately NOT atomic_write —
        # this file grows in place behind the marker; torn tails are
        # dropped by the truncate below, which is this protocol's
        # durability discipline.
        with open(path, "wb") as fh:  # raftlint: disable=hygiene-raw-write
            np.lib.format.write_array_header_1_0(fh, header)
            data_off = fh.tell()
        JobDir.write_json(marker_path, {"config": config, "rows_done": 0,
                                  "data_off": data_off})
    else:
        data_off = int(marker["data_off"])
        obs.event("job", action="datagen_resume", rows_done=done)

    with open(path, "r+b") as fh:
        fh.truncate(data_off + done * row_bytes)  # drop any torn tail
        fh.seek(data_off + done * row_bytes)
        while done < rows:
            hi = min(done + int(chunk_rows), int(rows))
            blk = pending if pending is not None else checked_chunk(done, hi)
            pending = None
            fh.write(blk.tobytes())
            fh.flush()
            os.fsync(fh.fileno())  # marker must never outrun durability
            done = hi
            JobDir.write_json(marker_path, {"config": config, "rows_done": done,
                                      "data_off": data_off})
            faults.crash_point(STREAM_CRASH_SITE)  # post-commit kill site
            preempt()
            heartbeat()
    return {"rows": int(rows), "dim": int(dim),
            "nbytes": os.path.getsize(path)}


# -- MNMG: checkpointed distributed build stages ------------------------

def _process_reduce(value: int, op: str) -> int:
    """`value` reduced over the processes of a `torch.distributed` world
    ("min" or "max", one int64 all-reduce on the group's device); a
    single process passes it through."""
    from raft_tpu_torch.comms.comms import _PROCESS_STATE, _process_index_count

    if _process_index_count()[1] <= 1:
        return int(value)
    import torch.distributed as dist

    dev = _PROCESS_STATE.get("device")
    if dev is None:
        dev = (torch.device("cuda", torch.cuda.current_device())
               if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor([int(value)], dtype=torch.int64, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MIN if op == "min" else dist.ReduceOp.MAX)
    return int(t.item())


def _agreed_on_all_hosts(flag: bool) -> bool:
    """Agree a per-host boolean across every controller: True iff EVERY
    process passes True (minimum wins). Collective decisions must never
    ride a raw per-host predicate — on a non-shared filesystem one
    controller can see a checkpoint while another doesn't, and the two
    would then enter different collective programs (rehydrate vs build)
    and deadlock the world. Single-process worlds pass through."""
    return bool(_process_reduce(1 if flag else 0, "min"))


def _mnmg_save(kind: str, filename: str, index) -> None:
    """Checkpoint a distributed index through the layout-appropriate
    `mnmg_ckpt` save: driver-built indexes (host mirrors present) use
    the single-controller save; `*_build_local` indexes use the
    collective sharded save (whose `kind` tag still re-enters through
    the same `rehydrate` load)."""
    from raft_tpu_torch.comms import mnmg_ckpt

    saves = {"ivf_flat": (mnmg_ckpt.ivf_flat_save,
                          mnmg_ckpt.ivf_flat_save_local),
             "ivf_pq": (mnmg_ckpt.ivf_pq_save, mnmg_ckpt.ivf_pq_save_local),
             "ivf_rabitq": (mnmg_ckpt.ivf_rabitq_save, None)}.get(kind)
    if saves is None:
        raise ValueError(f"unknown MNMG index kind {kind!r}")
    save, save_local = saves
    if getattr(index, "host_gids", None) is None:
        if save_local is None:
            raise ValueError(
                f"{kind!r} has no collective sharded checkpoint yet; "
                f"stream through a driver-built index")
        save_local(filename, index)
    else:
        save(filename, index)


def checkpointed_mnmg_build(
    comms,
    kind: str,
    build_fn: Callable[[], object],
    ckpt_path: str,
):
    """Run a distributed build as a resumable stage: when `ckpt_path`
    already holds a checkpoint, skip the build and re-enter through the
    `resilience.rehydrate` path (verified CRC load, replica-mirror
    healing, seeded retry on flaky reads) — so a preempted MNMG build
    run resumes instead of rebuilding. Otherwise run `build_fn()` and
    commit its result through the matching `mnmg_ckpt` save. Returns
    (index, RankHealth, resumed: bool)."""
    from raft_tpu_torch.comms.resilience import RankHealth, rehydrate

    # the resume decision is AGREED (a MIN all-reduce), never a raw
    # per-host os.path.exists: controllers disagreeing on the
    # checkpoint's existence would split between rehydrate's collective
    # load and the build's collectives and wedge the world
    resume = _agreed_on_all_hosts(os.path.exists(ckpt_path))
    if resume:
        index, health = rehydrate(comms, ckpt_path)
        obs.event("job", action="mnmg_resume", index_kind=kind, ckpt=ckpt_path)
        return index, health, True
    index = build_fn()
    _mnmg_save(kind, ckpt_path, index)
    faults.crash_point(STREAM_CRASH_SITE)  # post-commit kill site
    return index, RankHealth.all_healthy(comms.get_size()), False


def resumable_extend_local_from_file(
    comms,
    kind: str,
    index,
    extend_local_fn,
    path: str,
    batch_rows: int,
    *,
    ctx=None,
    scratch: Optional[str] = None,
    ckpt_path: Optional[str] = None,
    checkpoint_every: int = 1,
    depth: int = 3,
    heartbeat: Optional[Callable[[], None]] = None,
    preempt: Optional[Callable[[], None]] = None,
) -> Tuple[object, dict]:
    """Collective twin of `resumable_extend_from_file` for the
    multi-controller ingest path (`io.extend_from_file_local`): every
    controller streams its own file partition through
    `extend_local_fn(index, rows)` (a collective), checkpointing the
    distributed index through `mnmg_ckpt` every `checkpoint_every`
    batches. The resume cursor is AGREED across controllers (a MIN
    all-reduce of the per-process cursors) so the collective
    extend schedule stays aligned; resume re-enters through
    `rehydrate`'s verified/healing load. Single-controller worlds (the
    in-process rank world) degrade to the local protocol."""
    scratch, heartbeat, preempt = _ctx_hooks(ctx, scratch, heartbeat, preempt)
    from raft_tpu_torch.comms.resilience import rehydrate

    cursor_path = os.path.join(scratch, "mnmg_stream_cursor.json")
    base = ckpt_path or os.path.join(scratch, "mnmg_stream.ckpt")
    # deterministic per-batch checkpoint names + cursor-written-LAST
    # (crash-atomicity, as in resumable_extend_from_file) — and every
    # controller derives the SAME name from the agreed batch count, so
    # the min-cursor resume loads one shared file. The previous
    # checkpoint is kept alongside the current one: on a shared fs a
    # controller killed between the collective save and its own cursor
    # write is one batch behind, and the min-cursor file must still
    # exist when the world resumes at it.
    ckpt_of = lambda n: f"{base}.{n}"  # noqa: E731
    probe_rows = int(probe_file(path)[1][0])
    my_nb = -(-probe_rows // int(batch_rows)) if probe_rows else 0
    config = fingerprint_of({
        "kind": kind, "path": os.path.abspath(path), "n_rows": probe_rows,
        "batch_rows": int(batch_rows), "world": int(comms.get_size()),
    })

    my_cursor = 0
    cur = JobDir.read_json(cursor_path)
    if (cur and cur.get("config") == config
            and os.path.exists(ckpt_of(int(cur.get("batch", 0))))):
        my_cursor = int(cur.get("batch", 0))

    # agree the resume point: the slowest controller's durable cursor
    # (collectives past it would desynchronize the extend schedule)
    b0 = _process_reduce(my_cursor, "min")
    if b0 > 0:
        index, _health = rehydrate(comms, ckpt_of(b0))
        obs.event("job", action="mnmg_stream_resume", index_kind=kind, batch=b0)

    # b0 is the WORLD's agreed step, which can exceed this controller's
    # own batch count (shorter file partition): clamp the local cursor
    loader = FileBatchLoader(path, batch_rows, depth=depth, copy=False,
                             start_batch=min(b0, my_nb))
    my_batches = my_nb
    # total collective steps: agreed once, as in extend_from_file_local
    total_batches = _process_reduce(my_batches, "max")
    empty = np.zeros((0,) + tuple(loader.shape[1:]), loader.dtype)
    prev_done = b0 if b0 > 0 else None
    it = iter(loader)
    for b in range(b0, total_batches):
        faults.fault_point(STREAM_CRASH_SITE)
        try:
            batch, valid = next(it)
            rows = batch[:valid]
        except StopIteration:
            rows = empty
        index = extend_local_fn(index, rows)
        done = b + 1
        if done == total_batches or (checkpoint_every > 0
                                     and done % checkpoint_every == 0):
            _mnmg_save(kind, ckpt_of(done), index)
            JobDir.write_json(cursor_path, {"config": config, "batch": done})
            # keep current + previous (see the naming comment above);
            # sweep anything older, parts files included
            keep = {os.path.basename(ckpt_of(done))}
            if prev_done is not None:
                keep.add(os.path.basename(ckpt_of(prev_done)))
            stem, cdir = os.path.basename(base), os.path.dirname(base)
            for name in os.listdir(cdir or "."):
                if (name.startswith(stem + ".")
                        and name.split(".part")[0] not in keep
                        and name not in keep):
                    try:
                        os.remove(os.path.join(cdir, name))
                    except OSError:
                        pass  # sweep misses only cost disk
            prev_done = done
            obs.event("job", action="mnmg_stream_checkpoint", index_kind=kind,
                      batch=done)
            faults.crash_point(STREAM_CRASH_SITE)
            preempt()
        heartbeat()
    return index, {"batches": int(total_batches - b0),
                   "resumed_from_batch": int(b0),
                   "ckpt": ckpt_of(total_batches) if total_batches else None}
