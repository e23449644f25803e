"""One run of one cell: set-up, the measured window, the check against
the plain reference, the import guard and the result line.

Set-up (`setup_s`, from the process's start to the window's start) makes
the rows and the seed's queries on the device, builds every kernel
library of the port where none is built yet, builds the index (search
mixes) or one index (build mixes), and warms every shape the window
uses. The window then runs the mix for `seconds`: nothing compiles in it.
With `--trace 1` the window's first seconds run under `torch.profiler`
(`Tracer`), each call into the port inside a range of its name, and the
line carries the per-layer metrics instead of the end-to-end ones.
"""

from __future__ import annotations

import gc
import json
import sys
import time
import torch

from portbench.harness import check, data, guard, trace, traffic
from portbench.harness.manifest import BENCH_DIR
from portbench.reference.exact_knn import exact_knn

#: the benchmark's own host ranges, as the trace's idle gaps are charged
RANGES = ("build", "search", "refine", "to_host")
#: batches of a search mix run in set-up, after the index is built
WARM_BATCHES = 2
#: a traced run traces whole units of work up to this far into the window
TRACE_SECONDS = 5.0


def mark(name: str):
    """The range around a call into the port: a `record_function` of its
    name, which a traced window's trace shows and `trace` reads the
    call's device time from."""
    return torch.profiler.record_function(name)


def _answer(system, q):
    d, i = system.search(q, mark)
    with mark("to_host"):
        return d.cpu(), i.cpu()


class Tracer:
    """The traced slice of a window: `torch.profiler` from the window's
    start to the end of the first unit of work (a batch, a build) that ends
    `TRACE_SECONDS` or more into it, inside a "window" range; the rest of
    the window runs untraced, so a trace stays a few seconds long."""

    def __init__(self, on: bool, cuda: bool, sync):
        self.on, self.cuda, self.sync = on, cuda, sync
        self.prof = self._range = None
        self.units = 0
        self.done = not on

    def start(self) -> None:
        if self.done:
            return
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.cuda else [])
        self.prof = profile(activities=acts)
        self.prof.start()
        self._range = torch.profiler.record_function(trace.WINDOW)
        self._range.__enter__()

    def after_unit(self, elapsed_s: float) -> None:
        if self.done:
            return
        self.units += 1
        if elapsed_s >= TRACE_SECONDS:
            self.stop()

    def stop(self) -> None:
        if self.done:
            return
        self.sync()
        self._range.__exit__(None, None, None)
        self.prof.stop()
        self.done = True


def search_window(system, qs, positions, seconds: float, tracer=None) -> dict:
    """One caller in a closed loop, batch after batch, until `seconds`
    have passed; each batch's time runs from the call to its answers on
    the host. Every batch's answers stay for the check."""
    tracer = tracer or Tracer(False, False, None)
    answers, latencies = [], []
    tracer.start()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    j = 0
    while True:
        b = j % len(qs)
        ts = time.perf_counter()
        d, i = _answer(system, qs[b])
        te = time.perf_counter()
        latencies.append(te - ts)
        answers.append((positions[b], d, i))
        j += 1
        tracer.after_unit(te - t0)
        if te >= deadline:
            break
    tracer.stop()
    return {"window_s": te - t0, "latencies_s": latencies, "answers": answers,
            "queries": sum(int(p.shape[0]) for p, _, _ in answers), "batches": j}


def build_window(system, rows, seed: int, seconds: float, tracer, sync) -> dict:
    """One caller building the index from `rows`, build after build, until
    `seconds` have passed; the last index stays with the system."""
    tracer.start()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    builds = 0
    while True:
        system.free()
        system.build(rows, seed, mark)
        sync()
        builds += 1
        te = time.perf_counter()
        tracer.after_unit(te - t0)
        if te >= deadline:
            break
    tracer.stop()
    return {"window_s": te - t0, "builds": builds, "rows": int(rows.shape[0])}


def run_cell(manifest, workload: str, seed: int, seconds: float, trace_on: bool, device,
             t_start: float, out=sys.stdout, err=sys.stderr) -> dict:
    """Run one cell and return its result line (a dict); earlier lines go
    to `out`, the compared numbers beside their limits last to `err`."""
    cell = manifest.cell(workload)
    cfg, mix = cell.config, cell.mix
    traffic.check_mix(mix)
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    k, nq = int(cfg["dataset"]["k"]), int(cfg["dataset"]["queries"])

    system = cell.system.System(cfg, dev)
    system.prepare()
    rows, queries = data.make_inputs(cfg, seed, dev)
    build_seed = int(cfg["index"]["build_seed"])
    system.build(rows, build_seed, mark)
    positions = traffic.query_batches(mix, nq)
    qs = [queries[p.to(dev)].contiguous() for p in positions]
    if mix["kind"] == "search":
        for q in qs[:WARM_BATCHES] * max(1, WARM_BATCHES // len(qs)):
            _answer(system, q)
    sync()
    setup_s = time.perf_counter() - t_start

    before = system.counters()
    tracer = Tracer(trace_on, cuda, sync)
    if mix["kind"] == "search":
        rec = search_window(system, qs, positions, seconds, tracer)
    else:
        rec = build_window(system, rows, build_seed, seconds, tracer, sync)
    sync()
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    launches = {n: c - before.get(n, 0) for n, c in system.counters().items()}

    index_checks = {}
    if mix["kind"] == "build":
        # the last index: its ids, its digests, then one search of the
        # whole query set
        index_checks["index_ids"] = check.index_id_faults(system.index_ids(),
                                                          int(rows.shape[0]))
        digest_fields = system.list_digests()
        rec["answers"] = [(p, *_answer(system, q)) for p, q in zip(positions, qs)]
    summary = trace.reduce_profile(tracer.prof, RANGES) if trace_on else None

    # the program's state goes before the reference runs
    system.free()
    del system, qs
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    truth_d, truth_i = exact_knn(rows, queries, k)
    numbers = check.judge_answers(rows, queries, rec["answers"], k, truth_d, truth_i)
    if index_checks:
        index_checks["digests"] = check.digest_faults(digest_fields)
        numbers.update(index_checks)
    correct, checks = check.verdict(numbers, cfg["checks"])

    record = {"workload": workload, "config": cfg, "mix": mix, "setup_s": setup_s,
              "window_s": rec["window_s"], "latencies_s": rec.get("latencies_s"),
              "queries": rec.get("queries"), "batches": rec.get("batches"),
              "builds": rec.get("builds"), "rows": int(rows.shape[0]), "numbers": numbers,
              "trace": summary, "traced_units": tracer.units}
    metrics = {}
    for m in (cell.per_layer if trace_on else cell.end_to_end):
        value = manifest.metric_reader(m["name"]).read(record)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}

    attempted = rec["queries"] if mix["kind"] == "search" else rec["builds"]
    failed = (numbers["bad_rows"] if mix["kind"] == "search"
              else int(numbers["index_ids"] + numbers["digests"] > 0))
    device_info = {"platform": "gpu" if cuda else dev.type,
                   "kind": torch.cuda.get_device_name(dev) if cuda else dev.type,
                   "count": cell.chips, "memory_peak_bytes": memory_peak}
    result = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
              "metrics": metrics, "device": device_info}
    if summary is not None:
        device_info["busy_s"] = summary["busy_s"]
        device_info["window_s"] = summary["window_s"]
        result["breakdown"] = {"device_ops": summary["device_ops"],
                               "idle_gaps": summary["idle_gaps"]}
    result["checks"] = {n: {"value": c["value"], "limit": c["limit"], "need": c["need"]}
                        for n, c in checks.items()}

    print("window launches " + json.dumps(launches), file=out)
    print(f"memory_peak_bytes {memory_peak}", file=out)
    if summary is not None:
        print(f"trace device_events {summary['device_events']} units {tracer.units}", file=out)
        print("range_busy_ms " + json.dumps({n: 1e3 * b / max(1, summary["range_count"][n])
                                             for n, b in summary["range_busy_s"].items()}),
              file=out)
    out.flush()
    for n, c in checks.items():
        print(f"check {n} {c['value']!r} {c['need']} {c['limit']!r} "
              f"{'ok' if c['ok'] else 'FAILED'}", file=err)
    err.flush()
    return result


def guard_failures() -> list:
    """What the import guard found at the end of a run (empty: nothing)."""
    found = [f"loaded: {m}" for m in guard.forbidden_modules()]
    found += [f"reference {f} imports {m}"
              for f, m in guard.reference_violations(BENCH_DIR / "reference")]
    return found
