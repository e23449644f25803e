"""PyTorch port: `raft_tpu_torch.obs` against the JAX package's
`raft_tpu.obs` (tests/test_obs.py without its comms and serve cases,
which come with those layers).

The same call sequence on both packages gives:
- equal registry snapshots and equal Prometheus text;
- equal span trees (names, nesting, counts, attributes, charged costs);
- equal `perf.cost_for` dicts over a grid of shapes for every registered
  span name, and equal `mfu` for one info dict;
- equal Watchtower breach and recover events from the same samples
  under an injected clock;
- equal trace ids for a seed and byte-equal `to_chrome_trace` of the
  same events;
- `report.render` text that is equal apart from the title;
- flight dumps equal apart from times;
- ledger entries equal apart from sha and platform (and the UTC stamp).

Durations and timestamps cannot match between the packages: the
comparisons drop "t", "dur_s", "marks" and the histograms' timing
aggregates. The matmul terms of `perf.pairwise_l2` and
`perf.kmeans_step` are pinned against `torch.utils.flop_counter`.
Every test leaves both packages' obs disabled and reset, no flight
recorder installed and the SIGTERM handler as it found it.
"""

import importlib
import json
import os
import re
import signal
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from raft_tpu import obs as jobs
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.core import faults as tfaults
from raft_tpu_torch.core import tracing as ttracing

_ROOT = Path(__file__).resolve().parent.parent
BOTH = (tobs, jobs)


@pytest.fixture
def both():
    prev = signal.getsignal(signal.SIGTERM)
    for m in BOTH:
        m.flight.uninstall()
        m.reset()
        m.enable()
    yield
    for m in BOTH:
        m.reset()
        m.disable()
        m.flight.uninstall()
    signal.signal(signal.SIGTERM, prev)


def _norm_events(events):
    return [{k: v for k, v in e.items() if k not in ("t", "dur_s", "marks")}
            for e in events]


def _norm_metrics(metrics):
    """The instruments a run moved (the global registries keep the names
    of instruments other tests defined, at zero), timing aggregates of
    span and stage histograms reduced to their counts."""
    hists = {}
    for name, agg in metrics["histograms"].items():
        if not agg["count"]:
            continue
        if name.startswith(("span.", "serve.stage.")):
            hists[name] = agg["count"]  # timing aggregates differ by nature
        else:
            hists[name] = agg
    return {"counters": {n: v for n, v in metrics["counters"].items() if v},
            "gauges": {n: v for n, v in metrics["gauges"].items() if v},
            "histograms": hists}


def _sequence(m, reg):
    """One call sequence touching every instrument kind and the bus."""
    reg.counter("a.calls").inc(3)
    reg.counter("b.bytes").inc(4096)
    reg.counter("zero")
    reg.gauge("depth").set(2.5)
    reg.gauge("depth").add(-1.0)
    h = reg.histogram("lat_s")
    for v in (0.004, 0.004, 0.3, 99.0):
        h.observe(v)
    h.observe_n(0.02, 5)
    reg.histogram("empty")
    reg.add_collector("svc", lambda: {"x": 1, "y": 2.5, "s": "text"})
    m.event("fault", site="x.y", action="slow", rank=-1)
    m.event("log", level="INFO", logger="t", msg="hello")


def test_registry_snapshots_and_prometheus_text_match_jax(both):
    regs = [m.Registry() for m in BOTH]
    for m, reg in zip(BOTH, regs):
        _sequence(m, reg)
    assert regs[0].snapshot() == regs[1].snapshot()
    assert (tobs.render_registry_prometheus(regs[0])
            == jobs.render_registry_prometheus(regs[1]))
    for m in BOTH:
        _sequence(m, m.registry())
    assert _norm_metrics(tobs.registry().snapshot()) == _norm_metrics(
        jobs.registry().snapshot())
    assert (tobs.render_prometheus({"x.y": 1.5, "n": 3, "b": True, "none": None})
            == jobs.render_prometheus({"x.y": 1.5, "n": 3, "b": True, "none": None}))
    assert _norm_events(tobs.bus().events()) == _norm_events(jobs.bus().events())
    assert tobs.prom_name("a.b-c") == jobs.prom_name("a.b-c")


def test_registry_instruments_and_thread_safety():
    reg = tobs.Registry()
    c = reg.counter("a.calls")
    c.inc()
    c.inc(4)
    assert reg.counter("a.calls") is c and c.value == 5
    with pytest.raises(ValueError):
        c.inc(-1)
    with pytest.raises(ValueError):
        reg.gauge("a.calls")
    reg.add_collector("svc", lambda: {"x": 1})
    reg.add_collector("bad", lambda: 1 / 0)
    snap = reg.snapshot()
    assert snap["collectors"]["svc"] == {"x": 1} and "error" in snap["collectors"]["bad"]
    n = reg.counter("n")

    def work():
        for _ in range(1000):
            n.inc()

    threads = [threading.Thread(target=work) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert n.value == 8000


def test_remove_collector_inside_a_locked_section_does_not_wait():
    """A dropped server's finalizer removes its section, and a garbage
    collection runs finalizers in whatever thread allocates, possibly one
    inside the registry's lock (a remove, a snapshot): there the removal
    must not wait for the lock (it used to hold the thread for good), and
    it lands at the next locked access. The thread must finish within its
    deadline; a server dropped mid-test leaves no section behind."""
    from raft_tpu_torch.serve import ServerMetrics

    reg = tobs.Registry()
    reg.add_collector("a", lambda: {"x": 1})
    reg.add_collector("b", lambda: {"y": 2})

    def inside():
        with reg._lock:  # as a collection inside a locked section would
            reg.remove_collector("a")

    t = threading.Thread(target=inside, daemon=True)
    t.start()
    t.join(timeout=10.0)
    assert not t.is_alive()
    assert reg.snapshot()["collectors"] == {"b": {"y": 2}}
    reg.remove_collector("b")
    assert "collectors" not in reg.snapshot()
    tobs.enable()
    try:
        before = set(tobs.snapshot()["metrics"].get("collectors", {}))
        m = ServerMetrics(latency_window=8)
        m.observe_submit()
        assert set(tobs.snapshot()["metrics"]["collectors"]) - before
        del m
        assert set(tobs.snapshot()["metrics"].get("collectors", {})) == before
    finally:
        tobs.disable()
        tobs.reset()


def test_bus_ordering_ring_and_subscribers():
    from raft_tpu_torch.obs.bus import EventBus

    bus = EventBus(maxlen=4)
    seen = []
    bus.subscribe(seen.append)
    bus.subscribe(lambda e: 1 / 0)  # a broken subscriber must not poison
    for i in range(6):
        bus.publish("k", i=i)
    assert [e["seq"] for e in bus.events()] == [3, 4, 5, 6]
    assert [e["i"] for e in seen] == list(range(6))
    bus.clear()
    assert len(bus) == 0 and bus.publish("k") == 1


def _span_tree(m):
    with m.span("outer", tag=1):
        with m.span("neighbors.ivf_pq.search", k=10) as sp:
            sp.set(extra="x")
            m.span_cost(**m.perf.cost_for(
                "neighbors.ivf_pq.search", nq=64, n_probes=4, n_lists=16, n_rows=4096,
                dim=32, pq_dim=16, k=10, dtype="int8", scanned_lists=16, fused=False))
            m.span_cost(flops=100, bytes=8, dtype="f32")
        for _ in range(2):
            with m.span("inner"):
                pass

    @m.spanned("deco.fn", tag=2)
    def fn():
        assert m.current_span().name == "deco.fn"
        return 42

    assert fn() == 42
    assert m.current_span() is None
    with m.capture_spans() as cap:
        with m.span("neighbors.refine"):
            m.span_cost(**m.perf.cost_for("neighbors.refine", nq=8, n_cand=40, dim=16, k=10))
    return cap


def test_span_trees_match_jax(both):
    caps = [_span_tree(m) for m in BOTH]
    te, je = tobs.bus().events(kind="span"), jobs.bus().events(kind="span")
    assert _norm_events(te) == _norm_events(je)
    assert [(e["name"], e["depth"], e["parent"]) for e in te] == [
        ("neighbors.ivf_pq.search", 1, "outer"), ("inner", 1, "outer"),
        ("inner", 1, "outer"), ("outer", 0, None), ("deco.fn", 0, None),
        ("neighbors.refine", 0, None)]
    assert _norm_metrics(tobs.registry().snapshot()) == _norm_metrics(
        jobs.registry().snapshot())
    tt, jt = caps[0].totals(), caps[1].totals()
    for name in tt:
        assert {k: v for k, v in tt[name].items() if k in ("calls", "flops", "bytes")} == {
            k: v for k, v in jt[name].items() if k in ("calls", "flops", "bytes")}
    assert caps[0].cost_totals() == caps[1].cost_totals()


def test_disabled_is_inert_and_fence_still_returns():
    for m in BOTH:
        m.disable()
        m.reset()
    with tobs.span("nope") as sp:
        sp.set(a=1)
        sp.cost(flops=1)
        t = torch.ones(3)
        assert sp.fence((t, [t]))[0] is t
    assert tobs.span("nope") is tobs.span("other")  # one reusable null context
    tobs.event("fault", site="x")
    tobs.collective("allreduce", torch.zeros(4))
    assert tobs.span_cost(flops=5) is None
    assert tobs.bus().events() == []
    snap = tobs.registry().snapshot()
    assert all(v == 0 for v in snap["counters"].values())


def test_fence_synchronizes_and_returns_its_argument(both):
    x = torch.arange(4.0)
    value = {"a": (x, [x * 2])}
    with tobs.span("s") as sp:
        assert sp.fence(value) is value
    assert tobs.spans.fence(x) is x


def test_collective_hook_matches_jax(both):
    for m, x in ((tobs, torch.zeros((8, 4), dtype=torch.bfloat16)),
                 (jobs, np.zeros((8, 4), np.float16))):
        m.collective("allreduce", x, axis="r", world=4)
        m.collective("allgather", x, world=4, wire_bytes=10, wire_dtype="int8")
    assert _norm_metrics(tobs.registry().snapshot()) == _norm_metrics(
        jobs.registry().snapshot())
    assert _norm_events(tobs.bus().events()) == _norm_events(jobs.bus().events())


def test_logger_bridge(both):
    logger_mod = importlib.import_module("raft_tpu_torch.core.logger")
    logger_mod.set_level(logger_mod.RAFT_LEVEL_INFO)
    try:
        logger_mod.logger.info("bridged %d", 1)
        evs = tobs.bus().events(kind="log")
        assert len(evs) == 1 and evs[0]["msg"] == "bridged 1" and evs[0]["level"] == "INFO"
        assert evs[0]["logger"] == "raft_tpu_torch"
        tobs.disable()
        logger_mod.logger.info("not bridged")
        assert len(tobs.bus().events(kind="log")) == 1
    finally:
        logger_mod.set_level(logger_mod.RAFT_LEVEL_WARN)


def test_obs_reexports_tracing_and_the_jax_all():
    assert tobs.trace_range is ttracing.trace_range
    assert tobs.annotate is ttracing.annotate
    assert tobs.__all__ == jobs.__all__
    for name in tobs.__all__:
        assert callable(getattr(tobs, name)) == callable(getattr(jobs, name)), name


# ---------------------------------------------------------------------------
# perf
# ---------------------------------------------------------------------------

SHAPES = [
    dict(nq=1, n_probes=1, n_lists=1, n_rows=1, dim=1, pq_dim=1, k=1),
    dict(nq=64, n_probes=4, n_lists=16, n_rows=4096, dim=32, pq_dim=16, k=10),
    dict(nq=4096, n_probes=8, n_lists=1024, n_rows=1024 * 3840, dim=96, pq_dim=48, k=40),
    dict(nq=4096, n_probes=2.75, n_lists=1024, n_rows=1_000_000, dim=96, pq_dim=48, k=250),
]


def _kwargs_for(name, s):
    fn = tobs.perf.SPAN_COST_MODEL[name].__name__
    if fn == "knn":
        return [dict(n=s["n_rows"], nq=s["nq"], d=s["dim"], k=s["k"], dtype=dt, fused=f)
                for dt in ("f32", "bf16") for f in (False, True)]
    if fn == "ivf_flat_scan":
        return [dict(nq=s["nq"], n_probes=s["n_probes"], n_lists=s["n_lists"],
                     n_rows=s["n_rows"], dim=s["dim"], k=s["k"], dtype=dt,
                     scanned_lists=sl, fused=f)
                for dt in ("f32", "bf16") for sl in (None, s["n_lists"]) for f in (False, True)]
    if fn == "ivf_pq_scan":
        return [dict(nq=s["nq"], n_probes=s["n_probes"], n_lists=s["n_lists"],
                     n_rows=s["n_rows"], dim=s["dim"], pq_dim=s["pq_dim"], k=s["k"],
                     dtype=dt, scanned_lists=sl, fused=f)
                for dt in ("bf16", "int8") for sl in (None, s["n_lists"]) for f in (False, True)]
    if fn == "rabitq_scan":
        return [dict(nq=s["nq"], n_probes=s["n_probes"], n_lists=s["n_lists"],
                     n_rows=s["n_rows"], dim=s["dim"], k=s["k"], query_bits=b,
                     rerank_mult=r, fused=f)
                for b in (4, 8) for r in (0, 4) for f in (False, True)]
    if fn == "refine_rerank":
        return [dict(nq=s["nq"], n_cand=4 * s["k"], dim=s["dim"], k=s["k"], dtype=dt, fused=f)
                for dt in ("f32", "bf16") for f in (False, True)]
    if fn == "kmeans_step":
        return [dict(n=s["n_rows"], d=s["dim"], n_clusters=s["n_lists"], iters=i)
                for i in (1, 3)]
    raise AssertionError(f"no shapes for {name} ({fn})")


def test_cost_for_matches_jax_for_every_registered_span():
    assert tobs.perf.SPAN_COST_MODEL.keys() == jobs.perf.SPAN_COST_MODEL.keys()
    n = 0
    for name in tobs.perf.SPAN_COST_MODEL:
        for s in SHAPES:
            for kw in _kwargs_for(name, s):
                assert tobs.perf.cost_for(name, **kw) == jobs.perf.cost_for(name, **kw), (
                    name, kw)
                n += 1
    assert n > 200
    for op in ("allreduce", "allgather", "bcast", "shift", "unknown"):
        for w in (1, 2, 8):
            assert (tobs.perf.collective_wire_bytes(op, 4096, w)
                    == jobs.perf.collective_wire_bytes(op, 4096, w))
    with pytest.raises(KeyError):
        tobs.perf.cost_for("neighbors.nope")


def test_mfu_matches_jax_for_one_info_dict():
    info = {"peak_flops": {"bf16": 989e12, "f32": 66.9e12, "int8": 1979e12, "int": 4.18e12}}
    for flops in ({"bf16": 3e12}, {"f32": 1e12, "int8": 2e12, "int": 1e10},
                  {"bogus": 1.0}, {}):
        for secs in (0.0, 0.019, 1.0):
            assert tobs.perf.mfu(flops, secs, info) == jobs.perf.mfu(flops, secs, info)


def test_peak_table_and_dtypes():
    h = tobs.perf.PEAK_TABLE["h100"]
    assert h["peak_flops"] == {"bf16": 989e12, "f32": 66.9e12, "int8": 1979e12,
                               "int": 4.18e12}
    assert h["hbm_Bps"] == 3.35e12 and h["nominal"] is False
    assert tobs.perf.PEAK_TABLE["cpu"] == jobs.perf.PEAK_TABLE["cpu"]
    assert not any(k.startswith("tpu") for k in tobs.perf.PEAK_TABLE)
    for dt, want in ((torch.float32, "f32"), (torch.bfloat16, "bf16"), (torch.float16, "bf16"),
                     (torch.int8, "int8"), (torch.uint8, "int8"), (torch.int32, "int"),
                     (torch.float64, "f32"), (np.float32, "f32"), ("bf16", "bf16"),
                     ("uint32", "int")):
        assert tobs.perf.canon_dtype(dt) == want, dt
    for dt in (np.float32, "bfloat16", "int8", "uint32", np.int32, "nope"):
        assert tobs.perf.canon_dtype(dt) == jobs.perf.canon_dtype(dt)
        assert tobs.perf.dtype_bytes(dt) == jobs.perf.dtype_bytes(dt)
    info = tobs.perf.platform_info()
    if not torch.cuda.is_available():
        assert info == {"platform": "cpu", "device_kind": "cpu", **tobs.perf.PEAK_TABLE["cpu"]}


def test_platform_info_on_a_card_is_the_h100_row(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "NVIDIA Some Other Card")
    info = tobs.perf.platform_info()
    assert info["platform"] == "h100" and info["device_kind"] == "NVIDIA Some Other Card"
    assert info["peak_flops"] == tobs.perf.PEAK_TABLE["h100"]["peak_flops"]


def test_matmul_flops_pinned_by_torch_flop_counter():
    from torch.utils.flop_counter import FlopCounterMode

    from raft_tpu_torch.cluster.kmeans_common import assign_and_reduce
    from raft_tpu_torch.distance import pairwise_distance

    rng = np.random.default_rng(0)
    n, m, d = 300, 70, 24
    x = torch.tensor(rng.standard_normal((n, d)), dtype=torch.float32)
    y = torch.tensor(rng.standard_normal((m, d)), dtype=torch.float32)
    with FlopCounterMode(display=False) as fc:
        pairwise_distance(x, y, metric="sqeuclidean", device="cpu")
    model = tobs.perf.pairwise_l2(n, m, d)
    assert fc.get_total_flops() == 2 * n * m * d
    assert model["flops"] - 2 * (n + m) * d - 3 * n * m == fc.get_total_flops()
    with FlopCounterMode(display=False) as fc:
        assign_and_reduce(x, y, needs_sums=False)
    step = tobs.perf.kmeans_step(n, d, m)
    assert step["flops"] - 2 * (n + m) * d - 3 * n * m - 2 * n * d == fc.get_total_flops()


# ---------------------------------------------------------------------------
# SLO, trace ids, chrome trace
# ---------------------------------------------------------------------------


def _watch(m):
    clock = iter(np.arange(0.0, 1e6, 0.5)).__next__
    wt = m.slo.Watchtower(m.slo.serve_objectives(p99_s=0.05), fast_s=60.0, slow_s=600.0,
                          clock=lambda: float(clock()))
    out = []
    for i in range(40):
        wt.observe_request(latency_s=0.2 if i % 2 else 0.01,
                           outcome="expired" if i % 3 == 0 else "ok", coverage=1.0, t=float(i))
        wt.observe_batch(0.5, t=float(i))
    out.append(wt.evaluate(t=40.0))
    for i in range(41, 5000, 10):
        wt.observe_request(latency_s=0.01, outcome="ok", coverage=1.0, t=float(i))
    out.append(wt.evaluate(t=5000.0))
    out.append(wt.state(t=5000.0))
    return out


def test_watchtower_transitions_match_jax(both):
    assert _watch(tobs) == _watch(jobs)
    te = _norm_events(tobs.bus().events())
    assert te == _norm_events(jobs.bus().events())
    assert {e["kind"] for e in te} == {"slo.breach", "slo.recover"}
    assert _norm_metrics(tobs.registry().snapshot()) == _norm_metrics(
        jobs.registry().snapshot())
    snap = {"submitted": 100, "expired": 1, "latency_ms_p99": 12.0, "batch_occupancy": 0.5}
    assert tobs.slo.judge_serve(snap) == jobs.slo.judge_serve(snap)
    assert tobs.slo.judge_serve({}) == jobs.slo.judge_serve({})
    with pytest.raises(ValueError):
        tobs.slo.Objective("x", "vibes", 0.9)
    with pytest.raises(ValueError):
        tobs.slo.Watchtower(tobs.slo.serve_objectives(), breach_burn=1.0, recover_burn=1.0)


def test_trace_ids_and_chrome_trace_match_jax(both):
    for seed in (0, 7, 2 ** 40):
        assert [tobs.trace.trace_id(seed, n) for n in range(1, 6)] == [
            jobs.trace.trace_id(seed, n) for n in range(1, 6)]
    for m in BOTH:
        m.trace.reset(seed=3)
        ctxs = [m.trace.begin() for _ in range(3)]
        for i, ctx in enumerate(ctxs):
            for stage in m.trace.STAGES:
                ctx.stamp(stage, bucket=8 * (i + 1))
            m.trace.complete(ctx, outcome="ok", k=10)
        with m.span("neighbors.brute_force.knn"):
            pass
    te, je = tobs.bus().events(), jobs.bus().events()
    assert _norm_events(te) == _norm_events(je)
    assert [e["trace_id"] for e in te if e["kind"] == "trace"] == [
        tobs.trace.trace_id(3, n) for n in (1, 2, 3)]
    # one event list, both renders: byte-equal, twice
    assert tobs.to_chrome_trace(je) == jobs.to_chrome_trace(je) == tobs.to_chrome_trace(je)
    json.loads(tobs.to_chrome_trace(te))
    counts = {n: a["count"] for n, a in tobs.registry().snapshot()["histograms"].items()}
    assert all(counts[h] == 3 for h in tobs.trace.STAGE_HISTOGRAMS.values())


def test_a_flaky_stamp_leaves_the_request_untraced(both):
    plan = tfaults.FaultPlan([tfaults.Fault("flaky_bootstrap", site="serve.trace.stamp",
                                            count=1)], seed=0)
    with plan.install():
        ctx = tobs.trace.begin()
        ctx.stamp("admitted")
        ctx.stamp("scattered")
        tobs.trace.complete(ctx)
    assert ctx.dead and tobs.bus().events(kind="trace") == []
    assert [e["action"] for e in tobs.bus().events(kind="fault")] == ["flaky"]


# ---------------------------------------------------------------------------
# exports, report, flight, ledger
# ---------------------------------------------------------------------------


def _drill(m):
    m.counter("comms.allreduce.calls").inc(2)
    m.counter("comms.allreduce.bytes").inc(4096)
    m.counter("serve.compile_cache.hit").inc(5)
    m.counter("serve.compile_cache.miss").inc(1)
    m.counter("integrity.scans").inc(2)
    m.counter("integrity.mismatches").inc(1)
    m.counter("mutation.tombstones").inc(7)
    with m.span("neighbors.ivf_flat.search"):
        m.span_cost(flops=10 ** 9, bytes=10 ** 6, dtype="bf16")
    m.event("fault", site="serve.batch", action="slow")
    m.event("integrity.mismatch", field="list_data", list=3)
    m.event("mutation", op="delete", index_kind="ivf_flat", n=7)
    m.event("job", job="j", stage="s", action="start")


def _strip_clock(snap):
    """A snapshot without its clock fields (span totals read 1 ms) and
    without the instruments the run did not move."""
    out = json.loads(json.dumps(snap, default=repr))
    for e in out["events"]:
        e["t"] = 0.0
        e.pop("dur_s", None)
    metrics = out["metrics"]
    metrics["counters"] = {n: v for n, v in metrics["counters"].items() if v}
    metrics["gauges"] = {n: v for n, v in metrics["gauges"].items() if v}
    metrics["histograms"] = {n: a for n, a in metrics["histograms"].items() if a["count"]}
    for name, agg in metrics["histograms"].items():
        if name.startswith("span."):
            for key in ("total", "min", "max", "mean", "last"):
                agg[key] = 0.001
    return out


def test_report_render_matches_jax_apart_from_the_title(both):
    for m in BOTH:
        _drill(m)
    ts, js = _strip_clock(tobs.snapshot(rank=0, world=2)), _strip_clock(
        jobs.snapshot(rank=0, world=2))
    assert ts == js
    t = importlib.import_module("raft_tpu_torch.obs.report")
    j = importlib.import_module("raft_tpu.obs.report")
    assert t.render(ts, title="r") == j.render(js, title="r")
    assert t.render(ts).split("\n", 1)[1] == j.render(js).split("\n", 1)[1]
    assert t.render(ts).startswith("# raft_tpu_torch run report")
    other = dict(ts, rank=1)
    assert t.render_merged([ts, other], title="m") == j.render_merged([js, other], title="m")


def test_snapshot_save_and_report_cli(both, tmp_path):
    _drill(tobs)
    path = tmp_path / "snap.json"
    snap = tobs.save_snapshot(str(path))
    assert json.loads(path.read_text())["metrics"]["counters"] == snap["metrics"]["counters"]
    assert not [p for p in os.listdir(tmp_path) if ".tmp." in p]
    env = dict(os.environ, PYTHONPATH=str(_ROOT))
    r = subprocess.run([sys.executable, "-m", "raft_tpu_torch.obs.report", str(path),
                        "--title", "drill"], capture_output=True, text=True, env=env,
                       timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "# drill" in r.stdout and "4.0 KiB" in r.stdout
    assert "neighbors.ivf_flat.search" in r.stdout and "serve.batch" in r.stdout
    r = subprocess.run([sys.executable, "-m", "raft_tpu_torch.obs.report", str(path),
                        str(path), "--merge"], capture_output=True, text=True, env=env,
                       timeout=120)
    assert r.returncode == 0 and "ranks merged: 2" in r.stdout


def test_prometheus_histogram_buckets_are_monotone(both):
    h = tobs.histogram("span.x")
    for v in (0.004, 0.004, 0.3, 99.0):
        h.observe(v)
    lines = tobs.render_registry_prometheus().strip().split("\n")
    for line in lines:
        assert re.fullmatch(r'[a-zA-Z_:][a-zA-Z0-9_:]*(?:\{le="(?:[0-9.e+-]+|\+Inf)"\})? '
                            r"(\S+)", line), line
    assert 'raft_tpu_span_x_bucket{le="0.005"} 2' in lines
    assert 'raft_tpu_span_x_bucket{le="+Inf"} 4' in lines
    vals = [n for _, n in h.bucket_counts()]
    assert vals == sorted(vals) and vals[-1] == 4


def _flight(m, d):
    rec = m.flight.install(maxlen=4, dump_dir=str(d))
    for i in range(6):
        m.event("fault", site="s", i=i)
    m.counter("c").inc(2)
    with m.span("outer"):
        path = m.flight.maybe_dump("drill", site="s")
    assert rec is m.flight.installed()
    with open(path) as f:
        return json.load(f), path


def test_flight_dumps_match_jax_apart_from_times(both, tmp_path):
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    td, tp = _flight(tobs, tmp_path / "t")
    jd, jp = _flight(jobs, tmp_path / "j")
    assert os.path.basename(tp) == os.path.basename(jp)
    for d in (td, jd):
        for e in d["events"]:
            e.pop("t")
        d["registry"] = _norm_metrics(d["registry"])
    assert td == jd
    assert [e["i"] for e in td["events"]] == [2, 3, 4, 5]
    assert td["open_spans"][0]["name"] == "outer" and td["registry_delta"] == {"c": 2}


def test_flight_dump_never_raises(both, tmp_path):
    tobs.flight.install(dump_dir=str(tmp_path / "missing"))
    assert tobs.flight.maybe_dump("x") is None
    assert [e["action"] for e in tobs.bus().events(kind="flight")] == ["dump_failed"]
    plan = tfaults.FaultPlan([tfaults.Fault("flaky_bootstrap", site="obs.flight.dump",
                                            count=1)], seed=0)
    tobs.flight.install(dump_dir=str(tmp_path))
    with plan.install():
        assert tobs.flight.maybe_dump("y") is None
        assert tobs.flight.maybe_dump("z") is not None
    tobs.disable()
    assert tobs.flight.maybe_dump("off") is None


def test_sigterm_install_chains_and_the_fixture_restores(both, tmp_path):
    seen = []
    signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    tobs.flight.install(dump_dir=str(tmp_path))
    assert tobs.flight.install_sigterm()
    os.kill(os.getpid(), signal.SIGTERM)
    assert seen == [signal.SIGTERM]
    assert [p for p in os.listdir(tmp_path) if p.startswith("flight-")]


def test_ledger_entries_match_jax_apart_from_sha_and_platform(tmp_path, monkeypatch):
    path = tmp_path / "ledger.jsonl"
    monkeypatch.setenv(tobs.ledger.ENV_PATH, str(path))
    assert tobs.ledger.resolve_path() == jobs.ledger.resolve_path() == str(path)
    row = {"qps": 1.5, "recall": 0.99}
    te = tobs.ledger.make_entry(bench="b", row=row, sha="s", platform="gpu", mfu=0.1, skip=None)
    je = jobs.ledger.make_entry(bench="b", row=row, sha="s", platform="tpu", mfu=0.1, skip=None)
    for e in (te, je):
        e.pop("platform")
        e.pop("utc")
    assert te == je
    assert tobs.ledger.sniff_platform() == ("gpu" if torch.cuda.is_available() else "cpu")
    path.write_text('{"torn": ')  # a torn line from a killed writer
    assert tobs.ledger.bank_row(bench="b", row=row, repo_dir=str(_ROOT)) == str(path)
    rows = tobs.ledger.read(str(path))
    assert len(rows) == 1 and rows[0]["row"] == row
    assert rows == jobs.ledger.read(str(path))
    assert tobs.ledger.read(str(tmp_path / "nope")) == []


def test_trace_session_writes_a_chrome_trace(tmp_path):
    with tobs.trace_session(str(tmp_path / "prof")) as d:
        with ttracing.trace_range("raft_tpu_torch.test.scope"):
            torch.ones(64) @ torch.ones(64)
    files = os.listdir(d)
    assert len(files) == 1 and files[0].endswith(".json")
    with open(os.path.join(d, files[0])) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "raft_tpu_torch.test.scope" in names


_CHILD = """
import os, sys
sys.path.insert(0, {root!r})
from raft_tpu_torch import obs
from raft_tpu_torch.core import faults
assert obs.enabled() and obs.flight.installed() is not None
obs.event("fault", site="before", n=1)
plan = faults.FaultPlan([faults.Fault("kill_rank", site="mutation.log.commit", count=1)],
                        seed=0)
with plan.install():
    faults.crash_point("mutation.log.commit")
print("survived")
"""


def test_env_arms_obs_and_a_crash_point_dumps_the_timeline(tmp_path):
    env = dict(os.environ, RAFT_TPU_OBS="1", RAFT_TPU_FLIGHT_DIR=str(tmp_path))
    r = subprocess.run([sys.executable, "-c", _CHILD.format(root=str(_ROOT))],
                       capture_output=True, text=True, env=env, timeout=120)
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr[-2000:])
    dumps = [p for p in os.listdir(tmp_path) if p.startswith("flight-")]
    assert len(dumps) == 1
    with open(tmp_path / dumps[0]) as f:
        d = json.load(f)
    assert d["reason"] == "crash_point" and d["site"] == "mutation.log.commit"
    assert [(e["kind"], e.get("site")) for e in d["events"]] == [
        ("fault", "before"), ("fault", "mutation.log.commit")]
