"""Exporters: JSON snapshots, Prometheus exposition text, profiler
trace sessions (counterpart of raft_tpu/obs/export.py).

Three consumers, three formats:
  - `snapshot()` / `save_snapshot()`: the machine-readable joined view
    (registry metrics + bus events) a test asserts on and
    `python -m raft_tpu_torch.obs.report` renders for humans;
  - `render_prometheus()`: flat `name value` exposition text for a
    scrape endpoint, one formatter for every surface;
  - `trace_session()`: a `torch.profiler` session (CPU and CUDA
    activities) that writes a Chrome trace under a directory, the
    port's `jax.profiler.trace`.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import re
from typing import Optional

from raft_tpu_torch.obs import bus as _bus_mod
from raft_tpu_torch.obs import registry as _reg_mod

_NAME_OK = re.compile(r"[^a-zA-Z0-9_:]")


def snapshot(registry: Optional[_reg_mod.Registry] = None,
             bus: Optional[_bus_mod.EventBus] = None,
             rank: Optional[int] = None,
             world: Optional[int] = None,
             label: Optional[str] = None) -> dict:
    """Joined point-in-time view: {"metrics": ..., "events": [...],
    "platform": ...} plus optional rank/world/label identity fields (the
    per-rank captures `obs.report --merge` aligns).

    Ordering is deterministic — metrics sort by name, events by seq —
    so two runs of the same seeded drill differ only in clock fields
    ("t", "dur_s", histogram timing aggregates), which tests strip. The
    embedded platform record (obs.perf.platform_info) pins which peak
    table any MFU derived from this snapshot was computed against.
    """
    reg = registry if registry is not None else _reg_mod.GLOBAL
    b = bus if bus is not None else _bus_mod.GLOBAL
    snap = {"metrics": reg.snapshot(), "events": b.events()}
    try:
        from raft_tpu_torch.obs import perf as _perf

        snap["platform"] = _perf.platform_info()
    except Exception:  # pragma: no cover - defensive
        pass
    if rank is not None:
        snap["rank"] = int(rank)
    if world is not None:
        snap["world"] = int(world)
    if label is not None:
        snap["label"] = str(label)
    return snap


def save_snapshot(path: str, **kwargs) -> dict:
    """Write `snapshot()` to `path` as JSON; returns the snapshot.
    The write is atomic (tmp + rename): a reader can never observe a
    torn snapshot, and a crash mid-write leaves any previous snapshot
    intact, the contract every obs JSON writer honors."""
    snap = snapshot(**kwargs)
    from raft_tpu_torch.core.serialize import atomic_write

    with atomic_write(path) as tmp:
        with open(tmp, "w") as f:
            json.dump(snap, f, indent=1, default=repr)
    return snap


def prom_name(name: str, prefix: str = "") -> str:
    """Sanitize a dotted metric name into the Prometheus charset."""
    return _NAME_OK.sub("_", prefix + name)


def _prom_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        return f"{v:.6g}"
    raise TypeError(f"non-numeric metric value {v!r}")


def render_prometheus(values: dict, prefix: str = "raft_tpu_") -> str:
    """Flat dict -> Prometheus exposition text (`name value` lines,
    sorted by name; None values are skipped — exposition has no null).
    NaN renders as `nan`, which Prometheus' float parser accepts."""
    lines = []
    for key in sorted(values):
        val = values[key]
        if val is None:
            continue
        lines.append(f"{prom_name(key, prefix)} {_prom_value(val)}")
    return "\n".join(lines) + "\n"


def render_registry_prometheus(registry: Optional[_reg_mod.Registry] = None,
                               prefix: str = "raft_tpu_") -> str:
    """The whole registry as exposition text: counters and gauges as-is,
    histograms as real Prometheus histogram families — cumulative
    `<name>_bucket{le="..."}` series plus `<name>_sum`/`<name>_count` —
    with the `min`/`max`/`mean`/`last` aggregates kept as companion
    gauges, and collector sections under `<collector>_<key>`."""
    reg = registry if registry is not None else _reg_mod.GLOBAL
    snap = reg.snapshot()
    flat = {}
    flat.update(snap["counters"])
    flat.update(snap["gauges"])
    for cname, section in snap.get("collectors", {}).items():
        if not isinstance(section, dict):
            continue
        for key, v in section.items():
            if isinstance(v, (int, float, bool)):
                flat[f"{cname}.{key}"] = v
    bucket_lines = []
    # each histogram family comes from ONE locked read (export_state) so
    # its _count/_sum can never disagree with its _bucket{+Inf} under a
    # concurrent observe — Prometheus scrape-atomicity per family
    for name, hist in reg.histogram_items():
        agg, buckets = hist.export_state()
        for stat, v in agg.items():
            # Prometheus histogram convention: the observation total is
            # the `_sum` series (the aggregate dict calls it "total")
            flat[f"{name}.{'sum' if stat == 'total' else stat}"] = v
        base = prom_name(f"{name}.bucket", prefix)
        bucket_lines.extend(f'{base}{{le="{le}"}} {n}'
                            for le, n in buckets)
    lines = render_prometheus(flat, prefix).splitlines()
    return "\n".join(lines + bucket_lines) + "\n"


_SESSIONS = itertools.count(1)


@contextlib.contextmanager
def trace_session(logdir: str, create_perfetto_link: bool = False):
    """Profiler trace session: everything inside the block is recorded by
    `torch.profiler` (CPU activities, and CUDA ones when a card is
    present: the kernels by name) and written as a Chrome trace,
    `<logdir>/trace-<pid>-<n>.json`, which Perfetto and chrome://tracing
    open. Composes with spans: `trace_range` names show in the timeline.
    `create_perfetto_link` is accepted for the JAX call shape and has no
    effect (there is no upload). Yields `logdir`.

        with obs.trace_session("/tmp/prof"):
            ivf_flat.search(p, index, q, k=10)
    """
    del create_perfetto_link
    import torch
    from torch.profiler import ProfilerActivity, profile

    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    path = os.path.join(logdir, f"trace-{os.getpid()}-{next(_SESSIONS)}.json")
    with profile(activities=activities) as prof:
        yield logdir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(path)
