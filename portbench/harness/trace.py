"""The reduction of a traced window: `torch.profiler`'s trace to the
device's busy time, its top operations, its idle gaps and the busy time
of each of the benchmark's ranges.

The trace is read as the profiler exports it (Chrome trace JSON). Busy
time is the union of the device's own activities (kernels, copies, sets)
inside the benchmark's "window" range; the idle gaps are the rest of the
window, each charged to the benchmark's innermost range that the host
was in at the gap's middle ("search", "refine", "to_host", "build", ...,
or "between" outside all of them). A range's busy time is the union of
the device activities that the host launched inside it (matched by the
trace's correlation ids), wherever they ran on the device: the device's
own work of the call, without the host's gaps in it. Times are in
seconds.
"""

from __future__ import annotations

import json
import os
import tempfile

#: the trace categories of the device's own activities
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "window"
TOP = 10


def _union(spans):
    """Merged, sorted intervals of spans [(start, end)]."""
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def _charge(mids, ranges):
    """For each time of `mids` (ascending), the innermost host range that
    holds it (ranges sorted by start), or "between": one sweep with a
    stack of the open ranges."""
    out, stack, j = [], [], 0
    for t in mids:
        while j < len(ranges) and ranges[j][0] <= t:
            stack.append(ranges[j])
            j += 1
        while stack and stack[-1][1] < t:
            stack.pop()
        out.append(stack[-1][2] if stack else "between")
    return out


def reduce_events(events: list, range_names) -> dict:
    """{window_s, busy_s, device_ops, idle_gaps, device_events,
    range_busy_s, range_count} of one trace's events; busy times averaged
    over the devices that ran. `range_count` counts each range of
    `range_names` that starts in the window, `range_busy_s` the busy time
    launched from inside them."""
    window = [e for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
              and e.get("name") == WINDOW]
    if not window:
        raise ValueError("the trace holds no window range")
    w0 = float(window[0]["ts"])
    w1 = w0 + float(window[0]["dur"])
    launched = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("ph") == "X" and e.get("cat") not in DEVICE_CATS and corr is not None:
            launched[corr] = float(e["ts"])
    ranges = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
                    for e in events if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                    and e.get("name") in range_names)
    per_dev, per_name, by_launch = {}, {}, []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        s = max(w0, float(e["ts"]))
        t = min(w1, float(e["ts"]) + float(e.get("dur", 0.0)))
        if t <= s:
            continue
        per_dev.setdefault(e.get("pid"), []).append((s, t))
        per_name[e["name"]] = per_name.get(e["name"], 0.0) + (t - s)
        at = launched.get((e.get("args") or {}).get("correlation"))
        if at is not None:
            by_launch.append((at, e.get("pid"), s, t))
    by_launch.sort()
    per_range = {}
    for (_, dev, s, t), name in zip(by_launch, _charge([b[0] for b in by_launch], ranges)):
        per_range.setdefault(name, {}).setdefault(dev, []).append((s, t))
    busy, gaps = [], {}
    for spans in per_dev.values():
        merged = _union(spans)
        busy.append(sum(e - s for s, e in merged))
        edges = [w0] + [x for iv in merged for x in iv] + [w1]
        holes = [(a, b) for a, b in zip(edges[0::2], edges[1::2]) if b > a]
        for (a, b), name in zip(holes, _charge([0.5 * (a + b) for a, b in holes], ranges)):
            gaps[name] = gaps.get(name, 0.0) + (b - a) * 1e-6 / len(per_dev)
    ops = sorted(per_name.items(), key=lambda kv: -kv[1])[:TOP]
    return {
        "window_s": (w1 - w0) * 1e-6,
        "busy_s": (sum(busy) / len(busy) if busy else 0.0) * 1e-6,
        "device_ops": [[name, us * 1e-6 / max(1, len(per_dev))] for name, us in ops],
        "idle_gaps": sorted(([n, s] for n, s in gaps.items()), key=lambda kv: -kv[1])[:TOP],
        "device_events": sum(len(v) for v in per_dev.values()),
        "range_busy_s": {name: sum(sum(e - s for s, e in _union(v)) for v in devs.values())
                         * 1e-6 / max(1, len(per_dev))
                         for name, devs in per_range.items() if name in range_names},
        "range_count": {name: sum(1 for r in ranges if r[2] == name and w0 <= r[0] < w1)
                        for name in range_names},
    }


def reduce_profile(prof, range_names) -> dict:
    """Export `prof` (a finished torch.profiler.profile) to a temporary
    file under TMPDIR, read it back and reduce it; the file is removed."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    return reduce_events(events, range_names)
