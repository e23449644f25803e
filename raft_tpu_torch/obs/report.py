"""Run-report renderer: `python -m raft_tpu_torch.obs.report
snapshot.json` (counterpart of raft_tpu/obs/report.py).

Turns a saved `obs.save_snapshot()` JSON into the post-run summary an
operator reads: where wall-clock went (span totals), what it cost
(analytic FLOPs/bytes per span with FLOP/s and MFU against the
snapshot's embedded peak table, nominal CPU peaks tagged), what moved
over the interconnect, what the serving layer did, and the fault,
integrity, mutation and job timelines.

`--merge` takes several per-rank snapshots (`save_snapshot(path,
rank=..., world=...)`) and renders one distributed view: per-rank span
attribution with straggler skew, per-rank collective calls/bytes (a
call-count mismatch is a desync), and the merged fault/health timeline
aligned by each rank's seq-ordered bus.

Also a library: `report.render(snap) -> str` /
`report.render_merged([snap, ...]) -> str`. The text equals the JAX
package's for the same snapshot but for the default titles.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import List


def _fmt_bytes(n: float) -> str:
    n = float(n)
    for unit in ("B", "KiB", "MiB", "GiB", "TiB"):
        if abs(n) < 1024.0 or unit == "TiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024.0
    return f"{n:.1f} TiB"


def _fmt_s(s) -> str:
    if s is None:
        return "-"
    s = float(s)
    return f"{s * 1e3:.2f} ms" if s < 1.0 else f"{s:.3f} s"


def _table(rows: List[List[str]], header: List[str]) -> List[str]:
    widths = [max(len(str(r[i])) for r in [header] + rows)
              for i in range(len(header))]
    fmt = "  ".join(f"{{:<{w}}}" for w in widths)
    out = [fmt.format(*header), fmt.format(*["-" * w for w in widths])]
    out += [fmt.format(*[str(c) for c in r]) for r in rows]
    return out


def _span_section(snap: dict) -> List[str]:
    hists = snap.get("metrics", {}).get("histograms", {})
    rows = []
    for name, agg in sorted(hists.items()):
        if not name.startswith("span.") or not agg.get("count"):
            continue
        rows.append([
            name[len("span."):], agg["count"], _fmt_s(agg["total"]),
            _fmt_s(agg["mean"]), _fmt_s(agg["max"]),
        ])
    if not rows:
        return []
    return ["", "## Spans (wall-clock attribution)", ""] + _table(
        rows, ["span", "calls", "total", "mean", "max"])


def _fmt_flops(n: float) -> str:
    n = float(n)
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(n) < 1000.0 or unit == "P":
            return f"{n:.4g} {unit}FLOP".replace("  ", " ")
        n /= 1000.0
    return f"{n:.4g} PFLOP"


def _perf_totals(snap: dict) -> dict:
    """Parse the deterministic perf.<span>.flops.<dtype> /
    perf.<span>.bytes counters back into per-span cost totals."""
    counters = snap.get("metrics", {}).get("counters", {})
    per: dict = {}
    for name, val in counters.items():
        if not name.startswith("perf.") or not val:
            continue
        rest = name[len("perf."):]
        if ".flops." in rest:
            span, dt = rest.rsplit(".flops.", 1)
            row = per.setdefault(span, {"flops": {}, "bytes": 0})
            row["flops"][dt] = row["flops"].get(dt, 0) + val
        elif rest.endswith(".bytes"):
            span = rest[:-len(".bytes")]
            row = per.setdefault(span, {"flops": {}, "bytes": 0})
            row["bytes"] += val
    return per


def _perf_section(snap: dict) -> List[str]:
    """Cost attribution: analytic FLOPs/bytes per span with FLOP/s and
    MFU derived against the snapshot's embedded peak table."""
    per = _perf_totals(snap)
    if not per:
        return []
    hists = snap.get("metrics", {}).get("histograms", {})
    info = snap.get("platform") or {}
    peaks = info.get("peak_flops") or {}
    rows = []
    for span in sorted(per):
        flops_by_dtype = per[span]["flops"]
        flops = sum(flops_by_dtype.values())
        secs = (hists.get(f"span.{span}") or {}).get("total") or 0.0
        gfs = f"{flops / secs / 1e9:.4g}" if secs else "-"
        mfu = "-"
        if secs and peaks:
            peak_s = 0.0
            for dt, fl in flops_by_dtype.items():
                peak = peaks.get(dt)
                if not peak:
                    peak_s = None
                    break
                peak_s += fl / peak
            if peak_s is not None:
                mfu = f"{peak_s / secs:.2%}"
        dts = "+".join(sorted(flops_by_dtype))
        bps = (_fmt_bytes(per[span]["bytes"] / secs) + "/s"
               if secs and per[span]["bytes"] else "-")
        rows.append([span, _fmt_flops(flops), dts, gfs, mfu, bps])
    plat = info.get("platform", "unknown")
    tag = " — NOMINAL peaks, not a hardware claim" if info.get("nominal") else ""
    lines = ["", f"## Cost attribution (analytic model over span "
                 f"host-time; MFU vs {plat} peak{tag})", ""]
    return lines + _table(
        rows, ["span", "flops", "dtype", "GFLOP/s", "MFU", "bytes/s"])


def _comms_section(snap: dict) -> List[str]:
    counters = snap.get("metrics", {}).get("counters", {})
    ops = sorted({
        name[len("comms."):-len(".calls")]
        for name in counters
        if name.startswith("comms.") and name.endswith(".calls")
    })
    rows = []
    any_wire = any(counters.get(f"comms.{op}.wire_bytes") for op in ops)
    for op in ops:
        calls = counters.get(f"comms.{op}.calls", 0)
        if not calls:
            continue
        row = [op, calls, _fmt_bytes(counters.get(f"comms.{op}.bytes", 0))]
        if any_wire:
            row.append(_fmt_bytes(counters.get(f"comms.{op}.wire_bytes", 0)))
        rows.append(row)
    if not rows:
        return []
    header = ["collective", "calls", "bytes"] + (["wire"] if any_wire else [])
    lines = ["", "## Collectives (traced ops; bytes = per-rank payload"
                 + ("; wire = modeled per-rank traffic" if any_wire else "")
                 + ")", ""]
    return lines + _table(rows, header)


def _serve_section(snap: dict) -> List[str]:
    counters = snap.get("metrics", {}).get("counters", {})
    hists = snap.get("metrics", {}).get("histograms", {})
    lines: List[str] = []
    hit = counters.get("serve.compile_cache.hit", 0)
    miss = counters.get("serve.compile_cache.miss", 0)
    warm = hists.get("serve.warmup_compile_s", {})
    if hit or miss or warm.get("count"):
        lines += ["", "## Serving compile cache", ""]
        total = hit + miss
        rate = f"{hit / total:.1%}" if total else "-"
        lines.append(f"bucket-program hits: {hit}/{total} ({rate})")
        if warm.get("count"):
            lines.append(
                f"warmup compiles: {warm['count']} "
                f"(total {_fmt_s(warm['total'])}, max {_fmt_s(warm['max'])})")
    for cname, section in sorted(
            snap.get("metrics", {}).get("collectors", {}).items()):
        if not isinstance(section, dict):
            continue
        lines += ["", f"## Collector: {cname}", ""]
        for key in sorted(section):
            val = section[key]
            if isinstance(val, float):
                val = f"{val:.6g}"
            lines.append(f"{key}: {val}")
    return lines


_STAGE_ORDER = ("serve.stage.queue_wait_s", "serve.stage.linger_s",
                "serve.stage.device_s", "serve.stage.scatter_s")


def _trace_section(snap: dict) -> List[str]:
    """Per-stage request-latency attribution (obs.trace): the stage
    histograms in pipeline order — their deltas telescope, so the
    totals decompose end-to-end latency — plus terminal outcomes and
    the dropped-request queue-wait story."""
    counters = snap.get("metrics", {}).get("counters", {})
    hists = snap.get("metrics", {}).get("histograms", {})
    rows = []
    for name in _STAGE_ORDER:
        agg = hists.get(name) or {}
        if agg.get("count"):
            rows.append([
                name[len("serve.stage."):-len("_s")], agg["count"],
                _fmt_s(agg["total"]), _fmt_s(agg["mean"]), _fmt_s(agg["max"]),
            ])
    outcomes = {name[len("serve.outcome."):]: val
                for name, val in sorted(counters.items())
                if name.startswith("serve.outcome.") and val}
    drop = hists.get("serve.drop_wait_s") or {}
    traces = sum(1 for e in snap.get("events", [])
                 if e.get("kind") == "trace")
    if not rows and not outcomes and not traces:
        return []
    lines = ["", "## Request tracing (per-stage latency attribution)", ""]
    if rows:
        lines += _table(rows, ["stage", "requests", "total", "mean", "max"])
    if outcomes:
        lines += ["", "terminal outcomes: "
                  + "  ".join(f"{k}={v}" for k, v in sorted(outcomes.items()))]
    if drop.get("count"):
        lines.append(
            f"dropped-request queue wait: {drop['count']} requests, "
            f"mean {_fmt_s(drop['mean'])}, max {_fmt_s(drop['max'])}")
    if traces:
        lines.append(f"trace records on bus: {traces}")
    return lines


def _slo_section(snap: dict, limit: int = 40) -> List[str]:
    """SLO watchtower verdicts: breach/recover totals plus the
    transition timeline with both window burns."""
    counters = snap.get("metrics", {}).get("counters", {})
    breaches = counters.get("slo.breach", 0)
    recovers = counters.get("slo.recover", 0)
    events = [e for e in snap.get("events", [])
              if e.get("kind") in ("slo.breach", "slo.recover")]
    if not (breaches or recovers or events):
        return []
    lines = ["", "## SLO watchtower", "",
             f"breaches: {breaches}  recoveries: {recovers}"]
    if events:
        lines.append("")
        t0 = snap["events"][0]["t"] if snap.get("events") else 0.0
        for e in events[-limit:]:
            lines.append(
                f"[{e['t'] - t0:+9.3f}s] #{e['seq']:<5d} {e['kind']:<12s} "
                f"objective={e.get('objective', '-')} "
                f"fast_burn={e.get('fast_burn', '-')} "
                f"slow_burn={e.get('slow_burn', '-')}")
    return lines


def _integrity_section(snap: dict, limit: int = 40) -> List[str]:
    """Integrity watchdog rollup: scrub coverage counters (slices, lists
    re-hashed), detected rot, containment/repair tallies, and the
    mismatch/quarantine/repair/restore timeline — a post-incident read
    of "what rotted, when was it caught, how was it fixed"."""
    counters = snap.get("metrics", {}).get("counters", {})
    stats = {name: counters.get(f"integrity.{name}", 0)
             for name in ("scans", "lists_scanned", "rot_injected",
                          "mismatches", "quarantines", "repairs",
                          "failed_repairs", "restores")}
    events = [e for e in snap.get("events", [])
              if str(e.get("kind", "")).startswith("integrity.")]
    if not (any(stats.values()) or events):
        return []
    lines = ["", "## Integrity", "",
             f"scrub slices: {stats['scans']}  "
             f"lists re-hashed: {stats['lists_scanned']}  "
             f"mismatches: {stats['mismatches']}"
             + (f"  (rot injected: {stats['rot_injected']})"
                if stats["rot_injected"] else ""),
             f"quarantines: {stats['quarantines']}  "
             f"repairs: {stats['repairs']}"
             + (f"  FAILED repairs: {stats['failed_repairs']}"
                if stats["failed_repairs"] else "")
             + (f"  restores: {stats['restores']}"
                if stats["restores"] else "")]
    notable = [e for e in events if e.get("kind") != "integrity.scan"]
    if notable:
        lines.append("")
        t0 = snap["events"][0]["t"] if snap.get("events") else 0.0
        for e in notable[-limit:]:
            fields = {k: v for k, v in e.items()
                      if k not in ("seq", "t", "kind")}
            detail = " ".join(f"{k}={v}" for k, v in sorted(fields.items()))
            kind = e["kind"].split(".", 1)[1]
            lines.append(f"[{e['t'] - t0:+9.3f}s] #{e['seq']:<5d} "
                         f"{kind:<12s} {detail}")
    return lines


def _job_section(snap: dict, limit: int = 80) -> List[str]:
    """The job runner's stage-transition timeline (the jobs layer): one
    line per kind="job" event — start/skip/resume/commit/failed/blocked/
    preempt plus the streaming checkpoint/resume beats — so a resumed or
    preempted long run reads as a story, not a grep."""
    events = [e for e in snap.get("events", []) if e.get("kind") == "job"]
    if not events:
        return []
    lines = ["", f"## Job timeline (stage transitions; last {limit})", ""]
    t0 = snap["events"][0]["t"] if snap.get("events") else 0.0
    for e in events[-limit:]:
        fields = {k: v for k, v in e.items()
                  if k not in ("seq", "t", "kind", "job", "stage", "action")}
        detail = " ".join(f"{k}={v}" for k, v in sorted(fields.items()))
        where = e.get("job", "-")
        if e.get("stage"):
            where += f".{e['stage']}"
        lines.append(f"[{e['t'] - t0:+9.3f}s] #{e['seq']:<5d} "
                     f"{where:<28s} {e.get('action', '-'):<18s} {detail}")
    return lines


def _timeline_section(snap: dict,
                      kinds=("fault", "health", "retry", "compile", "log",
                             "mutation"),
                      limit: int = 60) -> List[str]:
    events = [e for e in snap.get("events", []) if e.get("kind") in kinds]
    if not events:
        return []
    lines = ["", f"## Timeline ({', '.join(kinds)}; last {limit})", ""]
    t0 = snap["events"][0]["t"] if snap.get("events") else 0.0
    for e in events[-limit:]:
        fields = {k: v for k, v in e.items() if k not in ("seq", "t", "kind")}
        detail = " ".join(f"{k}={v}" for k, v in sorted(fields.items()))
        lines.append(f"[{e['t'] - t0:+9.3f}s] #{e['seq']:<5d} {e['kind']:<8s} {detail}")
    return lines


def render(snap: dict, title: str = "raft_tpu_torch run report") -> str:
    """Render one snapshot dict (the `obs.snapshot()` shape) as text."""
    n_events = len(snap.get("events", []))
    counters = snap.get("metrics", {}).get("counters", {})
    gauges = snap.get("metrics", {}).get("gauges", {})
    lines = [f"# {title}", "",
             f"events: {n_events}  counters: {len(counters)}  "
             f"gauges: {len(gauges)}"]
    lines += _span_section(snap)
    lines += _perf_section(snap)
    lines += _comms_section(snap)
    lines += _serve_section(snap)
    lines += _trace_section(snap)
    lines += _slo_section(snap)
    lines += _integrity_section(snap)
    misc = {
        name: val for name, val in sorted(counters.items())
        if not name.startswith(("comms.", "integrity.", "perf.",
                                "serve.compile_cache.", "serve.outcome.",
                                "slo."))
        and val
    }
    if misc:
        lines += ["", "## Counters", ""] + _table(
            [[n, v] for n, v in misc.items()], ["counter", "value"])
    lines += _job_section(snap)
    lines += _timeline_section(snap)
    return "\n".join(lines) + "\n"


# -- cross-rank trace merge --------------------------------------------

def _rank_of(snap: dict, fallback: int) -> int:
    rank = snap.get("rank")
    return int(rank) if rank is not None else int(fallback)


def _merged_span_section(snaps: List[dict], ranks: List[int]) -> List[str]:
    names = sorted({
        name[len("span."):]
        for snap in snaps
        for name, agg in snap.get("metrics", {}).get("histograms", {}).items()
        if name.startswith("span.") and agg.get("count")
    })
    if not names:
        return []
    rows = []
    stragglers = []
    for name in names:
        totals = []
        for snap in snaps:
            agg = snap.get("metrics", {}).get("histograms", {}).get(
                f"span.{name}") or {}
            totals.append(float(agg.get("total") or 0.0))
        present = [t for t in totals if t > 0]
        skew = (max(present) / min(present)) if len(present) > 1 else None
        rows.append([name] + [_fmt_s(t) if t else "-" for t in totals]
                    + [f"{skew:.2f}x" if skew else "-"])
        if skew is not None and skew > 1.5:
            worst = ranks[totals.index(max(present))]
            stragglers.append(
                f"straggler: span {name!r} slowest on rank {worst} "
                f"({skew:.2f}x the fastest rank)")
    lines = ["", "## Per-rank span attribution", ""] + _table(
        rows, ["span"] + [f"r{r}" for r in ranks] + ["skew"])
    return lines + ([""] + stragglers if stragglers else [])


def _merged_comms_section(snaps: List[dict], ranks: List[int]) -> List[str]:
    ops = sorted({
        name[len("comms."):-len(".calls")]
        for snap in snaps
        for name in snap.get("metrics", {}).get("counters", {})
        if name.startswith("comms.") and name.endswith(".calls")
    })
    rows = []
    desyncs = []
    for op in ops:
        calls = [snap.get("metrics", {}).get("counters", {}).get(
            f"comms.{op}.calls", 0) for snap in snaps]
        if not any(calls):
            continue
        nbytes = [snap.get("metrics", {}).get("counters", {}).get(
            f"comms.{op}.bytes", 0) for snap in snaps]
        rows.append([op, "/".join(str(c) for c in calls),
                     "/".join(_fmt_bytes(b) for b in nbytes)])
        if len(set(calls)) > 1:
            desyncs.append(
                f"DESYNC: collective {op!r} call counts differ across "
                f"ranks ({'/'.join(str(c) for c in calls)}) — a rank is "
                f"missing collectives (hang risk)")
    if not rows:
        return []
    lines = ["", "## Collective skew (per-rank calls / payload bytes)",
             ""] + _table(rows, ["collective",
                                 "calls " + "/".join(f"r{r}" for r in ranks),
                                 "bytes"])
    return lines + ([""] + desyncs if desyncs else [])


def _merged_timeline(snaps: List[dict], ranks: List[int],
                     kinds=("fault", "health"), limit: int = 60) -> List[str]:
    merged = []
    for snap, rank in zip(snaps, ranks):
        for e in snap.get("events", []):
            if e.get("kind") in kinds:
                merged.append((int(e.get("seq", 0)), rank, e))
    if not merged:
        return []
    merged.sort(key=lambda item: (item[0], item[1]))
    lines = ["", f"## Merged timeline ({', '.join(kinds)}; aligned by "
                 f"per-rank seq; last {limit})", ""]
    for seq, rank, e in merged[-limit:]:
        fields = {k: v for k, v in e.items() if k not in ("seq", "t", "kind")}
        detail = " ".join(f"{k}={v}" for k, v in sorted(fields.items()))
        lines.append(f"r{rank} #{seq:<5d} {e['kind']:<8s} {detail}")
    return lines


def render_merged(snaps: List[dict],
                  title: str = "raft_tpu_torch merged rank report") -> str:
    """Render several per-rank snapshots as one distributed view. Ranks
    come from each snapshot's `rank` field (save order otherwise); the
    seq-ordered bus aligns the merged timeline — rank clocks are not
    comparable, sequence positions of the SPMD-identical programs are."""
    order = sorted(range(len(snaps)), key=lambda i: _rank_of(snaps[i], i))
    snaps = [snaps[i] for i in order]
    ranks = [_rank_of(snap, i) for i, snap in enumerate(snaps)]
    world = next((snap.get("world") for snap in snaps
                  if snap.get("world") is not None), None)
    lines = [f"# {title}", "",
             f"ranks merged: {len(snaps)}  world: {world if world else '-'}"]
    lines += _merged_span_section(snaps, ranks)
    lines += _merged_comms_section(snaps, ranks)
    lines += _merged_timeline(snaps, ranks)
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m raft_tpu_torch.obs.report",
        description="Render a human-readable run report from an "
                    "obs.save_snapshot() JSON file ('-' reads stdin). "
                    "With --merge, several per-rank snapshots render as "
                    "one distributed timeline.",
    )
    parser.add_argument("snapshot", nargs="+",
                        help="path(s) to snapshot JSON, or '-'")
    parser.add_argument("--title", default=None)
    parser.add_argument("--merge", action="store_true",
                        help="merge several per-rank snapshots into one "
                             "distributed report")
    args = parser.parse_args(argv)

    def load(path):
        if path == "-":
            return json.load(sys.stdin)
        with open(path) as f:
            return json.load(f)

    if args.merge:
        snaps = [load(p) for p in args.snapshot]
        sys.stdout.write(render_merged(
            snaps, title=args.title or "raft_tpu_torch merged rank report"))
        return 0
    if len(args.snapshot) != 1:
        parser.error("multiple snapshots require --merge")
    snap = load(args.snapshot[0])
    sys.stdout.write(render(snap, title=args.title or "raft_tpu_torch run report"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
