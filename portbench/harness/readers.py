"""What the per-layer metrics' readers share: a range's device time a
call, a share of a roofline, the device's idle share. Each returns None where the run has
nothing to read, and never 0 in place of a share it could not read."""

from __future__ import annotations


def _cell_is(run, system: str, kind: str) -> bool:
    return run["config"]["system"] == system and run["mix"]["kind"] == kind


def range_busy_ms(run, system: str, name: str):
    """The device's busy time in ms a call of the benchmark's range `name`
    in the traced window: the union of the device activities launched
    from inside the range (`trace.reduce_events`), over the calls. The
    host's gaps between them are not in it."""
    tr = run["trace"]
    if tr is None or not _cell_is(run, system, "search"):
        return None
    busy, calls = tr["range_busy_s"].get(name), tr["range_count"].get(name)
    if not busy or not calls:
        return None
    return 1e3 * busy / calls


def roofline_pct(run, system: str, kind: str, least_seconds):
    """100 x the least time one unit of the window's work needs (a batch,
    a build) over the device's busy time a unit in the traced slice.
    `least_seconds(config, mix)` gives the least time of one unit."""
    tr = run["trace"]
    units = run["traced_units"]
    if tr is None or not _cell_is(run, system, kind) or not units or tr["busy_s"] <= 0:
        return None
    return 100.0 * least_seconds(run["config"], run["mix"]) / (tr["busy_s"] / units)


def idle_pct(run, kind: str):
    """100 x the share of the traced window in which no kernel, copy or
    set ran on the device."""
    tr = run["trace"]
    if tr is None or run["mix"]["kind"] != kind or tr["window_s"] <= 0 or tr["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
