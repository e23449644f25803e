"""The trace reduction on a hand-made trace: busy time as a union inside
the window, idle gaps charged to the host's innermost range."""

import pytest

from portbench.harness.trace import reduce_events


def _x(cat, name, ts, dur, pid=0, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": pid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def test_busy_union_and_gaps_by_range():
    ev = [_x("user_annotation", "window", 100.0, 1000.0),
          _x("user_annotation", "search", 100.0, 400.0),
          _x("user_annotation", "refine", 500.0, 300.0),
          _x("user_annotation", "to_host", 800.0, 300.0),
          _x("kernel", "scan", 150.0, 200.0),
          _x("kernel", "scan", 300.0, 100.0),      # overlaps the first: union 150..400
          _x("gpu_memcpy", "copy", 850.0, 100.0),
          _x("kernel", "early", 0.0, 120.0),       # clipped to the window: 100..120
          _x("cpu_op", "aten::mm", 150.0, 50.0)]   # host op: not device time
    r = reduce_events(ev, ("search", "refine", "to_host"))
    assert r["window_s"] == pytest.approx(1000e-6)
    assert r["busy_s"] == pytest.approx((20 + 250 + 100) * 1e-6)
    gaps = dict(r["idle_gaps"])
    # holes: 120..150 (search), 400..850 (mid 625: refine), 950..1100 (mid 1025: to_host)
    assert gaps == pytest.approx({"search": 30e-6, "refine": 450e-6, "to_host": 150e-6})
    ops = dict(r["device_ops"])
    assert ops["scan"] == pytest.approx(300e-6) and ops["early"] == pytest.approx(20e-6)


def test_busy_is_averaged_over_devices():
    ev = [_x("user_annotation", "window", 0.0, 100.0),
          _x("kernel", "a", 0.0, 100.0, pid=0), _x("kernel", "a", 0.0, 50.0, pid=1)]
    r = reduce_events(ev, ())
    assert r["busy_s"] == pytest.approx(75e-6)
    assert dict(r["idle_gaps"]) == pytest.approx({"between": 25e-6})


def test_a_trace_without_a_window_is_refused():
    with pytest.raises(ValueError):
        reduce_events([_x("kernel", "a", 0.0, 1.0)], ())


def test_range_busy_time_follows_the_launch_not_the_host_range():
    ev = [_x("user_annotation", "window", 0.0, 1000.0),
          _x("user_annotation", "search", 0.0, 100.0),
          _x("user_annotation", "search", 500.0, 100.0),
          _x("user_annotation", "to_host", 100.0, 50.0),
          _x("cuda_runtime", "cudaLaunchKernel", 10.0, 5.0, corr=1),
          _x("cuda_runtime", "cudaLaunchKernel", 20.0, 5.0, corr=2),
          _x("cuda_runtime", "cudaMemcpyAsync", 110.0, 5.0, corr=3),
          _x("cuda_runtime", "cudaLaunchKernel", 510.0, 5.0, corr=4),
          # launched in the first search, run past its host range's end
          _x("kernel", "scan", 50.0, 150.0, corr=1),
          _x("kernel", "select", 200.0, 50.0, corr=2),
          _x("gpu_memcpy", "copy", 260.0, 40.0, corr=3),
          _x("kernel", "scan", 520.0, 60.0, corr=4),
          _x("kernel", "unmatched", 700.0, 10.0)]
    r = reduce_events(ev, ("search", "to_host"))
    assert r["range_count"] == {"search": 2, "to_host": 1}
    assert r["range_busy_s"] == pytest.approx({"search": (150 + 50 + 60) * 1e-6,
                                               "to_host": 40e-6})
