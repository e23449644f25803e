"""The schema of a run's last line, and the runs that must print none."""

import json
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT, run_tiny

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
UNITS = {m["name"]: m["unit"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}


@pytest.mark.parametrize("trace", [False, True])
def test_last_line_schema(tiny_manifest, trace):
    result, err = run_tiny(tiny_manifest, "deep10m-ivfpq.batch10k", trace=trace)
    line = json.loads(json.dumps(result))
    keys = list(line)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and set(keys) <= {"correct", "attempted", "failed", "metrics",
                                                   "device", "breakdown", "checks"}
    assert isinstance(line["correct"], bool) and line["attempted"] > 0 and line["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == UNITS[name]
    wanted = {"qps", "latency_p95_ms", "recall", "setup_s"}
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert all(len(v) <= 10 for v in line["breakdown"].values())
        # no device in a CPU run: nothing to read, so no per-layer metric
        assert line["metrics"] == {}
    else:
        assert set(line["metrics"]) == wanted
    for name, c in line["checks"].items():
        assert set(c) == {"value", "limit", "need"}
    # the numbers compared are the last lines of standard error
    tail = err.strip().splitlines()[-len(line["checks"]):]
    assert [t.split()[1] for t in tail] == list(line["checks"])


def test_no_card_no_result():
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "deep10m-ivfpq.build", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True, text=True, timeout=120,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert r.returncode != 0 and r.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload",
                        "deep10m-ivfpq.batch10k", "--seed", "5", "--seconds", "1", "--trace", "0"],
                       cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert r.returncode != 0 and r.stdout == ""

