"""On the card only (the `chip` marker): each cell's command, short, from
this checkout. Run there with `python -m pytest portbench/tests -m chip`."""

import json
import subprocess
import sys

import pytest

from conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


@pytest.mark.chip
@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_cell_runs_correct_on_the_card(chip_device, workload):
    r = subprocess.run([sys.executable, "portbench/run.py", "--workload", workload,
                        "--seed", "2147483677", "--seconds", "2", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=1200)
    assert r.returncode == 0, r.stderr[-4000:]
    line = json.loads(r.stdout.strip().splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu", r.stderr[-2000:]
