"""Fixtures of the benchmark's own tests: a small manifest whose cells use
tiny copies of the configurations, run on the CPU with the port's plain
kernel versions. Tests that need a card carry the `chip` marker and skip
inside the `chip_device` fixture where none is found."""

from __future__ import annotations

import copy
import json
import sys
from pathlib import Path

import pytest

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: the tiny geometry every CPU run of a cell uses
TINY = {"deep10m-ivfpq": {"rows": 6000, "dim": 16, "queries": 10000, "blobs": 64, "n_lists": 16,
                          "pq_dim": 8, "n_probes": 12},
        "sift1m-ivfflat": {"rows": 5000, "dim": 16, "queries": 10000, "blobs": 64,
                           "n_lists": 16, "n_probes": 12}}


def pytest_configure(config):
    config.addinivalue_line("markers", "chip: needs a CUDA card (skips without one)")


@pytest.fixture
def chip_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("no CUDA card on this machine")
    return torch.device("cuda")


def tiny_config(name: str) -> dict:
    cfg = json.loads((BENCH_DIR / "configs" / f"{name}.json").read_text())
    t = TINY[name]
    cfg = copy.deepcopy(cfg)
    cfg["dataset"].update(rows=t["rows"], dim=t["dim"], queries=t["queries"])
    cfg["generator"]["blobs"] = t["blobs"]
    cfg["index"]["n_lists"] = t["n_lists"]
    cfg["index"]["kmeans_n_iters"] = 5
    if "pq_dim" in t:
        cfg["index"]["pq_dim"] = t["pq_dim"]
    cfg["search"]["n_probes"] = t["n_probes"]
    return cfg


@pytest.fixture
def tiny_manifest(tmp_path):
    """A checkout root holding BENCHMARK.json with the real cells and
    metrics, each configuration's file replaced by its tiny copy, and one
    cell more that only data files make."""
    from portbench.harness.manifest import Manifest

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    # the IVF-Flat cells that PERF.md's Open questions keep for later, made
    # of entries and files alone: the search and the build of sift1m-ivfflat
    bench["configs"].append({"name": "sift1m-ivfflat", "source": "x", "reduced": [],
                             "why": "x"})
    for traffic in ("batch10k", "build"):
        bench["workloads"].append({"name": f"sift1m-ivfflat.{traffic}",
                                   "config": "sift1m-ivfflat", "traffic": traffic, "chips": 1,
                                   "why": "data only"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if m.get("workloads") == ["deep10m-ivfpq.batch10k"]:
            m["workloads"] = m["workloads"] + ["sift1m-ivfflat.batch10k"]
    bench["per_layer"] += [{"name": name, "unit": unit, "better": better,
                            "source": "device_trace", "layer": layer, "moves": "qps",
                            "workloads": ["sift1m-ivfflat.batch10k"]}
                           for name, unit, better, layer in (
                               ("search_ms.ivfflat", "ms", "lower", "entry points"),
                               ("search_roofline_pct.ivfflat", "%", "higher", "kernels"))]
    for c in bench["configs"]:
        path = tmp_path / "configs" / f"{c['name']}.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(tiny_config(c["name"])))
        c["file"] = f"configs/{c['name']}.json"
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    return Manifest(root=tmp_path, bench_dir=BENCH_DIR)


def run_tiny(manifest, workload, patch=None, seconds=0.3, trace=False):
    """Run a cell of `manifest` on the CPU; `patch(System)` may return a
    subclass that breaks the timed path underneath."""
    import io
    import time

    from portbench.harness.cell import run_cell

    cell = manifest.cell(workload)
    if patch is not None:
        class Wrapped:
            System = patch(cell.system.System)
        cell.system = Wrapped
    real = manifest.cell
    manifest.cell = lambda name: cell if name == workload else real(name)
    err = io.StringIO()
    result = run_cell(manifest, workload, 2147483659, seconds, trace, "cpu",
                      time.perf_counter(), out=io.StringIO(), err=err)
    return result, err.getvalue()
