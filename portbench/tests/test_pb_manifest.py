"""The manifest: BENCHMARK.json against the benchmark's contract, and the
loader finding a configuration, a mix and a metric added as new files."""

import json
import re
import shutil
from pathlib import Path

import pytest

from portbench.harness.manifest import BENCH_DIR, ROOT, Manifest, load_module

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entry_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert (ROOT / c["file"]).is_file() and c["file"].startswith("portbench/")
        assert json.loads((ROOT / c["file"]).read_text())["name"] == c["name"]
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and w["config"] in names and len(w["why"]) <= 200
        assert (BENCH_DIR / "traffic" / f"{w['traffic']}.json").is_file()
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert (BENCH_DIR / "metrics" / f"{m['name']}.py").is_file()
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        moved = e2e[m["moves"]]
        for w in m["workloads"]:   # each cell it names reports the metric it moves
            assert "workloads" not in moved or w in moved["workloads"]
    all_names = names + [w["name"] for w in BENCH["workloads"]] + [m["name"] for m in metrics]
    assert all(NAME.match(n) for n in all_names) and len(all_names) == len(set(all_names))


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    m = Manifest()
    for w in BENCH["workloads"]:
        cell = m.cell(w["name"])
        e2e = [x["name"] for x in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2 and cell.per_layer


def test_loader_finds_a_config_mix_and_metric_added_as_files(tmp_path):
    bench_dir = tmp_path / "pb"
    for sub in ("systems", "traffic", "metrics"):
        shutil.copytree(BENCH_DIR / sub, bench_dir / sub)
    (bench_dir / "configs").mkdir()
    cfg = json.loads((BENCH_DIR / "configs" / "sift1m-ivfflat.json").read_text())
    cfg["name"] = "new-config"
    (bench_dir / "configs" / "new-config.json").write_text(json.dumps(cfg))
    (bench_dir / "traffic" / "burst7.json").write_text(json.dumps(
        {"kind": "search", "loop": "closed", "clients": 1, "batch": 7}))
    (bench_dir / "metrics" / "new_metric.x.py").write_text("def read(run):\n    return 42.0\n")
    bench = dict(BENCH)
    bench["configs"] = BENCH["configs"] + [{"name": "new-config", "source": "x",
                                           "file": "pb/configs/new-config.json",
                                           "reduced": [], "why": "x"}]
    bench["workloads"] = BENCH["workloads"] + [{"name": "new-config.burst7",
                                               "config": "new-config", "traffic": "burst7",
                                               "chips": 1, "why": "x"}]
    bench["per_layer"] = BENCH["per_layer"] + [{"name": "new_metric.x", "unit": "ms",
                                               "better": "lower", "source": "program_span",
                                               "layer": "device", "moves": "qps",
                                               "workloads": ["new-config.burst7"]}]
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    m = Manifest(root=tmp_path, bench_dir=bench_dir)
    cell = m.cell("new-config.burst7")
    assert cell.config["name"] == "new-config" and cell.mix["batch"] == 7
    assert hasattr(cell.system, "System")
    assert [x["name"] for x in cell.per_layer] == ["new_metric.x"]
    assert m.metric_reader("new_metric.x").read({}) == 42.0
    # metrics that name their cells leave the new one out; the others hold it
    assert {x["name"] for x in cell.end_to_end} == {"recall", "setup_s"}


def test_an_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        Manifest().cell("no-such.cell")


@pytest.mark.parametrize("config", ["deep10m-ivfpq", "sift1m-ivfflat"])
@pytest.mark.parametrize("section", ["index", "search"])
def test_a_key_no_system_reads_is_refused(config, section):
    cfg = json.loads((BENCH_DIR / "configs" / f"{config}.json").read_text())
    system = load_module(BENCH_DIR / "systems" / f"{cfg['system']}.py", f"keys_{config}")
    system.System(cfg, "cpu")   # every key of the file is read
    cfg[section]["unread_option"] = 1
    with pytest.raises(ValueError, match="unread_option"):
        system.System(cfg, "cpu")
