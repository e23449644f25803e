"""Find a cell's parts by the names in `BENCHMARK.json`.

A cell ("workload") names a configuration and a traffic mix. The
configuration's entry gives its file; the file's "system" names the
caller of the port's entry points (`systems/<system>.py`); the mix is
`traffic/<traffic>.json`; each per-layer metric is read by
`metrics/<name>.py`. A later change adds a configuration, a mix or a
metric by adding files and entries, never by editing one of these.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

#: the benchmark's own directory (`portbench/`) and the checkout's root
BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    """One workload of the manifest with everything it names."""

    name: str
    chips: int
    config: dict          # the configuration's file, as loaded
    mix: dict             # the traffic mix's file, as loaded
    system: ModuleType    # systems/<config["system"]>.py
    end_to_end: list      # the manifest's end-to-end metrics this cell reports
    per_layer: list       # the manifest's per-layer metrics this cell reports


def load_module(path: Path, name: str) -> ModuleType:
    """Import a file by its path (metric files have dots in their names)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def read_keys(config: dict, section: str, keys) -> dict:
    """`config[section]`, refused where it sets a key outside `keys`: a
    system reads every key of its configuration's index and search
    sections, so a key it would pass over cannot change a cell unseen."""
    held = config[section]
    extra = sorted(set(held) - set(keys))
    if extra:
        raise ValueError(f"{config.get('name')}: {section} keys {extra} are read by nothing "
                         f"of the {config.get('system')} system (it reads {sorted(keys)})")
    return held


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


class Manifest:
    """`BENCHMARK.json` under `root`, its files under `bench_dir`."""

    def __init__(self, root: Path = ROOT, bench_dir: Path = BENCH_DIR):
        self.root = Path(root)
        self.bench_dir = Path(bench_dir)
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def cell(self, workload: str) -> Cell:
        by_name = {w["name"]: w for w in self.data["workloads"]}
        if workload not in by_name:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                           f"known: {sorted(by_name)}")
        w = by_name[workload]
        configs = {c["name"]: c for c in self.data["configs"]}
        config = json.loads((self.root / configs[w["config"]]["file"]).read_text())
        mix = json.loads((self.bench_dir / "traffic" / f"{w['traffic']}.json").read_text())
        system = load_module(self.bench_dir / "systems" / f"{config['system']}.py",
                             f"portbench_system_{config['system']}")
        return Cell(
            name=workload, chips=int(w["chips"]), config=config, mix=mix, system=system,
            end_to_end=[m for m in self.data["end_to_end"] if _applies(m, workload)],
            per_layer=[m for m in self.data["per_layer"] if _applies(m, workload)])

    def metric_reader(self, name: str) -> ModuleType:
        return load_module(self.bench_dir / "metrics" / f"{name}.py",
                           "portbench_metric_" + name.replace(".", "_"))
