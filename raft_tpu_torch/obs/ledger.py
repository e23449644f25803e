"""Append-only bench ledger: the perf trajectory, one JSON line per row
(counterpart of raft_tpu/obs/ledger.py).

Per-run result files are overwritten by the next run; the ledger keeps
the history. `bank_row` appends every banked row, stamped with the git
SHA, the platform ("gpu" or "cpu") and whatever attribution the row
carries, so later runs can be held against earlier ones.

File discipline:
  - append-only JSONL (one `json.dumps` line per entry, mode "a"); a
    torn final line from a killed process never poisons the file:
    `read()` skips unparseable lines, and `append` terminates a torn
    line before its own.
  - `RAFT_TPU_BENCH_LEDGER` overrides the path (hermetic runs and tests
    point it at a temporary file).
  - entries never carry absolute paths or host identity.

Standard library only: `sniff_platform` reads `torch.cuda`, imported
inside it.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import List, Optional

#: env override for the ledger path (CI temp ledgers, tests)
ENV_PATH = "RAFT_TPU_BENCH_LEDGER"

#: default file name, resolved against a caller-provided directory
DEFAULT_NAME = "BENCH_LEDGER.jsonl"


def resolve_path(default_dir: Optional[str] = None) -> str:
    """The ledger path: `RAFT_TPU_BENCH_LEDGER` when set, else
    DEFAULT_NAME under `default_dir` (or the working directory)."""
    env = os.environ.get(ENV_PATH, "").strip()
    if env:
        return env
    return os.path.join(default_dir or os.getcwd(), DEFAULT_NAME)


def git_sha(repo_dir: Optional[str] = None) -> str:
    """Short git SHA of `repo_dir` (or cwd); "unknown" when git is
    unavailable — a ledger row beats a crashed bench."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"],
            capture_output=True, text=True, timeout=10.0,
            cwd=repo_dir or None,
        )
        sha = out.stdout.strip()
        return sha if out.returncode == 0 and sha else "unknown"
    except Exception:
        return "unknown"


def make_entry(*, bench: str, row: dict, platform: Optional[str] = None,
               sha: Optional[str] = None, repo_dir: Optional[str] = None,
               **tags) -> dict:
    """One ledger entry: identity fields first (sha / utc / platform /
    bench / honesty tags), the banked row nested under "row" so bench
    row keys can never collide with ledger bookkeeping."""
    entry = {
        "sha": sha if sha is not None else git_sha(repo_dir),
        "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
        "platform": platform or "unknown",
        "bench": str(bench),
    }
    for key, val in sorted(tags.items()):
        if val is not None:
            entry[key] = val
    entry["row"] = dict(row)
    return entry


def append(entry: dict, path: Optional[str] = None,
           default_dir: Optional[str] = None) -> str:
    """Append one entry as a JSON line; returns the path written. The
    write is a single buffered line in append mode — concurrent bench
    processes interleave whole lines, never halves of two. A torn final
    line (a SIGKILL mid-append left no trailing newline) is terminated
    first, so the dead process's half-row corrupts only itself, never
    the next bench's entry."""
    p = path if path is not None else resolve_path(default_dir)
    line = json.dumps(entry, sort_keys=False)
    prefix = ""
    try:
        with open(p, "rb") as f:
            f.seek(-1, os.SEEK_END)
            if f.read(1) != b"\n":
                prefix = "\n"
    except (OSError, ValueError):
        pass  # missing or empty file: nothing to terminate
    with open(p, "a") as f:
        f.write(prefix + line + "\n")
    return p


def sniff_platform() -> str:
    """"gpu" when a CUDA card is present, else "cpu" ("unknown" when
    torch cannot say)."""
    try:
        import torch

        return "gpu" if torch.cuda.is_available() else "cpu"
    except Exception:
        return "unknown"


def bank_row(*, bench: str, row: dict, platform: Optional[str] = None,
             repo_dir: Optional[str] = None,
             ledger_dir: Optional[str] = None, **tags) -> Optional[str]:
    """The one banking entry point every producer shares: sniff the
    platform when not given, stamp the entry, append, and never raise (a
    broken ledger must not kill the run that just measured something).
    Returns the path written, or None on failure."""
    try:
        entry = make_entry(
            bench=bench, row=row,
            platform=platform if platform is not None else sniff_platform(),
            repo_dir=repo_dir, **tags)
        return append(entry, default_dir=ledger_dir or repo_dir)
    except Exception:
        return None


def read(path: str) -> List[dict]:
    """Every parseable entry, file order. Torn/corrupt lines (a SIGKILL
    mid-append) are skipped, not fatal."""
    rows: List[dict] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    entry = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(entry, dict):
                    rows.append(entry)
    except OSError:
        return []
    return rows
