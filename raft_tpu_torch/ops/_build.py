"""Build and load the hand-written CUDA kernels under `raft_tpu_torch/csrc/`.

Each `.cu` source compiles with `nvcc` for `sm_90a` into its own shared
library with a plain C interface, loaded with `ctypes`. The headers
(`fused_common.cuh`, `block_topk.cuh`, any `*.cuh` under `csrc/`) are not
listed: the library's file name carries a hash of its source and of every
header, so an edited kernel or header never loads a stale build. Building happens at first use (or all
at once, one `nvcc` per source in parallel, through `build_all`), inside
the package's `_build/` directory, which git ignores. nvcc keeps its IEEE
defaults (no `--use_fast_math`): the pairwise kernel's canberra term needs
a correctly rounded division and its KL term an accurate `logf`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
#: one shared library per kernel source
KERNEL_SOURCES = ("fused_list_topk.cu", "fused_topk.cu", "fused_list_topk_int8.cu",
                  "pq_list_scan.cu", "pairwise_tiled.cu", "fused_l2_argmin.cu",
                  "select_counting.cu", "fused_bitplane_topk.cu")

_lock = threading.Lock()
_libs: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    found = cand if os.path.exists(cand) else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def _target(source: str) -> Path:
    h = hashlib.sha256()
    for name in sorted([source] + [p.name for p in CSRC.glob("*.cuh")]):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"{Path(source).stem}_{h.hexdigest()[:12]}.so"


def _command(source: str, out: Path) -> list:
    return [
        _nvcc(), "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
        "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
        "-I", str(CSRC), "-o", str(out) + ".tmp", str(CSRC / source),
    ]


def build_all(sources=KERNEL_SOURCES) -> dict:
    """Compile every missing library, one `nvcc` per source, all started
    together. Returns {source: ptxas report} for the ones built here."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in sources:
        out = _target(src)
        if not out.exists():
            procs[src] = (out, subprocess.Popen(
                _command(src, out), stdout=subprocess.PIPE,
                stderr=subprocess.STDOUT, text=True))
    reports = {}
    failed = []
    for src, (out, p) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{src}:\n{log}")
            continue
        os.replace(str(out) + ".tmp", out)
        reports[src] = log
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return reports


def load(source: str) -> ctypes.CDLL:
    """The loaded library for `source`, building it on first use."""
    with _lock:
        lib = _libs.get(source)
        if lib is None:
            out = _target(source)
            if not out.exists():
                build_all((source,))
            lib = ctypes.CDLL(str(out))
            _libs[source] = lib
        return lib
