"""Host routines of the graph path in C++ (counterpart of
raft_tpu/native, the part the graph path needs).

`csrc/graph_host.cc` holds the port's own copy of the four routines:
COO rows -> CSR indptr, label compaction, the union-find dendrogram of
weight-sorted MST edges and its flat cut. It is compiled at first use
with the system C++ compiler (`g++ -O3`) into the package's `_build/`
directory, which git ignores; the library's file name carries a hash of
the source, as `ops/_build.py` names the kernels, so an edited source
never loads a stale build. Each wrapper returns None when the library is
not available, and its caller then takes the Python twin, as the JAX
package does (`sparse/formats.dense_to_csr`, `label.make_monotonic`,
`cluster/single_linkage._mst_linkage` and `_cut_tree`). `available()`
says which one ran; `load_error()` why the library did not load.

`csrc/loader_host.cc` is a second library of the same kind: the
prefetching ring reader of `io.FileBatchLoader` (`rt_loader_open /
acquire / release / close`, the JAX package's native reader), built the
same way at first use; `loader_lib()` returns it or None, and
`loader_error()` says why not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "csrc" / "graph_host.cc"
LOADER_SOURCE = _PKG / "csrc" / "loader_host.cc"
BUILD_DIR = _PKG / "_build"

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)


def _compiler() -> str:
    for name in (os.environ.get("CXX", ""), "g++", "c++"):
        found = shutil.which(name) if name else None
        if found:
            return found
    raise RuntimeError("no C++ compiler found (set CXX)")


class _Library:
    """One host library: its source, built at first use into `_build/`
    under a name that carries the source's hash, loaded and bound once."""

    def __init__(self, source: Path, bind):
        self.source = source
        self.bind = bind
        self.lock = threading.Lock()
        self.lib: Optional[ctypes.CDLL] = None
        self.tried = False
        self.error: Optional[str] = None

    def target(self) -> Path:
        digest = hashlib.sha256(self.source.read_bytes()).hexdigest()[:12]
        return BUILD_DIR / f"{self.source.stem}_{digest}.so"

    def build(self) -> Path:
        """Compile the library if it is missing; returns its path.
        Concurrent builds each write their own temporary file and rename
        it."""
        out = self.target()
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            subprocess.run([_compiler(), "-O3", "-std=c++17", "-shared", "-fPIC", "-pthread",
                            str(self.source), "-o", str(tmp)],
                           check=True, capture_output=True, timeout=300)
            os.replace(tmp, out)
        return out

    def get(self) -> Optional[ctypes.CDLL]:
        with self.lock:
            if self.lib is None and not self.tried:
                self.tried = True
                try:
                    lib = ctypes.CDLL(str(self.build()))
                    self.bind(lib)
                    self.lib = lib
                except (OSError, RuntimeError, AttributeError,
                        subprocess.SubprocessError) as exc:
                    detail = getattr(exc, "stderr", None) or b""
                    self.error = (f"{type(exc).__name__}: {exc} "
                                  f"{detail.decode(errors='replace')}")
            return self.lib


def _bind(lib: ctypes.CDLL) -> None:
    lib.gh_coo_rows_to_indptr.restype = ctypes.c_int32
    lib.gh_coo_rows_to_indptr.argtypes = [_i64p, ctypes.c_int64, ctypes.c_int64, _i64p]
    lib.gh_make_monotonic.restype = ctypes.c_int32
    lib.gh_make_monotonic.argtypes = [_i64p, ctypes.c_int64, _i64p, _i64p, ctypes.c_int64,
                                      _i64p]
    lib.gh_mst_linkage.restype = ctypes.c_int64
    lib.gh_mst_linkage.argtypes = [_i32p, _i32p, ctypes.POINTER(ctypes.c_float),
                                   ctypes.c_int64, ctypes.c_int64, _i64p,
                                   ctypes.POINTER(ctypes.c_double), _i64p]
    lib.gh_cut_tree.restype = ctypes.c_int64
    lib.gh_cut_tree.argtypes = [_i64p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _i32p]


def _bind_loader(lib: ctypes.CDLL) -> None:
    lib.rt_loader_open.restype = ctypes.c_void_p
    lib.rt_loader_open.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
    lib.rt_loader_acquire.restype = ctypes.c_int64
    lib.rt_loader_acquire.argtypes = [ctypes.c_void_p,
                                      ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    lib.rt_loader_release.restype = ctypes.c_int32
    lib.rt_loader_release.argtypes = [ctypes.c_void_p]
    lib.rt_loader_close.restype = None
    lib.rt_loader_close.argtypes = [ctypes.c_void_p]


_GRAPH = _Library(SOURCE, _bind)
_LOADER = _Library(LOADER_SOURCE, _bind_loader)


def _target() -> Path:
    return _GRAPH.target()


def build() -> Path:
    """Compile the graph library if it is missing; returns its path."""
    return _GRAPH.build()


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded graph library, building it on first use; None if it
    cannot be built or loaded (the reason in `load_error()`)."""
    return _GRAPH.get()


def loader_lib() -> Optional[ctypes.CDLL]:
    """The loaded ring-reader library, building it on first use; None if
    it cannot be built or loaded (the reason in `loader_error()`)."""
    return _LOADER.get()


def loader_error() -> Optional[str]:
    return _LOADER.error


def available() -> bool:
    return get_lib() is not None


def load_error() -> Optional[str]:
    return _GRAPH.error


def _p64(a: np.ndarray):
    return a.ctypes.data_as(_i64p)


def coo_rows_to_indptr(rows: np.ndarray, n_rows: int) -> Optional[np.ndarray]:
    """COO row ids (any order) -> CSR indptr (n_rows + 1,) int64; None
    when the library is unavailable or a row is out of range."""
    lib = get_lib()
    if lib is None:
        return None
    r = np.ascontiguousarray(rows, dtype=np.int64)
    indptr = np.empty(n_rows + 1, np.int64)
    if lib.gh_coo_rows_to_indptr(_p64(r), len(r), n_rows, _p64(indptr)) != 0:
        return None
    return indptr


def make_monotonic(labels: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """(dense ids int64, sorted unique values int64) of integer labels."""
    lib = get_lib()
    if lib is None:
        return None
    lab = np.ascontiguousarray(labels, dtype=np.int64)
    out = np.empty(len(lab), np.int64)
    uniq = np.empty(max(len(lab), 1), np.int64)
    nu = ctypes.c_int64(0)
    if lib.gh_make_monotonic(_p64(lab), len(lab), _p64(out), _p64(uniq), len(uniq),
                             ctypes.byref(nu)) != 0:
        return None
    return out, uniq[: nu.value].copy()


def mst_linkage(src: np.ndarray, dst: np.ndarray, w: np.ndarray, n: int):
    """Union-find dendrogram of weight-SORTED edges: (children (m, 2)
    int64, deltas (m,) float64, sizes (m,) int64), or None."""
    lib = get_lib()
    if lib is None or n <= 0:
        return None
    s = np.ascontiguousarray(src, dtype=np.int32)
    d = np.ascontiguousarray(dst, dtype=np.int32)
    ww = np.ascontiguousarray(w, dtype=np.float32)
    if not len(s) == len(d) == len(ww):
        return None
    children = np.empty((max(n - 1, 1), 2), np.int64)
    deltas = np.empty(max(n - 1, 1), np.float64)
    sizes = np.empty(max(n - 1, 1), np.int64)
    m = lib.gh_mst_linkage(s.ctypes.data_as(_i32p), d.ctypes.data_as(_i32p),
                           ww.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), len(s), n,
                           _p64(children.reshape(-1)),
                           deltas.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), _p64(sizes))
    if m < 0:
        return None
    return children[:m], deltas[:m], sizes[:m]


def cut_tree(children: np.ndarray, n: int, n_clusters: int) -> Optional[np.ndarray]:
    """Flat (n,) int32 labels from a children table, or None."""
    lib = get_lib()
    if lib is None or n <= 0:
        return None
    ch = np.ascontiguousarray(children, dtype=np.int64).reshape(-1, 2)
    labels = np.empty(n, np.int32)
    if lib.gh_cut_tree(_p64(ch.reshape(-1)), len(ch), n, int(n_clusters),
                       labels.ctypes.data_as(_i32p)) < 0:
        return None
    return labels
