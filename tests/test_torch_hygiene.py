"""PyTorch port hygiene: the port stands alone and never falls back to
the CPU behind the caller's back.

- No file of `raft_tpu_torch/`, nor `chip_smoke.py`, imports `jax` or
  anything of the JAX package (checked on the syntax tree, so an import
  inside a function counts too).
- Entry points default to the CUDA card; without one, a default or CUDA
  request raises rather than returning CPU tensors.
- A kernel wrapper given a tensor that is on neither the CPU nor a CUDA
  device raises: only a CPU tensor takes the plain version.
- The public call shapes are the JAX package's: every JAX parameter of a
  paired module's functions and methods is taken, its positional ones at
  JAX's positions, but for `STATED_DIFFERENCES`; the entry points that
  take JAX's `resources=` answer bit for bit as without it.
"""

import ast
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest

import torch

import raft_tpu_torch
from raft_tpu_torch.cluster import kmeans, kmeans_balanced
from raft_tpu_torch.core.config import resolve_device
from raft_tpu_torch.distance import fused_l2_nn, pairwise
from raft_tpu_torch.matrix.select_k import select_k
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_pq, ivf_rabitq, refine
from raft_tpu_torch.ops import _launch, fused_l2_argmin, fused_scan, pairwise_tiled, select_counting

_ROOT = Path(__file__).resolve().parent.parent
_FORBIDDEN = ("jax", "jaxlib", "raft_tpu")


def _port_files():
    files = sorted((_ROOT / "raft_tpu_torch").rglob("*.py"))
    files.append(_ROOT / "chip_smoke.py")
    return files


def _imported_roots(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_port_imports_neither_jax_nor_the_jax_package():
    files = _port_files()
    assert len(files) > 10 and all(f.exists() for f in files)
    bad = [(str(f.relative_to(_ROOT)), m) for f in files
           for m in _imported_roots(f) if m in _FORBIDDEN]
    assert not bad, bad


def test_resolve_device_defaults_to_cuda_and_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError):
        resolve_device("cuda")
    assert resolve_device("cpu") == torch.device("cpu")
    assert raft_tpu_torch.resolve_device is resolve_device


def test_entry_points_never_answer_a_cuda_request_on_the_cpu(monkeypatch, tmp_path):
    import raft_tpu_torch.integrity as integrity
    from raft_tpu_torch import sparse, spectral
    from raft_tpu_torch.cluster import single_linkage
    from raft_tpu_torch.core.serialize import deserialize_arrays
    from raft_tpu_torch.distance import masked_l2_nn
    from raft_tpu_torch.label import make_monotonic
    from raft_tpu_torch.neighbors import mutation
    from raft_tpu_torch.neighbors.refine import refine_host
    from raft_tpu_torch.random import make_blobs, rmat
    from raft_tpu_torch.solver import linear_assignment

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rng = np.random.default_rng(0)
    x = rng.standard_normal((300, 8)).astype(np.float32)
    cand = np.tile(np.arange(20, dtype=np.int32), (4, 1))
    # checkpoints written on the CPU: loading or resuming one without
    # device="cpu" asks for the card
    saved = {}
    for mod in (ivf_flat, ivf_pq, ivf_rabitq):
        params = (mod.IndexParams(n_lists=4, pq_dim=4) if mod is ivf_pq
                  else mod.IndexParams(n_lists=4))
        saved[mod] = str(tmp_path / f"{mod.__name__.rsplit('.', 1)[-1]}.ckpt")
        mod.save(saved[mod], mod.build(params, x, device="cpu"))
    root = str(tmp_path / "mut")
    mutation.Mutator(root, ivf_flat.load(saved[ivf_flat], device="cpu"), ckpt_every=1).delete([1])
    # a graph container given host (numpy) fields puts them on the card
    edges = (np.arange(299, dtype=np.int32), np.arange(1, 300, dtype=np.int32),
             np.ones(299, np.float32))
    calls = [
        lambda: brute_force.knn(x, x[:4], 5),
        lambda: brute_force.knn(x, x[:4], 5, engine="fused", device="cuda"),
        lambda: refine(x, x[:4], cand, 5, strategy="fused"),
        lambda: ivf_pq.build(ivf_pq.IndexParams(n_lists=4, pq_dim=4), x),
        lambda: ivf_pq.index_from_arrays({}, ivf_pq.IndexParams(n_lists=4)),
        lambda: brute_force.knn(x, x[:4], 5, metric="l1"),
        lambda: pairwise.pairwise_distance(x, x[:4], metric="canberra"),
        lambda: fused_l2_nn(x, x[:4]),
        lambda: select_k(x, 3, strategy="counting"),
        lambda: ivf_rabitq.build(ivf_rabitq.IndexParams(n_lists=4), x),
        lambda: ivf_rabitq.build(ivf_rabitq.IndexParams(n_lists=4), x, device="cuda"),
        lambda: ivf_rabitq.index_from_arrays({}, ivf_rabitq.IndexParams(n_lists=4)),
        lambda: ivf_flat.build(ivf_flat.IndexParams(n_lists=4), x),
        lambda: ivf_flat.index_from_arrays({}, ivf_flat.IndexParams(n_lists=4)),
        lambda: brute_force.knn(x, x[:4], 5, prefilter=np.ones(300, bool)),
        lambda: kmeans.fit(x, n_clusters=4),
        lambda: kmeans.predict(x, x[:4]),
        lambda: kmeans_balanced.fit_hierarchical(x, 100),
        lambda: ivf_flat.load(saved[ivf_flat]),
        lambda: ivf_pq.load(saved[ivf_pq]),
        lambda: ivf_rabitq.load(saved[ivf_rabitq], device="cuda"),
        lambda: mutation.Mutator(root, kind="ivf_flat"),
        lambda: deserialize_arrays(saved[ivf_pq]),
        lambda: integrity.restore(root),
        lambda: refine_host(x, x[:4], cand, 5),
        lambda: single_linkage(x, n_clusters=3),
        lambda: single_linkage(x, n_clusters=3, connectivity="pairwise", device="cuda"),
        lambda: spectral.partition(sparse.CooMatrix(*edges, (300, 300)), 2),
        lambda: sparse.neighbors.knn_graph(x, 5, device="cuda"),
        lambda: sparse.distance.pairwise_distance(sparse.dense_to_csr(x), sparse.dense_to_csr(x)),
        lambda: sparse.dense_to_csr(x, device="cuda"),
        lambda: masked_l2_nn(x, x, np.ones((300, 2), bool), np.zeros(300, np.int32)),
        lambda: masked_l2_nn(x, x, np.ones((300, 2), bool), np.zeros(300, np.int32),
                             device="cuda"),
        lambda: sparse.neighbors.knn_graph(x, 5),
        lambda: linear_assignment(x[:8, :8]),
        lambda: make_blobs(100, 4),
        lambda: rmat(4, 4, 100),
        lambda: make_monotonic(np.array([3, 1, 3])),
    ]
    # the rest of item 10: the ball cover, eps neighbourhoods, stats,
    # linalg, the matrix helpers, gram kernels, the RNG, the core surface
    from raft_tpu_torch import core, linalg, matrix, random as trandom, stats
    from raft_tpu_torch.distance import gram_matrix
    from raft_tpu_torch.neighbors import BatchLoadIterator, ball_cover, eps_neighbors

    calls += [
        lambda: ball_cover.build_index(x[:, :2], metric="haversine"),
        lambda: ball_cover.build_index(x, metric="sqeuclidean", device="cuda"),
        lambda: eps_neighbors(x, x[:4], 1.0),
        lambda: stats.mean(x),
        lambda: stats.silhouette_score(x, np.zeros(300, np.int32)),
        lambda: stats.adjusted_rand_index(np.zeros(300, np.int32), np.zeros(300, np.int32)),
        lambda: linalg.gemm(x, x.T),
        lambda: linalg.rsvd(x, 2),
        lambda: matrix.eye(3),
        lambda: matrix.argmax(x),
        lambda: gram_matrix(x, x[:4]),
        lambda: trandom.RngState(0),
        lambda: core.Resources().device,
        lambda: core.device_ndarray(x),
        lambda: core.make_device_matrix(2, 2),
        lambda: BatchLoadIterator(x, 100),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


def test_kernel_wrappers_refuse_devices_without_a_kernel():
    meta = torch.device("meta")
    x = torch.empty((4, 8), device=meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_scan.fused_topk(x, x, 2)
    lof = torch.zeros((2,), dtype=torch.int32, device=meta)
    q = torch.empty((2, 4, 8), device=meta)
    store = torch.empty((1, 128, 8), device=meta)
    base = torch.empty((1, 1, 128), device=meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_scan.fused_list_topk(lof, q, store, base, 2)


def test_new_kernel_wrappers_refuse_devices_without_a_kernel():
    meta = torch.device("meta")
    x = torch.empty((4, 8), device=meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        pairwise_tiled.pairwise_tiled(x, x, "l1")
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_l2_argmin.fused_l2_argmin(x, x)
    with pytest.raises(ValueError, match="cpu or cuda"):
        select_counting.counting_select_min(torch.empty((2, 128), device=meta), 3)


def test_bitplane_wrapper_refuses_devices_without_a_kernel():
    meta = torch.device("meta")
    lof = torch.zeros((2,), dtype=torch.int32, device=meta)
    planes = torch.empty((2, 4, 24), dtype=torch.int32, device=meta)
    codes_t = torch.empty((1, 3, 128), dtype=torch.int32, device=meta)
    rows = torch.empty((1, 3, 128), device=meta)
    base = torch.empty((1, 1, 128), device=meta)
    qmeta = torch.empty((2, 4, 4), device=meta)
    with pytest.raises(ValueError, match="cpu or cuda"):
        fused_scan.fused_bitplane_topk(lof, planes, codes_t, rows, base, qmeta, 2, rot_dim=96,
                                       bits=8)


def test_launch_counter_loses_no_count_across_threads():
    """The ranks of an in-process comms world launch from several threads
    at once: the counter's read-modify-write is locked."""
    import sys
    import threading

    fused_scan.reset_launch_counts()
    start = threading.Barrier(8)

    def bump():
        start.wait(timeout=30)
        for _ in range(5000):
            _launch._count_launch("counting_select_min")

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
    try:
        threads = [threading.Thread(target=bump) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert fused_scan.launch_counts()["counting_select_min"] == 8 * 5000
    fused_scan.reset_launch_counts()


def test_launch_counts_cover_every_kernel():
    names = {"fused_topk", "fused_list_topk", "fused_list_topk_int8", "pq_list_scan",
             "pairwise_tiled", "fused_l2_argmin", "counting_select_min", "fused_bitplane_topk"}
    assert set(_launch.launch_counts()) == names
    assert fused_scan.launch_counts is _launch.launch_counts
    assert fused_scan.reset_launch_counts is _launch.reset_launch_counts
    _launch._launches["pairwise_tiled"] += 1
    fused_scan.reset_launch_counts()
    assert set(fused_scan.launch_counts().values()) == {0}


_SUBPACKAGES = ("cluster", "core", "distance", "integrity", "matrix", "neighbors", "random",
                "sparse", "label", "spectral", "solver", "linalg", "stats", "spatial", "util",
                "io", "comms", "serve", "jobs")

#: top-level names of the JAX package still to come: none, since the
#: serving and jobs layers (ROADMAP items 12d-12e) are ported
_ITEM12_TOP_LEVEL = ()


def _defined_names(path: Path) -> list:
    """The public top-level functions, classes and assignments of a file,
    in their order."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.append(node.name)
        elif isinstance(node, ast.Assign):
            names.extend(t.id for t in node.targets if isinstance(t, ast.Name))
    return [n for n in names if not n.startswith("_")]


def _lazy_names(path: Path) -> list:
    """The names a module's PEP 562 `__getattr__` resolves (`if name ==
    "lanczos"`)."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.FunctionDef) and node.name == "__getattr__":
            for cmp in ast.walk(node):
                if isinstance(cmp, ast.Compare):
                    names += [c.value for c in cmp.comparators
                              if isinstance(c, ast.Constant) and isinstance(c.value, str)]
    return names


def _port_names(pkg: str) -> set:
    """The names the port's subpackage defines: its module files and
    subpackages, the public top-level functions, classes and assignments
    in them (its `__init__` included: `label`, `spectral` and `solver`
    keep their code there, as the JAX package does), and the names its
    `__init__` resolves lazily."""
    root = _ROOT / "raft_tpu_torch" / pkg
    names = {d.name for d in root.iterdir() if (d / "__init__.py").exists()}
    for path in root.glob("*.py"):
        if path.name != "__init__.py":
            names.add(path.stem)
        names.update(_defined_names(path))
    names.update(_lazy_names(root / "__init__.py"))
    return names


def _jax_public(jax_pkg) -> list:
    """The JAX package's `__all__`; for a package without one (`label`,
    `spectral`, `solver`), the public names its `__init__` defines."""
    if hasattr(jax_pkg, "__all__"):
        return list(jax_pkg.__all__)
    return _defined_names(Path(jax_pkg.__file__))


@pytest.mark.parametrize("pkg", _SUBPACKAGES)
def test_namespaces_export_the_ported_part_of_the_jax_all(pkg):
    import importlib
    import inspect

    jax_pkg = importlib.import_module(f"raft_tpu.{pkg}")
    port_pkg = importlib.import_module(f"raft_tpu_torch.{pkg}")
    want = [n for n in _jax_public(jax_pkg) if n in _port_names(pkg)]
    assert want, pkg
    assert port_pkg.__all__ == want, (pkg, port_pkg.__all__, want)
    for name in want:
        j, t = getattr(jax_pkg, name), getattr(port_pkg, name)
        assert inspect.ismodule(j) == inspect.ismodule(t), name
        assert inspect.isclass(j) == inspect.isclass(t), name
        assert callable(j) == callable(t), name
    namespace = {}
    exec(f"from raft_tpu_torch.{pkg} import *", namespace)  # no import cycle, every name bound
    assert set(want) <= set(namespace)


def test_top_level_exports_the_jax_all_but_the_distributed_layer():
    import raft_tpu

    want = [n for n in raft_tpu.__all__ if n not in _ITEM12_TOP_LEVEL]
    assert raft_tpu_torch.__all__ == want
    assert raft_tpu_torch.__version__ == raft_tpu.__version__
    for name in want:
        if name == "__version__":
            continue
        j, t = getattr(raft_tpu, name), getattr(raft_tpu_torch, name)
        assert type(j).__name__ == type(t).__name__, name
    assert raft_tpu_torch.ivf_rabitq_search is ivf_rabitq.search
    assert raft_tpu_torch.ivf_rabitq_build is ivf_rabitq.build
    assert raft_tpu_torch.stats is importlib.import_module("raft_tpu_torch.stats")
    assert raft_tpu_torch.resolve_device is resolve_device
    assert raft_tpu_torch.serve is importlib.import_module("raft_tpu_torch.serve")
    assert raft_tpu_torch.jobs is importlib.import_module("raft_tpu_torch.jobs")
    for name in _ITEM12_TOP_LEVEL:
        with pytest.raises(AttributeError):
            getattr(raft_tpu_torch, name)


#: names of the JAX comms layer still to come with the distributed IVF
#: drivers (ROADMAP item 12c): none, since the drivers are ported
_ITEM12C_COMMS = ()
_ITEM12C_MNMG = ()


def _import_from_names(path: Path) -> list:
    """The names a facade module imports, in order."""
    names = []
    for node in ast.parse(path.read_text()).body:
        if isinstance(node, ast.ImportFrom):
            names += [a.asname or a.name for a in node.names]
    return names


def test_comms_facades_reexport_the_jax_names_less_item_12c():
    """`raft_tpu_torch.comms.__all__` is the JAX `__all__` and `comms.mnmg`
    re-exports the JAX facade's names, in order, less the names of the
    distributed IVF drivers; each name resolves."""
    import raft_tpu.comms as jcomms

    import raft_tpu_torch.comms as tcomms
    from raft_tpu_torch.comms import mnmg

    assert tcomms.__all__ == [n for n in jcomms.__all__ if n not in _ITEM12C_COMMS]
    want = [n for n in _import_from_names(_ROOT / "raft_tpu" / "comms" / "mnmg.py")
            if n not in _ITEM12C_MNMG]
    assert _import_from_names(_ROOT / "raft_tpu_torch" / "comms" / "mnmg.py") == want
    assert all(hasattr(mnmg, n) for n in want)
    assert raft_tpu_torch.comms is tcomms
    assert raft_tpu_torch.RankHealth is tcomms.RankHealth
    assert raft_tpu_torch.DegradedSearchResult is tcomms.DegradedSearchResult


def test_obs_is_on_the_top_level_with_the_jax_all():
    """`raft_tpu_torch.obs` sits at the JAX position of the top level, has
    all ten modules of the JAX `obs` and its `__all__`, in its order."""
    import raft_tpu
    import raft_tpu.obs as jobs

    from raft_tpu_torch import obs

    assert raft_tpu_torch.obs is obs
    assert raft_tpu_torch.__all__.index("obs") == [
        n for n in raft_tpu.__all__ if n not in _ITEM12_TOP_LEVEL].index("obs")
    assert obs.__all__ == jobs.__all__
    mods = {p.stem for p in (_ROOT / "raft_tpu" / "obs").glob("*.py")}
    assert mods == {p.stem for p in (_ROOT / "raft_tpu_torch" / "obs").glob("*.py")}
    assert len(mods - {"__init__"}) == 10


def test_neighbors_refine_is_the_function():
    from raft_tpu_torch.neighbors import refine as port_refine
    from raft_tpu_torch.neighbors.refine import refine as module_refine

    assert port_refine is module_refine and callable(port_refine)
    from raft_tpu_torch.distance import distance as port_distance

    assert port_distance is pairwise.pairwise_distance


def test_new_modules_stand_alone():
    """The tuned table, adaptive probing, serialization, mutation, the
    fault hooks and the integrity modules import neither JAX nor the JAX
    package (checked above over every file); the first two read no
    device."""
    files = {str(f.relative_to(_ROOT)) for f in _port_files()}
    assert {"raft_tpu_torch/core/tuned.py", "raft_tpu_torch/neighbors/probe_budget.py",
            "raft_tpu_torch/core/serialize.py", "raft_tpu_torch/neighbors/mutation.py",
            "raft_tpu_torch/core/faults.py", "raft_tpu_torch/integrity/__init__.py",
            "raft_tpu_torch/integrity/digest.py", "raft_tpu_torch/integrity/scrub.py",
            "raft_tpu_torch/integrity/watchdog.py",
            "raft_tpu_torch/integrity/restore.py"} <= files
    # the graph path: every module of the JAX files it ports
    graph = {f"raft_tpu_torch/sparse/{m}.py" for m in (
        "__init__", "formats", "ops", "linalg", "solver", "neighbors", "distance", "hierarchy",
        "selection")}
    graph |= {f"raft_tpu_torch/{m}.py" for m in (
        "native/__init__", "label/__init__", "spectral/__init__", "solver/__init__",
        "cluster/single_linkage", "distance/masked_nn", "random/generators",
        "random/make_blobs")}
    assert graph <= files
    # the rest of item 10
    rest = {f"raft_tpu_torch/{m}.py" for m in (
        "neighbors/ann_types", "neighbors/epsilon_neighborhood", "neighbors/ball_cover",
        "neighbors/batch_loader", "spatial/__init__", "spatial/knn/__init__", "io/__init__",
        "stats/__init__", "stats/descriptive", "stats/metrics", "linalg/__init__", "linalg/blas",
        "linalg/elementwise", "linalg/reductions", "linalg/solvers", "matrix/__init__",
        "distance/kernels", "random/rng", "util/__init__", "core/operators", "core/resources",
        "core/device_ndarray", "core/mdarray", "core/interruptible", "core/logger",
        "core/tracing", "core/validation", "core/config")}
    assert rest <= files
    # the serving and jobs layers
    layers = {f"raft_tpu_torch/{m}.py" for m in (
        "serve/__init__", "serve/admission", "serve/metrics", "serve/batcher", "serve/engine",
        "jobs/__init__", "jobs/jobdir", "jobs/watchdog", "jobs/runner", "jobs/streaming",
        "core/threads")}
    assert layers <= files
    from raft_tpu_torch.core import tuned
    from raft_tpu_torch.neighbors import probe_budget

    assert tuned.path().endswith("raft_tpu_torch/tuned_defaults.json")
    assert not tuned.applies("cpu")
    mask, counts = probe_budget.probe_plan(
        torch.zeros((3, 4)), torch.eye(4), n_probes=2, min_probes=1, k=1,
        metric=probe_budget.DistanceType.L2Expanded, tau=1.0)
    assert mask.device.type == "cpu" and mask.all() and counts.tolist() == [2, 2, 2]


# ---------------------------------------------------------------------------
# the JAX package's call shapes
# ---------------------------------------------------------------------------

_INTERPRET = "Pallas interpret mode: no Hopper counterpart (a CPU tensor takes the plain version)"
_FAULT_KEY = ("the Pallas trace-time fault key: no Hopper counterpart (faults fire at run "
              "time, `fused_scan._maybe_corrupt`)")
_BLOCK = "a Pallas grid block size: no Hopper counterpart (the CUDA tiles are fixed in csrc/)"
_CHUNK = ("the TPU VMEM bytes of a grid step of `chunk` rows: no Hopper counterpart (a CUDA "
          "block's shared memory does not grow with the chunk)")
_ITEMSIZE = ("the TPU VMEM bytes of the store: no Hopper counterpart (the port's budget "
             "follows `q_int8`, the int8 kernel's stages)")

#: JAX parameters the port does not take, each with its reason; a JAX
#: positional call binds the rest at JAX's positions less these
STATED_DIFFERENCES = {
    "ops.fused_scan.fits_fused": {"bq": _BLOCK, "bn": _BLOCK},
    "ops.fused_scan.fits_fused_list": {"chunk": _CHUNK, "store_itemsize": _ITEMSIZE},
    "ops.fused_scan.fits_fused_bitplane": {"chunk": _CHUNK},
    "ops.fused_scan.fused_topk": {"bq": _BLOCK, "bn": _BLOCK, "interpret": _INTERPRET,
                                  "fault_key": _FAULT_KEY},
    "ops.fused_scan.fused_list_topk": {"interpret": _INTERPRET, "fault_key": _FAULT_KEY},
    "ops.fused_scan.fused_list_topk_int8": {"interpret": _INTERPRET, "fault_key": _FAULT_KEY},
    "ops.fused_scan.fused_bitplane_topk": {"interpret": _INTERPRET, "fault_key": _FAULT_KEY},
    "ops.pairwise_pallas.pairwise_tiled": {"bm": _BLOCK, "bn": _BLOCK, "interpret": _INTERPRET},
    "ops.pq_list_scan.pq_list_scan": {"interpret": _INTERPRET},
    "ops.select_counting.counting_select_min": {"interpret": _INTERPRET},
    "matrix.select_k.check_fused_list_request": {"store_itemsize": _ITEMSIZE},
    "matrix.select_k.list_scan_select_k": {"interpret": _INTERPRET, "fault_key": _FAULT_KEY},
    "matrix.select_k.bitplane_scan_select_k": {"interpret": _INTERPRET,
                                               "fault_key": _FAULT_KEY},
    "neighbors.ivf_pq.build_reconstruction": {
        "pad_to_lanes": "the store is always lane-padded (JAX's pad_to_lanes=True), the "
                        "list kernels' shape contract"},
    "neighbors.probe_invert.score_and_select": {
        "chunk_block": "a tuned TPU key the port does not register (listmajor_chunk_block): "
                       "one batched call scores a superblock"},
}

_POSITIONAL = (inspect.Parameter.POSITIONAL_ONLY, inspect.Parameter.POSITIONAL_OR_KEYWORD)


def _paired_modules():
    """(JAX module, port module) for every file of the JAX package with a
    counterpart in the port (`ops/pairwise_pallas` is `ops/pairwise_tiled`)."""
    def name(pkg, rel):
        return ".".join((pkg,) + rel.with_suffix("").parts).removesuffix(".__init__")

    for path in sorted((_ROOT / "raft_tpu").rglob("*.py")):
        rel = path.relative_to(_ROOT / "raft_tpu")
        port_rel = Path("ops/pairwise_tiled.py") if rel == Path("ops/pairwise_pallas.py") else rel
        if (_ROOT / "raft_tpu_torch" / port_rel).exists():
            yield (importlib.import_module(name("raft_tpu", rel)),
                   importlib.import_module(name("raft_tpu_torch", port_rel)))


def _public_callables(mod):
    """(qualified name, function) of the module's own public functions
    (jitted ones unwrapped) and of its classes' public methods and
    `__init__`."""
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != mod.__name__:
            continue
        if inspect.isclass(obj):
            for mname, meth in vars(obj).items():
                if isinstance(meth, (staticmethod, classmethod)):
                    meth = meth.__func__
                if (not mname.startswith("_") or mname == "__init__") and inspect.isfunction(meth):
                    yield f"{name}.{mname}", meth
        elif callable(obj) and inspect.isfunction(inspect.unwrap(obj)):
            yield name, inspect.unwrap(obj)


def _call_shape_faults(key, jax_fn, port_fn, stated):
    jp = inspect.signature(jax_fn).parameters
    tp = inspect.signature(port_fn).parameters
    faults = [f"{key}: lacks {n!r}" for n, p in jp.items()
              if n not in tp and n not in stated
              and p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)]
    faults += [f"{key}: states {n!r}, which it takes" for n in stated if n in tp]
    jpos = [n for n, p in jp.items() if p.kind in _POSITIONAL and n not in stated]
    tpos = [n for n, p in tp.items() if p.kind in _POSITIONAL]
    for i, n in enumerate(jpos):
        if n in tp and (n not in tpos or tpos.index(n) != i):
            faults.append(f"{key}: {n!r} is JAX's positional {i}, the port's "
                          f"{tpos.index(n) if n in tpos else 'keyword-only'}")
    return faults


def test_public_call_shapes_are_the_jax_packages():
    """Every public function and method of a ported module takes the JAX
    parameters, its positional ones at JAX's positions, but for the
    stated differences; the port's own parameters (`device=`, ...) come
    after them."""
    faults, seen = [], set()
    for jmod, tmod in _paired_modules():
        for qual, jfn in _public_callables(jmod):
            cls_name, _, meth = qual.rpartition(".")
            owner = getattr(tmod, cls_name, None) if cls_name else tmod
            port = None if owner is None else inspect.getattr_static(owner, meth, None)
            port = getattr(port, "__func__", port)  # a static or class method's function
            if port is None:
                continue  # name parity: test_namespaces_export_the_ported_part_of_the_jax_all
            key = f"{jmod.__name__.removeprefix('raft_tpu.')}.{qual}"
            seen.add(key)
            faults += _call_shape_faults(key, jfn, port, STATED_DIFFERENCES.get(key, {}))
    assert len(seen) > 500, len(seen)
    assert set(STATED_DIFFERENCES) <= seen, set(STATED_DIFFERENCES) - seen
    assert all(r for d in STATED_DIFFERENCES.values() for r in d.values())
    assert not faults, "\n".join(faults)


class _TrackingResources(raft_tpu_torch.Resources):
    """A CPU handle that records what the entry points `track` (on a card
    the real `track` records events; on the CPU it has nothing to wait
    for)."""

    def __init__(self):
        super().__init__(device="cpu")
        self.tracked = []

    def track(self, *tensors):
        self.tracked += tensors
        super().track(*tensors)


@pytest.fixture(scope="module")
def entry_data():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1500, 16)).astype(np.float32)
    q = (x[:12] + 0.1 * rng.standard_normal((12, 16))).astype(np.float32)
    cand = np.stack([rng.choice(1500, 40, replace=False) for _ in range(12)]).astype(np.int32)
    params = {ivf_flat: ivf_flat.IndexParams(n_lists=8, kmeans_n_iters=5),
              ivf_pq: ivf_pq.IndexParams(n_lists=8, pq_dim=8, kmeans_n_iters=5),
              ivf_rabitq: ivf_rabitq.IndexParams(n_lists=8, kmeans_n_iters=5)}
    index = {mod: mod.build(p, x, device="cpu") for mod, p in params.items()}
    centers = torch.tensor(x[:6])
    return x, q, cand, params, index, centers


def _entry_calls(d):
    """name -> (the JAX-style positional call given a handle, the same call
    without one)."""
    from raft_tpu_torch.distance import fused_l2_nn_argmin
    from raft_tpu_torch.matrix.select_k import scan_select_k
    from raft_tpu_torch.neighbors.quantizer import RabitqQuantizer
    from raft_tpu_torch.neighbors.refine import refine_host

    x, q, cand, params, index, centers = d
    dists = pairwise.pairwise_distance(q, x, metric="sqeuclidean", device="cpu")
    sp = {ivf_flat: ivf_flat.SearchParams(n_probes=4), ivf_pq: ivf_pq.SearchParams(n_probes=4),
          ivf_rabitq: ivf_rabitq.SearchParams(n_probes=4)}
    km = kmeans.KMeansParams(n_clusters=4, max_iter=5)
    cpu = {"device": "cpu"}
    calls = {
        "pairwise_distance": (lambda r: pairwise.pairwise_distance(x, q, None, "euclidean", 2.0, r),
                              lambda: pairwise.pairwise_distance(x, q, metric="euclidean", **cpu)),
        "distance": (lambda r: pairwise.distance(x, q, None, "sqeuclidean", 2.0, r),
                     lambda: pairwise.distance(x, q, metric="sqeuclidean", **cpu)),
        "fused_l2_nn": (lambda r: fused_l2_nn(q, x, False, r),
                        lambda: fused_l2_nn(q, x, **cpu)),
        "fused_l2_nn_argmin": (lambda r: fused_l2_nn_argmin(q, x, False, r),
                               lambda: fused_l2_nn_argmin(q, x, **cpu)),
        "select_k": (lambda r: select_k(dists, 5, True, None, r, None),
                     lambda: select_k(dists, 5, **cpu)),
        "scan_select_k": (lambda r: scan_select_k(q, x, 5, "sqeuclidean", None, None, r),
                          lambda: scan_select_k(q, x, 5, **cpu)),
        "knn": (lambda r: brute_force.knn(x, q, 5, "sqeuclidean", 2.0, r, "tiled"),
                lambda: brute_force.knn(x, q, 5, **cpu)),
        "refine": (lambda r: refine(x, q, cand, 5, "sqeuclidean", r, None),
                   lambda: refine(x, q, cand, 5, **cpu)),
        "refine_host": (lambda r: refine_host(x, q, cand, 5, "sqeuclidean", r, None),
                        lambda: refine_host(x, q, cand, 5, **cpu)),
        "rerank_candidates": (
            lambda r: RabitqQuantizer(32).rerank_candidates(x, q, torch.tensor(cand), 5,
                                                            "sqeuclidean", r),
            lambda: RabitqQuantizer(32).rerank_candidates(x, q, torch.tensor(cand), 5)),
        "kmeans.predict": (lambda r: kmeans.predict(x, centers, r),
                           lambda: kmeans.predict(x, centers, **cpu)),
        "kmeans.cluster_cost": (lambda r: kmeans.cluster_cost(x, centers, r),
                                lambda: kmeans.cluster_cost(x, centers, **cpu)),
        "kmeans.fit": (lambda r: kmeans.fit(x, km, None, None, r),
                       lambda: kmeans.fit(x, km, **cpu)),
        "kmeans.fit kwargs": (lambda r: kmeans.fit(x, None, None, None, r, n_clusters=4,
                                                   max_iter=5),
                              lambda: kmeans.fit(x, n_clusters=4, max_iter=5, **cpu)),
        "kmeans.fit_predict": (lambda r: kmeans.fit_predict(x, km, r),
                               lambda: kmeans.fit_predict(x, km, **cpu)),
        "kmeans_balanced.fit": (
            lambda r: kmeans_balanced.fit(x, 6, 5, "sqeuclidean", 0, None, r),
            lambda: kmeans_balanced.fit(x, 6, 5, **cpu)),
        "kmeans_balanced.predict": (
            lambda r: kmeans_balanced.predict(x, centers, "sqeuclidean", r),
            lambda: kmeans_balanced.predict(x, centers, **cpu)),
    }
    for mod in (ivf_flat, ivf_pq, ivf_rabitq):
        short = mod.__name__.rsplit(".", 1)[-1]
        extra = (x,) if mod is ivf_rabitq else ()  # RaBitQ's refine_dataset
        calls[f"{short}.build"] = (
            lambda r, m=mod: m.build(params[m], x, r, 0),
            lambda m=mod: m.build(params[m], x, seed=0, **cpu))
        calls[f"{short}.search"] = (
            lambda r, m=mod, e=extra: m.search(sp[m], index[m], q, 5, r, None, *e),
            lambda m=mod, e=extra: m.search(sp[m], index[m], q, 5,
                                            **({"refine_dataset": e[0]} if e else {})))
    return calls


_ENTRY_POINTS = ["pairwise_distance", "distance", "fused_l2_nn", "fused_l2_nn_argmin",
                 "select_k", "scan_select_k", "knn", "ivf_flat.build", "ivf_flat.search",
                 "ivf_pq.build", "ivf_pq.search", "ivf_rabitq.build", "ivf_rabitq.search",
                 "refine", "refine_host", "rerank_candidates", "kmeans.predict",
                 "kmeans.cluster_cost", "kmeans_balanced.fit", "kmeans_balanced.predict",
                 "kmeans.fit", "kmeans.fit kwargs", "kmeans.fit_predict"]


def _bit_equal(a, b):
    if isinstance(a, torch.Tensor):
        assert isinstance(b, torch.Tensor) and a.dtype == b.dtype and a.shape == b.shape
        if a.is_floating_point():
            a, b = a.view(torch.int32 if a.element_size() == 4 else torch.int16), \
                b.view(torch.int32 if b.element_size() == 4 else torch.int16)
        assert torch.equal(a, b)
    elif isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for u, v in zip(a, b):
            _bit_equal(u, v)
    elif hasattr(a, "__dict__"):
        fa, fb = vars(a), vars(b)
        assert fa.keys() == fb.keys()
        for name, u in fa.items():
            if isinstance(u, torch.Tensor):
                _bit_equal(u, fb[name])
    else:
        assert a == b


@pytest.mark.parametrize("name", _ENTRY_POINTS)
def test_entry_points_take_resources_at_the_jax_position(entry_data, name):
    """Called positionally as the JAX package is, with a CPU handle: the
    handle supplies the device, the answer is bit for bit the call
    without it, its tensors are tracked and `sync()` returns."""
    from raft_tpu_torch.core.resources import _outputs

    with_res, without = _entry_calls(entry_data)[name]
    res = _TrackingResources()
    out = with_res(res)
    _bit_equal(out, without())
    outs = _outputs(out)
    assert all(any(t is s for s in res.tracked) for t in outs), name
    assert outs or isinstance(out, float)
    res.sync()


def test_entry_point_list_is_the_twenty(entry_data):
    """The twenty, and `kmeans.fit` / `fit_predict`, whose handle must not
    fall into the `KMeansParams` keywords."""
    assert len(set(_ENTRY_POINTS) - {"kmeans.fit", "kmeans.fit kwargs",
                                     "kmeans.fit_predict"}) == 20
    assert set(_ENTRY_POINTS) == set(_entry_calls(entry_data))


def test_a_device_other_than_the_handles_raises():
    x = np.zeros((10, 4), np.float32)
    res = raft_tpu_torch.Resources(device="cpu")
    with pytest.raises(ValueError, match="differs from resources.device"):
        brute_force.knn(x, x, 2, resources=res, device="meta")
    with pytest.raises(ValueError, match="differs from resources.device"):
        kmeans.predict(x, x[:2], res, device="meta")
    d, i = brute_force.knn(x, x, 2, resources=res, device="cpu")
    assert d.device.type == "cpu" and i.dtype == torch.int32
