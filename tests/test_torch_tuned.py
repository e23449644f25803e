"""PyTorch port: the tuned table (`raft_tpu_torch.core.tuned`) and every
"auto" that reads it, against the JAX package's `raft_tpu.core.tuned`
and its readers.

- `get` / `get_choice` / `hints` / `reload` / `merge` on a temporary file,
  beside the JAX module on the same file: a missing file, corrupt JSON, a
  JSON list, `"hints": null` and out-of-set values degrade to the
  defaults; `merge` keeps other keys, merges hints key by key, heals a
  non-dict hints value and leaves no temporary file;
- the table governs CUDA tensors only: under a table that promotes every
  key, CPU calls resolve as without one (and no kernel wrapper runs);
- each resolver under one fake table, the JAX `tuned` table and
  `is_tpu_backend` patched, the port's `tuned.applies` patched: select_k's
  strategy, chunk threshold and counting promotion, the scan, int8-trim
  and bit-plane strategies, the pallas fold, IVF-PQ's score mode,
  distance dtype, chunk width and int8 trim, IVF-Flat's engine, RaBitQ's
  query bits and rerank depth. Where the JAX rule is written inline in
  its search (the distance dtype hint, the chunk width, the int8 trim),
  the test states those lines;
- every `tuned.get` / `tuned.get_choice` key of the port's sources is
  registered, and every registered key is read (the contract of the
  repo's raftlint `tuned-key-registry` rule, which scans `raft_tpu/`);
- the committed `raft_tpu_torch/tuned_defaults.json` holds registered
  keys with allowed values, measured on an NVIDIA card.
"""

import ast
import importlib
import json
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from raft_tpu.core import config as jconfig
from raft_tpu.core import tuned as jtuned
from raft_tpu.neighbors import ivf_flat as jfl
from raft_tpu.neighbors import ivf_pq as jpq
from raft_tpu.neighbors import ivf_rabitq as jrb
from raft_tpu.ops import pq_list_scan as jpls
from raft_tpu_torch.core import tuned
from raft_tpu_torch.neighbors import ivf_flat as tfl
from raft_tpu_torch.neighbors import ivf_pq as tpq
from raft_tpu_torch.neighbors import ivf_rabitq as trb
from raft_tpu_torch.ops import pq_list_scan as tpls

# the modules (each package's `matrix.select_k` is the function)
jsk = importlib.import_module("raft_tpu.matrix.select_k")
tsk = importlib.import_module("raft_tpu_torch.matrix.select_k")

_ROOT = Path(__file__).resolve().parent.parent

#: a table that promotes every reader
PROMOTE_ALL = {
    "select_k_auto_strategy": "counting",
    "select_k_strategy": "fused",
    "select_k_chunk_threshold": 4096,
    "select_k_strategy_int8": "fused_int8",
    "select_k_strategy_bitplane": "fused_bitplane",
    "pallas_fold": "packed",
    "pq_auto_engine": "recon8_list",
    "flat_auto_engine": "fused",
    "listmajor_chunk": 64,
    "rabitq_query_bits": 4,
    "rabitq_rerank_mult": 16,
    "hints": {"internal_distance_dtype": "bfloat16"},
    "adaptive_probe_policy": {"default_tau": 0.3, "targets": [[0.9, 0.2]]},
}

#: fake tables the resolvers are held to JAX under, each key through its
#: allowed values and some it must reject
TABLES = [
    {},
    PROMOTE_ALL,
    {"select_k_strategy": "counting", "select_k_chunk_threshold": 0},
    {"select_k_strategy": "topk", "select_k_chunk_threshold": 2.5e4},
    {"select_k_strategy": "two_phase", "select_k_chunk_threshold": True},
    {"select_k_strategy": "bogus", "select_k_auto_strategy": "nope",
     "select_k_chunk_threshold": "big"},
    {"select_k_strategy_int8": "approx", "select_k_strategy_bitplane": "xla",
     "pallas_fold": "fancy", "pq_auto_engine": "lut", "flat_auto_engine": "pallas",
     "listmajor_chunk": 256, "rabitq_query_bits": 9, "rabitq_rerank_mult": 65,
     "hints": None},
    {"pq_auto_engine": "recon8", "flat_auto_engine": "query", "listmajor_chunk": 32,
     "rabitq_query_bits": True, "rabitq_rerank_mult": True,
     "hints": {"internal_distance_dtype": "float64"}},
    {"pq_auto_engine": "bogus", "flat_auto_engine": "list", "listmajor_chunk": "64",
     "rabitq_query_bits": 8.0, "rabitq_rerank_mult": 4.0,
     "hints": {"internal_distance_dtype": "float16"}},
]


@pytest.fixture
def under(monkeypatch):
    """Put both packages under one fake table, their kernel gates open."""
    def apply(table):
        monkeypatch.setattr(jtuned, "_load", lambda: dict(table))
        monkeypatch.setattr(jconfig, "is_tpu_backend", lambda: True)
        monkeypatch.setattr(tuned, "_load", lambda: dict(table))
        monkeypatch.setattr(tuned, "applies", lambda device: True)
    return apply


# ---------------------------------------------------------------------------
# the module's API on a temporary file
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("content", [
    None, "{not json", "[1, 2]", '{"hints": null, "pallas_fold": "packed"}',
    '{"hints": {"internal_distance_dtype": "bfloat16"}, "listmajor_chunk": 64}',
    '{"flat_auto_engine": "warp", "rabitq_query_bits": 4}',
])
def test_file_api_matches_jax(tmp_path, monkeypatch, content):
    path = tmp_path / "tuned_defaults.json"
    if content is not None:
        path.write_text(content)
    monkeypatch.setattr(tuned, "_PATH", str(path))
    monkeypatch.setattr(jtuned, "_PATH", str(path))
    tuned.reload()
    jtuned.reload()
    try:
        assert tuned.path() == jtuned.path() == str(path)
        for key in tuned.known_keys():
            assert tuned.get(key) == jtuned.get(key)
            assert tuned.get(key, "d") == jtuned.get(key, "d")
        assert tuned.hints() == jtuned.hints()
        for key, allowed in (("flat_auto_engine", ("query", "list")),
                             ("pallas_fold", ("exact", "packed")),
                             ("listmajor_chunk", (32, 64, 128))):
            assert (tuned.get_choice(key, allowed, "dflt")
                    == jtuned.get_choice(key, allowed, "dflt"))
    finally:
        tuned.reload()
        jtuned.reload()


def test_merge_is_atomic_and_keeps_other_keys(tmp_path, monkeypatch):
    path = tmp_path / "tuned_defaults.json"
    path.write_text('{"pallas_fold": "exact", "hints": "broken"}')
    monkeypatch.setattr(tuned, "_PATH", str(path))
    tuned.reload()
    try:
        tuned.merge({"listmajor_chunk": 64, "hints": {"measured_on": "card"}})
        assert json.loads(path.read_text()) == {
            "pallas_fold": "exact", "listmajor_chunk": 64, "hints": {"measured_on": "card"}}
        tuned.merge({"hints": {"internal_distance_dtype": "bfloat16"}, "pallas_fold": "packed"})
        assert tuned.get("pallas_fold") == "packed"  # reloaded
        assert tuned.hints() == {"measured_on": "card", "internal_distance_dtype": "bfloat16"}
        assert sorted(os.listdir(tmp_path)) == ["tuned_defaults.json"]  # no temp file left
        path.write_text("{corrupt")
        tuned.merge({"pallas_fold": "exact"})  # a corrupt file is replaced, never kept
        assert json.loads(path.read_text()) == {"pallas_fold": "exact"}
    finally:
        tuned.reload()


def test_merge_removes_its_temp_file_on_failure(tmp_path, monkeypatch):
    path = tmp_path / "tuned_defaults.json"
    monkeypatch.setattr(tuned, "_PATH", str(path))
    try:
        with pytest.raises(TypeError):
            tuned.merge({"bad": object()})  # not JSON
        assert os.listdir(tmp_path) == []
    finally:
        tuned.reload()


def test_applies_to_cuda_only():
    assert tuned.applies("cuda") and tuned.applies(torch.device("cuda", 0))
    assert not tuned.applies("cpu") and not tuned.applies(None)
    assert not tuned.applies(torch.device("meta"))


def test_table_is_ignored_for_cpu_tensors(monkeypatch):
    monkeypatch.setattr(tuned, "_load", lambda: dict(PROMOTE_ALL))

    def boom(*a, **kw):
        raise AssertionError("a kernel wrapper ran for a CPU tensor")

    from raft_tpu_torch.ops import select_counting

    monkeypatch.setattr(select_counting, "counting_select_min", boom)
    cpu = torch.device("cpu")
    x = torch.tensor(np.random.default_rng(0).standard_normal((8, 4096)), dtype=torch.float32)
    assert not tsk._counting_promoted(x, 10)
    v, i = tsk._select_k_impl(x, 10, True)
    rv, ri = tsk._sorted_top(x, 10, False)
    assert torch.equal(v, rv) and torch.equal(i, ri)
    assert tsk._tuned_strategy(cpu) is None and tsk._tuned_chunk_threshold(cpu) is None
    assert tsk.resolve_scan_strategy(1000, 96, 10, device=cpu) == "two_phase"
    assert tsk.resolve_int8_trim_strategy(3840, 96, 40, device=cpu) is None
    assert tsk.resolve_bitplane_strategy(3840, 3, 8, 40, device=cpu) == "xla"
    assert tpls.fold_variant(cpu) == "exact"
    assert tpq.resolve_search(tpq.SearchParams(), 128, 20, 1024, cpu, k=40, L=3840,
                              rot=96) == ("lut", "approx", "float32")
    assert tpq.resolve_search(tpq.SearchParams(score_dtype="int8"), 4096, 8, 1024, cpu, k=40,
                              L=3840, rot=96) == ("recon8_list", "approx", "float32")
    assert tpq.resolve_listmajor_chunk(4096, 8, 1024, cpu) == 128
    assert tfl.resolve_auto_engine(4096, 8, 1024, pallas_ok=lambda: True, device=cpu) == "list"
    assert trb.resolve_query_bits(0, cpu) == 8 and trb.resolve_rerank_mult(0, cpu) == 4


# ---------------------------------------------------------------------------
# each resolver against the JAX package under the same table
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("table", range(len(TABLES)))
def test_select_k_resolvers_match_jax(under, table):
    under(TABLES[table])
    dev = torch.device("cuda")  # the device only reaches the patched gate
    assert tsk._tuned_strategy(dev) == jsk._tuned_strategy()
    assert tsk._tuned_chunk_threshold(dev) == jsk._tuned_chunk_threshold()
    for shape, k in (((4, 300), 10), ((4, 4096), 1), ((16, 32768), 40), ((2, 1024), 128)):
        for dt, jdt in ((torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16),
                        (torch.int8, jnp.int8), (torch.int32, jnp.int32),
                        (torch.float64, jnp.float32)):
            if dt == torch.float64:
                jv = None  # the JAX package runs with x64 off: f64 is the port's own
            else:
                jv = jnp.zeros(shape, jdt)
            t = torch.zeros(shape, dtype=dt)
            want = jsk._counting_promoted(jv, k) if jv is not None else False
            # torch tensors only reach the gate through `applies`, patched open
            assert tsk._counting_promoted(t, k) == want, (shape, k, dt)
    for n, d, k in ((1000, 96, 10), (1 << 20, 96, 256), (1000, 96, 257)):
        for strategy in (None, "auto", "fused", "two_phase"):
            for fused_ok in (True, False):
                assert (tsk.resolve_scan_strategy(n, d, k, strategy, fused_ok, device=dev)
                        == jsk.resolve_scan_strategy(n, d, k, strategy, fused_ok))
    for L, rot, k, kbuf in ((3840, 96, 40, None), (1024, 96, 10, 256), (300, 96, 10, None),
                            (3840, 96, 257, None)):
        for strategy in (None, "auto", "fused_int8"):
            assert (tsk.resolve_int8_trim_strategy(L, rot, k, kbuf, strategy, device=dev)
                    == jsk.resolve_int8_trim_strategy(L, rot, k, kbuf, strategy))
        for words, bits in ((3, 8), (1, 4)):
            for strategy in (None, "auto", "xla", "fused_bitplane"):
                assert (tsk.resolve_bitplane_strategy(L, words, bits, k, kbuf, strategy,
                                                      device=dev)
                        == jsk.resolve_bitplane_strategy(L, words, bits, k, kbuf, strategy))
    assert tpls.fold_variant(dev) == jpls.fold_variant()
    for bad in ("nope",):
        with pytest.raises(ValueError):
            tsk.resolve_int8_trim_strategy(3840, 96, 40, strategy=bad, device=dev)
        with pytest.raises(ValueError):
            jsk.resolve_int8_trim_strategy(3840, 96, 40, strategy=bad)


def test_counting_promotion_envelope_is_the_ports_own(under):
    """Past the kernel's one-pass k (128) the port keeps its sort where
    the JAX VMEM envelope (k <= 256) would promote; rows of more than two
    axes select as one (B, L) matrix (the list-major trims' scores)."""
    under({"select_k_auto_strategy": "counting"})
    assert jsk._counting_promoted(jnp.zeros((4, 1024), jnp.float32), 200)
    assert not tsk._counting_promoted(torch.zeros((4, 1024)), 200)
    assert tsk._counting_promoted(torch.zeros((3, 5, 1024)), 40)
    assert not tsk._counting_promoted(torch.zeros((1024,)), 4)


def test_counting_promotion_selects_as_the_sort_does(under):
    """Promoted on the CPU (gate patched open), `_select_k_impl` runs the
    counting kernel's plain version and returns the sort's answer, 3-d
    rows and select_min=False included."""
    under({"select_k_auto_strategy": "counting"})
    rng = np.random.default_rng(3)
    x = torch.tensor(np.round(rng.standard_normal((3, 7, 500)) * 4) / 4, dtype=torch.float32)
    for select_min in (True, False):
        for kk in (1, 10, 40):
            v, i = tsk._select_k_impl(x, kk, select_min)
            rv, ri = tsk._sorted_top(x, kk, not select_min)
            assert torch.equal(v, rv) and torch.equal(i, ri)


@pytest.mark.parametrize("table", range(len(TABLES)))
def test_index_resolvers_match_jax(under, table):
    under(TABLES[table])
    dev = torch.device("cuda")
    for nq, n_probes, n_lists in ((4096, 8, 1024), (128, 20, 1024), (4096, 64, 1024),
                                  (8, 4, 64), (10000, 48, 10000)):
        for score_mode in ("auto", "lut", "recon8"):
            for trim in ("auto", "approx", "fused"):
                for dtype in ("bf16", "int8"):
                    kw = dict(n_probes=n_probes, score_mode=score_mode, trim_engine=trim,
                              score_dtype=dtype)
                    want = jpq._resolve_score_mode(jpq.SearchParams(**kw), nq, n_probes,
                                                   n_lists)
                    assert tpq._resolve_score_mode(tpq.SearchParams(**kw), nq, n_probes,
                                                   n_lists, dev) == want
        # the chunk width (raft_tpu/neighbors/ivf_pq.py:1495-1500)
        want = 128
        if nq * n_probes / max(1, n_lists) <= jpq._LOW_DUP_CHUNK_BOUND:
            t_chunk = jtuned.get("listmajor_chunk", 128)
            if t_chunk in (32, 64, 128):
                want = int(t_chunk)
        assert tpq.resolve_listmajor_chunk(nq, n_probes, n_lists, dev) == want
        for pallas_ok in (None, lambda: True, lambda: False):
            assert (tfl.resolve_auto_engine(nq, n_probes, n_lists, pallas_ok, device=dev)
                    == jfl.resolve_auto_engine(nq, n_probes, n_lists, pallas_ok))
    # the distance dtype hint (raft_tpu/neighbors/ivf_pq.py:1307-1316, on a TPU)
    for idd in ("auto", "float32", "bfloat16"):
        want = idd
        if idd == "auto":
            want = "float32"
            hinted = jtuned.hints().get("internal_distance_dtype")
            if hinted in ("float32", "float16", "bfloat16"):
                want = hinted
        got = tpq.resolve_search(tpq.SearchParams(internal_distance_dtype=idd), 4096, 8, 1024,
                                 dev)[2]
        assert got == want
    # the int8 trim (raft_tpu/neighbors/ivf_pq.py:1336-1348)
    for k, L, kbuf in ((10, 3840, None), (40, 3840, 256), (257, 3840, None), (40, 300, None)):
        for dtype in ("bf16", "int8"):
            want = "approx"
            if dtype == "int8" and 0 < k <= 256:
                from raft_tpu.ops.fused_scan import fused_kbuf

                kb = max(fused_kbuf(k), kbuf or 0)
                if jsk.resolve_int8_trim_strategy(L, 96, k, kbuf=kb) == "fused_int8":
                    want = "fused"
            got = tpq.resolve_search(tpq.SearchParams(score_dtype=dtype), 4096, 8, 1024, dev,
                                     k=k, L=L, rot=96, kbuf=kbuf)[1]
            assert got == want, (k, L, kbuf, dtype)
    for bits in (0, 1, 8):
        assert trb.resolve_query_bits(bits, dev) == jrb.resolve_query_bits(bits)
    for mult in (0, 1, 25):
        assert trb.resolve_rerank_mult(mult, dev) == jrb.resolve_rerank_mult(mult)
    with pytest.raises(ValueError):
        trb.resolve_query_bits(9, dev)


# ---------------------------------------------------------------------------
# the registry and the committed table
# ---------------------------------------------------------------------------


def _tuned_reads():
    """(keys read by literal or *_KEY constant, whether hints() is read)
    across the port's sources."""
    consts = {n: getattr(tuned, n) for n in dir(tuned) if n.endswith("_KEY")}
    keys, hints_read = set(), False
    for path in sorted((_ROOT / "raft_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
            if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)):
                continue
            if getattr(node.func.value, "id", None) != "tuned":
                continue
            if node.func.attr == "hints":
                hints_read = True
            elif node.func.attr in ("get", "get_choice") and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Constant):
                    keys.add(arg.value)
                elif isinstance(arg, ast.Name):
                    assert arg.id in consts, f"{path}: tuned key from unknown name {arg.id}"
                    keys.add(consts[arg.id])
                else:
                    raise AssertionError(f"{path}: tuned key is not a literal or a *_KEY")
    return keys, hints_read


def test_every_read_key_is_registered_and_every_registered_key_is_read():
    keys, hints_read = _tuned_reads()
    assert keys <= set(tuned.TUNED_KEYS), keys - set(tuned.TUNED_KEYS)
    assert set(tuned.TUNED_KEYS) - {"hints"} <= keys, set(tuned.TUNED_KEYS) - keys
    assert hints_read
    consts = {getattr(tuned, n) for n in dir(tuned) if n.endswith("_KEY")}
    assert consts <= set(tuned.TUNED_KEYS)
    # the JAX registry's shape and spellings, for the keys both have
    for key, spec in tuned.TUNED_KEYS.items():
        assert key in jtuned.TUNED_KEYS
        assert set(spec) == {"kind", "choices", "bench"}
        assert spec["kind"] == jtuned.TUNED_KEYS[key]["kind"]
        assert spec["choices"] == jtuned.TUNED_KEYS[key]["choices"]


def test_committed_table_holds_registered_values_measured_on_an_nvidia_card():
    with open(tuned.path()) as f:
        table = json.load(f)
    assert isinstance(table, dict)
    for key, v in table.items():
        spec = tuned.TUNED_KEYS[key]
        if spec["choices"] is not None:
            assert v in spec["choices"], (key, v)
        elif spec["kind"] == "int":
            assert isinstance(v, int) and not isinstance(v, bool), (key, v)
        elif spec["kind"] in ("dict", "hints"):
            assert isinstance(v, dict), (key, v)
    if "listmajor_chunk" in table:
        assert table["listmajor_chunk"] in tpq._LISTMAJOR_CHUNKS
    if "rabitq_query_bits" in table:
        assert 1 <= table["rabitq_query_bits"] <= 8
    if "rabitq_rerank_mult" in table:
        assert 1 <= table["rabitq_rerank_mult"] <= 64
    if "adaptive_probe_policy" in table:
        policy = table["adaptive_probe_policy"]
        assert 0.0 < policy["default_tau"] <= 1.0
        assert all(0.0 < t <= 1.0 and 0.0 < tau <= 1.0 for t, tau in policy["targets"])
        # a calibration that read one recall at every tau tells no tau from another
        assert len({t for t, _ in policy["targets"]}) >= 2, policy
    hints = table.get("hints", {})
    assert "internal_distance_dtype" not in hints or hints["internal_distance_dtype"] in (
        "float32", "float16", "bfloat16")
    assert "NVIDIA" in hints.get("measured_on", ""), hints
