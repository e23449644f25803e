"""Measured tuned defaults (counterpart of raft_tpu/core/tuned.py).

`raft_tpu_torch/tuned_defaults.json` holds the winners of the A/B runs
that `chip_smoke.py` makes on the card (`python3 chip_smoke.py --apply`
merges them in), and every "auto" choice of the port reads it here.
Explicit engines and parameters are never overridden: only an "auto"
reads a tuned key.

Where the table applies: the kernels' home is the CUDA card, so the
table is read for CUDA tensors only (`applies`, the one gate; the JAX
package gates its kernel promotions on a TPU backend the same way). On
the CPU every "auto" resolves as the JAX package does without a tuned
value. A missing or corrupt file, or a value outside a key's allowed
set, degrades to that untuned resolution; nothing here raises.

The table is the port's own: no value measured on or for a TPU is in it.
"""

from __future__ import annotations

import functools
import json
import os
import tempfile
from typing import Any

import torch

_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "tuned_defaults.json",
)

#: Every tuned key the port reads: key -> {"kind", "choices", "bench"}
#: (the JAX registry's shape). Only keys whose reader is ported are
#: registered; `tests/test_torch_tuned.py` holds every `get` /
#: `get_choice` literal of the package to this dict and every key here
#: to a reader. "bench" names the writer of the key's measured value;
#: None for the comms keys, which no run on one card can measure (an
#: in-process world moves no bytes over a wire), so the table holds no
#: value for them and their readers keep the JAX package's defaults.
TUNED_KEYS = {
    "adaptive_probe_policy": {
        "kind": "dict", "choices": None, "bench": "chip_smoke.py"},
    "comms_quant_block": {
        "kind": "choice", "choices": (16, 32, 64, 128), "bench": None},
    "comms_quant_mode": {
        "kind": "choice", "choices": ("off", "int8", "bf16"), "bench": None},
    "flat_auto_engine": {
        "kind": "choice", "choices": ("query", "list", "pallas", "fused"),
        "bench": "chip_smoke.py"},
    "grouped_reduce_crossover": {
        "kind": "float", "choices": None, "bench": None},
    "grouped_reduce_schedule": {
        "kind": "choice", "choices": ("ring", "planes"), "bench": None},
    "hints": {
        "kind": "hints", "choices": None, "bench": None},
    "invert_impl": {
        "kind": "choice", "choices": ("sort", "count"), "bench": "chip_smoke.py"},
    "listmajor_chunk": {
        "kind": "int", "choices": None, "bench": "chip_smoke.py"},
    "listmajor_qs_impl": {
        "kind": "choice", "choices": ("gather", "onehot_bf16", "onehot_f32h"),
        "bench": "chip_smoke.py"},
    "listmajor_qs_impl_flat": {
        "kind": "choice", "choices": ("gather", "onehot_bf16", "onehot_f32h"),
        "bench": "chip_smoke.py"},
    "mnmg_query_sharded_min_nq": {
        "kind": "int", "choices": None, "bench": None},
    "mnmg_query_sharded_min_nq_per_k": {
        "kind": "float", "choices": None, "bench": None},
    "mnmg_replicated_merge_schedule": {
        "kind": "choice", "choices": ("tournament", "allgather"), "bench": None},
    "pallas_fold": {
        "kind": "choice", "choices": ("exact", "packed"), "bench": "chip_smoke.py"},
    "pq_auto_engine": {
        "kind": "choice", "choices": ("lut", "recon8", "recon8_list"),
        "bench": "chip_smoke.py"},
    "rabitq_query_bits": {
        "kind": "int", "choices": None, "bench": "chip_smoke.py"},
    "rabitq_rerank_mult": {
        "kind": "int", "choices": None, "bench": "chip_smoke.py"},
    "select_k_auto_strategy": {
        "kind": "choice", "choices": ("counting",), "bench": "chip_smoke.py"},
    "select_k_chunk_threshold": {
        "kind": "int", "choices": None, "bench": "chip_smoke.py"},
    "select_k_strategy": {
        "kind": "choice", "choices": ("topk", "two_phase", "counting", "fused"),
        "bench": "chip_smoke.py"},
    "select_k_strategy_bitplane": {
        "kind": "choice", "choices": ("fused_bitplane", "xla"), "bench": "chip_smoke.py"},
    "select_k_strategy_int8": {
        "kind": "choice", "choices": ("fused_int8",), "bench": "chip_smoke.py"},
}

#: the one spelling of each key constant the dispatch modules import
INT8_SCAN_KEY = "select_k_strategy_int8"
BITPLANE_SCAN_KEY = "select_k_strategy_bitplane"
POLICY_KEY = "adaptive_probe_policy"


def known_keys() -> tuple:
    """Sorted registered key names."""
    return tuple(sorted(TUNED_KEYS))


def applies(device) -> bool:
    """Whether the table governs work on `device`: CUDA tensors only.
    The one gate every reader goes through (tests monkeypatch it)."""
    return device is not None and torch.device(device).type == "cuda"


@functools.lru_cache(maxsize=1)
def _load() -> dict:
    try:
        with open(_PATH) as f:
            d = json.load(f)
        return d if isinstance(d, dict) else {}
    except (OSError, ValueError):
        return {}


def get(key: str, default: Any = None) -> Any:
    """The tuned value of `key`, or `default` where the table has none."""
    return _load().get(key, default)


def get_choice(key: str, allowed, default):
    """`get(key, default)` when the value is in `allowed`, else `default`."""
    v = get(key, default)
    return v if v in allowed else default


def hints() -> dict:
    """The free-form "hints" sub-dict; {} when the file, the key or a
    dict value is missing."""
    h = get("hints")
    return h if isinstance(h, dict) else {}


def path() -> str:
    return _PATH


def reload() -> None:
    """Drop the cached table (after `merge`, or in tests)."""
    _load.cache_clear()


def merge(updates: dict) -> None:
    """Merge keys into the table file (other keys stay; "hints" merges
    key by key) and reload. The write goes to a temporary file in the
    same directory, renamed over the table, so a crash never leaves a
    truncated file behind."""
    try:
        with open(_PATH) as f:
            record = json.load(f)
        if not isinstance(record, dict):
            record = {}
    except (OSError, ValueError):
        record = {}
    for k, v in updates.items():
        if k == "hints" and isinstance(v, dict):
            if not isinstance(record.get("hints"), dict):
                record["hints"] = {}
            record["hints"].update(v)
        else:
            record[k] = v
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(_PATH), prefix=".tuned_defaults.",
                               suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(record, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, _PATH)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    reload()
