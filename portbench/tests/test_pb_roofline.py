"""Each roofline count against a hand count at the configurations' own
parameters: from the parameters and shapes alone."""

import json
import math
from pathlib import Path

import pytest

from portbench.roofline import PEAKS, ivf_flat_search, ivf_pq_build, ivf_pq_search, lists_touched

CONFIGS = Path(__file__).resolve().parent.parent / "configs"


def _cfg(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


def test_peaks_are_the_published_h100_sxm_figures():
    assert PEAKS["hbm_bytes_per_s"] == 3.35e12
    assert PEAKS["ops_per_s"] == {"fp8": 1.979e15, "int8": 1.979e15, "bf16": 9.89e14,
                                  "tf32": 4.95e14, "f32": 6.7e13}


def test_ivf_pq_search_hand_count():
    cfg = _cfg("deep10m-ivfpq")
    p = cfg["search"]["n_probes"]
    w = ivf_pq_search.work(cfg, 1000)
    # 1000 queries: coarse 2*1000*4096*96 and rotation 2*1000*96*96 at TF32;
    # 1000 * 10M * p / 4096 scored rows of 96 int8 products; 40 reranked rows
    assert w["ops"]["tf32"] == 2 * 1000 * 4096 * 96 + 2 * 1000 * 96 * 96
    assert w["ops"]["int8"] == pytest.approx(2 * 1000 * 1e7 * p / 4096 * 96)
    assert w["ops"]["bf16"] == 2 * 1000 * 40 * 96
    touched = 4096 * (1 - (1 - p / 4096) ** 1000)
    hand_bytes = (4 * 1000 * 96 + 4 * 96 * 96 + 4 * 4096 * 96 + 4 * 256 * 96
                  + touched * (1e7 / 4096) * 48 + 1000 * 40 * (4 + 2 * 96) + 1000 * 10 * 8)
    assert w["bytes"] == pytest.approx(hand_bytes)
    ops_s = (w["ops"]["tf32"] / 4.95e14 + w["ops"]["int8"] / 1.979e15
             + w["ops"]["bf16"] / 9.89e14)
    assert w["seconds"] == pytest.approx(max(ops_s, hand_bytes / 3.35e12))
    assert w["binds"] == "bytes"


def test_ivf_flat_search_hand_count():
    cfg = _cfg("sift1m-ivfflat")
    p = cfg["search"]["n_probes"]
    w = ivf_flat_search.work(cfg, 10000)
    assert w["ops"]["tf32"] == 2 * 10000 * 1024 * 128
    assert w["ops"]["bf16"] == pytest.approx(2 * 10000 * (1e6 * p / 1024) * 128)
    touched = 1024 * (1 - (1 - p / 1024) ** 10000)
    assert w["bytes"] == pytest.approx(4 * 10000 * 128 + 4 * 1024 * 128
                                       + touched * (1e6 / 1024) * 128 * 2 + 10000 * 10 * 8)
    assert w["seconds"] == pytest.approx(max(w["ops"]["tf32"] / 4.95e14
                                             + w["ops"]["bf16"] / 9.89e14,
                                             w["bytes"] / 3.35e12))


def test_ivf_pq_build_hand_count():
    w = ivf_pq_build.work(_cfg("deep10m-ivfpq"))
    n_train = 5_000_000          # half of 10M rows
    centres = 64 + 64            # sqrt(4096) mesoclusters, 4096 / 64 fine ones
    hand = (2 * 1e7 * 96 * 96 + 20 * 2 * n_train * 96 * centres
            + 2 * 1e7 * 4096 * 96 + 2 * 1e7 * 96 * 256)
    assert w["ops"]["tf32"] == pytest.approx(hand)
    assert w["bytes"] == pytest.approx(4 * 1e7 * 96 + 1e7 * 48 + 4 * 1e7)
    assert w["seconds"] == pytest.approx(hand / 4.95e14)
    assert w["binds"] == "ops"


def test_counts_read_no_implementation_detail():
    """The same parameters give the same count whatever else the
    configuration file says (engine, precision, strategy names)."""
    cfg = _cfg("sift1m-ivfflat")
    a = ivf_flat_search.work(cfg, 10000)
    cfg["search"]["engine"] = "query"
    cfg["precision"] = "anything"
    assert ivf_flat_search.work(cfg, 10000) == a


def test_lists_touched_limits():
    assert lists_touched(4096, 32, 1) == pytest.approx(32)
    assert lists_touched(1024, 32, 10000) == pytest.approx(1024)
    assert math.isclose(lists_touched(100, 100, 5), 100)
