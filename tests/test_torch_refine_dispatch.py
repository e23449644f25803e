"""PyTorch port: refine's select dispatch (neighbors/refine
`_resolve_refine_strategy`) against the JAX package's.

Both packages resolve `strategy` the same way over a grid: None, "auto",
"two_phase" and "fused"; L2, inner product and L1; candidate blocks,
widths and k inside and outside both fused envelopes (the JAX VMEM one
and the port's shared-memory one agree at these points); and a tuned
`select_k_strategy` that is unset, "fused" or "two_phase". The port's
table governs the tensor's device through `core.tuned.applies`, JAX's
through `is_tpu_backend`: both are patched open. An explicit "fused"
outside the metrics or the envelope raises in both, and so does an
unknown name.

On the CPU the table never applies, so a default refine (and
`refine_host`) stays bit for bit the two-phase one whatever the table
says; where the table is made to apply, the default runs the fused
rerank, bit for bit `strategy="fused"`.
"""

import importlib

import numpy as np
import pytest

import torch

import raft_tpu.core.config as jconfig
from raft_tpu.distance.distance_types import resolve_metric as jax_resolve_metric
from raft_tpu.neighbors.refine import _resolve_refine_strategy as jax_resolve
from raft_tpu_torch.core import tuned
from raft_tpu_torch.distance.distance_types import resolve_metric
from raft_tpu_torch.neighbors.refine import _resolve_refine_strategy, refine, refine_host

# the module (the package namespace's `select_k` is the function)
jselect = importlib.import_module("raft_tpu.matrix.select_k")

# (n_candidates, dim, k): inside both envelopes, then past k's cap, past
# the block's width, and k = 0
GEOMETRIES = [(40, 16, 10), (200, 96, 250), (1000, 96, 64), (300, 16, 257),
              (128, 70000, 10), (64, 16, 0)]
TUNED = [None, "fused", "two_phase"]


def _outcome(fn):
    try:
        return fn()
    except ValueError:
        return ValueError


@pytest.mark.parametrize("tuned_value", TUNED)
@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product", "l1"])
@pytest.mark.parametrize("strategy", [None, "auto", "two_phase", "fused"])
def test_resolution_matches_jax(monkeypatch, strategy, metric, tuned_value):
    table = {} if tuned_value is None else {"select_k_strategy": tuned_value}
    monkeypatch.setattr(jselect, "_tuned_strategy", lambda: table.get("select_k_strategy"))
    monkeypatch.setattr(jconfig, "is_tpu_backend", lambda: True)
    monkeypatch.setattr(tuned, "_load", lambda: dict(table))
    monkeypatch.setattr(tuned, "applies", lambda device: True)
    seen = set()
    for nc, dim, k in GEOMETRIES:
        want = _outcome(lambda: jax_resolve(strategy, jax_resolve_metric(metric), nc, dim, k))
        got = _outcome(lambda: _resolve_refine_strategy(
            strategy, resolve_metric(metric), nc, dim, k, torch.device("cpu")))
        assert got == want, (nc, dim, k, got, want)
        seen.add(want)
    if strategy == "fused" and metric != "l1":
        assert seen == {"fused", ValueError}  # both sides of the envelope
    if strategy is None and tuned_value == "fused" and metric != "l1":
        assert seen == {"fused", "two_phase"}


def test_unknown_strategy_raises_in_both():
    m = resolve_metric("sqeuclidean")
    with pytest.raises(ValueError):
        jax_resolve("warpsort", jax_resolve_metric("sqeuclidean"), 40, 16, 10)
    with pytest.raises(ValueError, match="unknown"):
        _resolve_refine_strategy("warpsort", m, 40, 16, 10, torch.device("cpu"))


def _inputs(seed=0, n=2000, dim=24, nq=16, nc=40):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, dim)).astype(np.float32)
    q = (x[:nq] + 0.05 * rng.standard_normal((nq, dim))).astype(np.float32)
    cand = np.stack([rng.choice(n, nc, replace=False) for _ in range(nq)]).astype(np.int32)
    cand[:, -2:] = -1
    return x, q, cand


def _bits_equal(a, b):
    (av, ai), (bv, bi) = a, b
    assert torch.equal(ai, bi)
    assert torch.equal(av.view(torch.int32), bv.view(torch.int32))


@pytest.mark.parametrize("metric", ["sqeuclidean", "euclidean", "inner_product"])
def test_default_refine_on_the_cpu_is_two_phase(monkeypatch, metric):
    """The committed table names "fused"; on the CPU it does not apply, so
    the default is the two-phase rerank bit for bit, as before."""
    monkeypatch.setattr(tuned, "_load", lambda: {"select_k_strategy": "fused"})
    x, q, cand = _inputs()
    xt, qt, ct = torch.tensor(x), torch.tensor(q), torch.tensor(cand)
    two = refine(xt, qt, ct, 10, metric, strategy="two_phase", device="cpu")
    _bits_equal(refine(xt, qt, ct, 10, metric, device="cpu"), two)
    _bits_equal(refine(xt, qt, ct, 10, metric, strategy="auto", device="cpu"), two)
    host_two = refine_host(x, qt, cand, 10, metric, strategy="two_phase", device="cpu")
    _bits_equal(refine_host(x, qt, cand, 10, metric, device="cpu"), host_two)
    _bits_equal(host_two, two)


@pytest.mark.parametrize("metric", ["sqeuclidean", "inner_product"])
def test_default_refine_takes_the_fused_rerank_where_the_table_applies(monkeypatch, metric):
    monkeypatch.setattr(tuned, "_load", lambda: {"select_k_strategy": "fused"})
    monkeypatch.setattr(tuned, "applies", lambda device: True)
    x, q, cand = _inputs(seed=1)
    xt, qt, ct = torch.tensor(x), torch.tensor(q), torch.tensor(cand)
    fused = refine(xt, qt, ct, 10, metric, strategy="fused", device="cpu")
    _bits_equal(refine(xt, qt, ct, 10, metric, device="cpu"), fused)
    _bits_equal(refine_host(x, qt, cand, 10, metric, device="cpu"), fused)
    # L1 has no fused rerank: the default stays two-phase
    _bits_equal(refine(xt, qt, ct, 10, "l1", device="cpu"),
                refine(xt, qt, ct, 10, "l1", strategy="two_phase", device="cpu"))
