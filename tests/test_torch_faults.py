"""PyTorch port: fault injection (core/faults) against the JAX package, and
the chaos drills of the port's fault sites.

- The plan's bookkeeping equals the JAX plan's: `site_seed`, `matching`,
  flaky fire counts, `killed_ranks` and `trace_key`, for the same faults
  and seed.
- The host draws are the JAX draws: `corrupt_host` masks (several draws
  a site, and again after `reset()`) and `corrupt_file` offsets and runs
  flip the same bytes of two copies of one file.
- `fault_point`: slow_rank sleeps, flaky_bootstrap raises `count` times
  then passes, rank scoping; `stall_point` stalls `count` visits.
- `corrupt_in_trace`: no NaN at fraction 0, about half at 0.5, every cell
  at 1, nothing off the fault's rank, a replayed draw identical;
  `drop_contribution` writes the identity on the faulted rank only.
- With no plan installed (and with a plan for another site) every hook
  returns its input object itself.
- `crash_point` SIGKILLs a child process (`python -c`) on the count-th
  visit.
- `FAULT_SITES` is a subset of the JAX registry with equal descriptions,
  and every registered site has a live hook in the port's source; the
  eighth, `batch_loader.load`, sits in `neighbors/batch_loader`.
- Chaos drills (the JAX drills of tests/test_resilience.py on the port):
  `fused.scan.scores` NaNs every value of brute_force.knn(engine="fused")
  and of IVF-Flat's fused search, then bit for bit the clean results once
  cleared; `ivf.probe_budget` shrinks every budget to min_probes
  (full-shape valid results that differ), cleared bit for bit;
  `ivf_rabitq.build.encode` slow (results untouched) and flaky (raises,
  then the retry builds the same tables); `mutation.tombstone` and
  `mutation.rebalance` raise before any state changes; a
  `mutation.log.commit` kill in a child process resumes bit for bit like a
  crash-free run, at both SIGKILL windows.
"""

import ast
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

import torch

from raft_tpu.core import faults as jf
from raft_tpu_torch.core import faults as tf
from raft_tpu_torch.neighbors import brute_force, ivf_flat, ivf_rabitq, mutation
from raft_tpu_torch.neighbors import probe_budget

SEED = 1234
_ROOT = Path(__file__).resolve().parent.parent

PLANS = {
    "mixed": [dict(kind="flaky_bootstrap", site="mutation.*", count=2),
              dict(kind="kill_rank", site="resilience.barrier", rank=2),
              dict(kind="kill_rank", rank=0),
              dict(kind="corrupt_shard", site="fused.scan.scores", fraction=0.25),
              dict(kind="slow_rank", site="ivf_rabitq.build.encode", latency_s=0.01)],
    "ranks": [dict(kind="kill_rank", site="mutation.log.commit", rank=r, count=r + 1)
              for r in (3, 1, 1)],
}


def _plans(name, seed=SEED):
    faults = PLANS[name]
    return (jf.FaultPlan([jf.Fault(**f) for f in faults], seed=seed),
            tf.FaultPlan([tf.Fault(**f) for f in faults], seed=seed))


@pytest.mark.parametrize("name", sorted(PLANS))
@pytest.mark.parametrize("seed", [0, SEED])
def test_plan_bookkeeping_matches_jax(name, seed):
    jp, tp = _plans(name, seed)
    assert tp.trace_key() == jp.trace_key()
    for site in ("mutation.tombstone", "resilience.barrier", "fused.scan.scores",
                 "ivf_rabitq.build.encode", "mutation.log.commit", "*"):
        assert tp.site_seed(site) == jp.site_seed(site), site
        assert tp.killed_ranks(site) == jp.killed_ranks(site), site
        for kind in tf.KINDS:
            assert ([f.key() for f in tp.matching(site, kind)]
                    == [f.key() for f in jp.matching(site, kind)]), (site, kind)
    # flaky arming counts the same visits
    for f_j, f_t in zip(jp.faults, tp.faults):
        for _ in range(3):
            assert tp._arm("mutation.tombstone", f_t) == jp._arm("mutation.tombstone", f_j)
        assert tp.fire_count("mutation.tombstone", f_t) == jp.fire_count("mutation.tombstone",
                                                                         f_j)
    tp.reset()
    assert all(tp.fire_count("mutation.tombstone", f) == 0 for f in tp.faults)
    with tp.install():
        assert tf.active_plan() is tp and tf.trace_key() == jp.trace_key()
    assert tf.active_plan() is None and tf.trace_key() is None


def test_fault_validation_matches_jax():
    for kw in (dict(kind="meteor"), dict(kind="corrupt_shard", fraction=1.5)):
        with pytest.raises(ValueError):
            jf.Fault(**kw)
        with pytest.raises(ValueError):
            tf.Fault(**kw)


def _host_plans(fraction, rank=-1):
    f = dict(kind="corrupt_shard", site="batch_loader.load", fraction=fraction, rank=rank)
    return (jf.FaultPlan([jf.Fault(**f), jf.Fault(**{**f, "fraction": fraction / 2})],
                         seed=SEED),
            tf.FaultPlan([tf.Fault(**f), tf.Fault(**{**f, "fraction": fraction / 2})],
                         seed=SEED))


@pytest.mark.parametrize("fraction", [0.0, 0.1, 0.5, 1.0])
def test_corrupt_host_masks_match_jax(fraction):
    block = np.random.default_rng(3).standard_normal((37, 11)).astype(np.float32)
    jp, tp = _host_plans(fraction)
    for plan_pass in range(2):
        with jp.install():
            jout = [jf.corrupt_host("batch_loader.load", block) for _ in range(3)]
        with tp.install():
            tout = [tf.corrupt_host("batch_loader.load", block) for _ in range(3)]
        for j, t in zip(jout, tout):
            np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
            assert (t is block) == (j is block)
        jp.reset()
        tp.reset()
    ints = np.arange(12, dtype=np.int32)
    with tp.install():
        assert tf.corrupt_host("batch_loader.load", ints) is ints  # no NaN to plant


def test_corrupt_host_rank_scoping_matches_jax():
    block = np.ones((8, 8), np.float32)
    jp, tp = _host_plans(1.0, rank=1)
    with jp.install(), tp.install():
        for rank in (None, 0, 1):
            j = jf.corrupt_host("batch_loader.load", block, rank=rank)
            t = tf.corrupt_host("batch_loader.load", block, rank=rank)
            np.testing.assert_array_equal(np.isnan(t), np.isnan(j))


@pytest.mark.parametrize("fraction,start,end", [(0.01, 0, None), (0.2, 100, None),
                                                (1.0, 64, 512), (0.5, 1000, 1200)])
def test_corrupt_file_offsets_match_jax(tmp_path, fraction, start, end):
    payload = np.random.default_rng(5).integers(0, 256, 4096, dtype=np.uint8).tobytes()
    jpath, tpath = tmp_path / "j.bin", tmp_path / "t.bin"
    jpath.write_bytes(payload)
    tpath.write_bytes(payload)
    f = dict(kind="corrupt_shard", site="ckpt.corrupt_file", fraction=fraction)
    jp = jf.FaultPlan([jf.Fault(**f)], seed=SEED)
    tp = tf.FaultPlan([tf.Fault(**f)], seed=SEED)
    for _ in range(3):  # successive draws move the run
        with jp.install():
            jflip = jf.corrupt_file("ckpt.corrupt_file", str(jpath), start=start, end=end)
        with tp.install():
            tflip = tf.corrupt_file("ckpt.corrupt_file", str(tpath), start=start, end=end)
        assert tflip == jflip is True
        assert tpath.read_bytes() == jpath.read_bytes()
    assert tpath.read_bytes() != payload
    assert not tf.corrupt_file("ckpt.corrupt_file", str(tpath))  # no plan installed


def test_fault_point_slow_and_flaky():
    plan = tf.FaultPlan([tf.Fault(kind="slow_rank", site="mutation.rebalance", latency_s=0.05),
                         tf.Fault(kind="flaky_bootstrap", site="mutation.rebalance", count=2,
                                  rank=1)], seed=SEED)
    with plan.install():
        t0 = time.monotonic()
        tf.fault_point("mutation.rebalance", rank=0)  # slow, not flaky on rank 0
        assert time.monotonic() - t0 >= 0.05
        for _ in range(2):
            with pytest.raises(tf.FaultInjected, match="mutation.rebalance"):
                tf.fault_point("mutation.rebalance", rank=1)
        tf.fault_point("mutation.rebalance", rank=1)  # the count is spent
        tf.fault_point("mutation.tombstone")  # another site: nothing
    tf.fault_point("mutation.rebalance")  # no plan: nothing


def test_stall_point_matches_jax():
    f = dict(kind="slow_rank", site="job.heartbeat.stall", latency_s=0.02, count=2)
    jp, tp = jf.FaultPlan([jf.Fault(**f)], seed=SEED), tf.FaultPlan([tf.Fault(**f)], seed=SEED)
    with jp.install():
        jseq = [jf.stall_point("job.heartbeat.stall") for _ in range(3)]
    with tp.install():
        tseq = [tf.stall_point("job.heartbeat.stall") for _ in range(3)]
        assert tf.stall_point("job.heartbeat.stall", cancelled=lambda: True) is False
    assert tseq == jseq == [True, True, False]
    assert tf.stall_point("job.heartbeat.stall") is False


@pytest.mark.parametrize("fraction", [0.0, 0.5, 1.0])
def test_corrupt_in_trace_by_count(fraction):
    x = torch.arange(40000, dtype=torch.float32).reshape(200, 200)
    plan = tf.FaultPlan([tf.Fault(kind="corrupt_shard", site="fused.scan.scores",
                                  fraction=fraction)], seed=SEED)
    with plan.install():
        out = tf.corrupt_in_trace("fused.scan.scores", x, 0)
        again = tf.corrupt_in_trace("fused.scan.scores", x, 0)
    share = float(torch.isnan(out).float().mean())
    if fraction == 0.0:
        assert share == 0.0
    elif fraction == 1.0:
        assert share == 1.0
    else:
        assert abs(share - 0.5) < 0.02, share
    assert torch.equal(torch.isnan(out), torch.isnan(again))  # seeded: replays
    kept = ~torch.isnan(out)
    assert torch.equal(out[kept], x[kept])


def test_corrupt_in_trace_rank_scoping_and_drop():
    x = torch.ones(64)
    plan = tf.FaultPlan([tf.Fault(kind="corrupt_shard", site="comms.allreduce", rank=2),
                         tf.Fault(kind="drop_collective", site="comms.allreduce", rank=1)],
                        seed=SEED)
    with plan.install():
        assert torch.isnan(tf.corrupt_in_trace("comms.allreduce", x, 2)).all()
        assert not torch.isnan(tf.corrupt_in_trace("comms.allreduce", x, 1)).any()
        assert torch.isnan(tf.corrupt_in_trace("comms.allreduce", x, torch.tensor(2))).all()
        assert (tf.drop_contribution("comms.allreduce", x, 1, 0.0) == 0).all()
        assert torch.equal(tf.drop_contribution("comms.allreduce", x, 0, 0.0), x)
        assert tf.active_for("comms.allreduce") and not tf.active_for("serve.batch")
        ints = torch.arange(5)
        assert tf.corrupt_in_trace("comms.allreduce", ints, 2) is ints


def test_hooks_return_their_input_without_a_plan():
    from raft_tpu_torch.ops import fused_scan

    x, block = torch.randn(6, 5), np.ones((3, 3), np.float32)
    budgets = torch.tensor([3, 2, 1], dtype=torch.int32)
    other = tf.FaultPlan([tf.Fault(kind="corrupt_shard", site="serve.batch")], seed=SEED)
    for ctx in (None, other):
        if ctx is not None:
            cm = ctx.install()
            cm.__enter__()
        try:
            assert tf.corrupt_in_trace("fused.scan.scores", x, 0) is x
            assert tf.drop_contribution("fused.scan.scores", x, 0, 0.0) is x
            assert tf.corrupt_host("fused.scan.scores", block) is block
            assert tf.fault_point("mutation.tombstone") is None
            assert tf.crash_point("mutation.log.commit") is None
            vals, idx = fused_scan._maybe_corrupt(x, budgets)
            assert vals is x and idx is budgets
            assert probe_budget._maybe_corrupt_budgets(budgets, 1) is budgets
        finally:
            if ctx is not None:
                cm.__exit__(None, None, None)


_CRASH_CHILD = """
import sys
sys.path.insert(0, {root!r})
from raft_tpu_torch.core import faults
plan = faults.FaultPlan([faults.Fault(kind="kill_rank", site="mutation.log.commit",
                                      count={count})], seed=1)
with plan.install():
    for visit in range(1, 5):
        faults.crash_point("mutation.log.commit")
        print("survived", visit, flush=True)
"""


@pytest.mark.parametrize("count", [1, 3])
def test_crash_point_sigkills_a_child_on_the_count_th_visit(count):
    r = subprocess.run([sys.executable, "-c", _CRASH_CHILD.format(root=str(_ROOT), count=count)],
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr[-2000:])
    assert r.stdout.split("\n")[:-1] == [f"survived {v}" for v in range(1, count)]


def test_fault_sites_are_jax_sites_with_live_hooks():
    assert set(tf.FAULT_SITES) <= set(jf.FAULT_SITES)
    for site, text in tf.FAULT_SITES.items():
        assert text == jf.FAULT_SITES[site], site
        assert site in tf.__doc__
    assert tf.known_sites() == tuple(sorted(tf.FAULT_SITES))
    # every registered site is a string literal of some other port module
    literals = {}
    for path in sorted((_ROOT / "raft_tpu_torch").rglob("*.py")):
        if path.name == "faults.py":
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.Constant) and isinstance(node.value, str):
                literals.setdefault(node.value, []).append(path)
    missing = [s for s in tf.FAULT_SITES if s not in literals]
    assert not missing, missing
    # and the module holding the site calls a hook of core/faults
    hooks = {"fault_point", "crash_point", "stall_point", "corrupt_in_trace", "active_plan"}
    for site in tf.FAULT_SITES:
        assert any(hooks & _called_names(p) for p in literals[site]), site


def test_batch_loader_load_is_the_eighth_site():
    """`batch_loader.load` joined with `neighbors/batch_loader` as the
    eighth site (the obs sites `obs.flight.dump` and `serve.trace.stamp`
    came after it, then the ten sites of the comms layer, the five of the
    distributed IVF drivers and the six of the serving and jobs layers:
    thirty-one in all, the JAX registry's every site), the JAX
    description, hooked by `fault_point` and `corrupt_host` in that
    module."""
    assert len(tf.FAULT_SITES) == 31
    assert set(tf.FAULT_SITES) == set(jf.FAULT_SITES)
    assert tf.FAULT_SITES["batch_loader.load"] == jf.FAULT_SITES["batch_loader.load"]
    path = _ROOT / "raft_tpu_torch" / "neighbors" / "batch_loader.py"
    assert {"fault_point", "corrupt_host"} <= _called_names(path)


def test_the_comms_layer_hosts_its_ten_sites():
    """The ten sites of the comms layer, each with the JAX description
    and a live hook in the module that hosts it."""
    hosts = {"comms.allgather": "comms", "comms.allreduce": "comms",
             "comms.bootstrap": "comms", "comms.quant.decode": "quantized",
             "comms.quant.encode": "quantized", "mnmg.kmeans.partials": "mnmg_kmeans",
             "mnmg.kmeans.step": "mnmg_kmeans", "mnmg.knn.scores": "mnmg_knn",
             "resilience.barrier": "resilience", "replica.stale": "replication"}
    hooks = {"fault_point", "corrupt_in_trace", "active_plan", "drop_contribution"}
    for site, mod in hosts.items():
        assert tf.FAULT_SITES[site] == jf.FAULT_SITES[site], site
        path = _ROOT / "raft_tpu_torch" / "comms" / f"{mod}.py"
        assert site in path.read_text(), site
        assert hooks & _called_names(path), site


def test_the_distributed_ivf_drivers_host_their_five_sites():
    """The five sites of the distributed IVF drivers, each with the JAX
    description and a live hook in the module that hosts it: the three
    per-rank score sites of the searches (`corrupt_in_trace`), the
    checkpoint load entry (`fault_point`, which `resilience.rehydrate`
    retries) and the post-commit file rot of the checkpoint writer
    (`corrupt_file`)."""
    hosts = {"mnmg.ivf_pq.scores": ("mnmg_ivf_search", "corrupt_in_trace"),
             "mnmg.ivf_flat.scores": ("mnmg_ivf_search", "corrupt_in_trace"),
             "mnmg.ivf_rabitq.scores": ("mnmg_rabitq", "corrupt_in_trace"),
             "mnmg_ckpt.load": ("mnmg_ckpt", "fault_point"),
             "ckpt.corrupt_file": ("mnmg_ckpt", "corrupt_file")}
    for site, (mod, hook) in hosts.items():
        assert tf.FAULT_SITES[site] == jf.FAULT_SITES[site], site
        path = _ROOT / "raft_tpu_torch" / "comms" / f"{mod}.py"
        assert site in path.read_text(), site
        assert hook in _called_names(path), site


def test_the_serving_and_jobs_layers_host_their_six_sites():
    """The six sites of the serving and jobs layers, each with the JAX
    description and a live hook in the module that hosts it: the serving
    ingress and batch dispatch (`fault_point`), the watchdog's heartbeat
    (`stall_point`), the runner's preemption check (`fault_point`), the
    streaming batch boundary and the scrub cursor boundary (`crash_point`
    after each commit, `fault_point` for the transient flavour)."""
    hosts = {"serve.submit": ("serve/batcher.py", {"fault_point"}),
             "serve.batch": ("serve/engine.py", {"fault_point"}),
             "job.heartbeat.stall": ("jobs/watchdog.py", {"stall_point"}),
             "job.preempt": ("jobs/runner.py", {"fault_point"}),
             "job.stage.crash": ("jobs/streaming.py", {"crash_point", "fault_point"}),
             "integrity.scrub.crash": ("jobs/streaming.py", {"crash_point", "fault_point"})}
    for site, (mod, hooks) in hosts.items():
        assert tf.FAULT_SITES[site] == jf.FAULT_SITES[site], site
        path = _ROOT / "raft_tpu_torch" / mod
        text = path.read_text()
        const = {"integrity.scrub.crash": "SCRUB_CRASH_SITE"}.get(site)
        assert site in text or const in text, site
        assert hooks <= _called_names(path), site


def _called_names(path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Call):
            names.add(getattr(node.func, "attr", getattr(node.func, "id", None)))
    return names


# -- chaos drills --------------------------------------------------------

def _scores_plan():
    return tf.FaultPlan([tf.Fault(kind="corrupt_shard", site="fused.scan.scores",
                                  fraction=1.0)], seed=SEED)


def test_corrupt_fused_scan_candidates_drill():
    rng = np.random.default_rng(SEED)
    data = rng.integers(-8, 8, (1200, 16)).astype(np.float32)
    q = data[:19]
    clean_v, clean_i = brute_force.knn(data, q, 5, engine="fused", device="cpu")
    plan = _scores_plan()
    with plan.install():
        bad_v, _ = brute_force.knn(data, q, 5, engine="fused", device="cpu")
    assert torch.isnan(bad_v).all()
    v2, i2 = brute_force.knn(data, q, 5, engine="fused", device="cpu")
    assert torch.equal(v2, clean_v) and torch.equal(i2, clean_i)
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=8, kmeans_n_iters=4), data,
                           device="cpu")
    sp = ivf_flat.SearchParams(n_probes=8, engine="fused")
    flat_v, flat_i = ivf_flat.search(sp, index, q, 5)
    with plan.install():
        flat_bad, _ = ivf_flat.search(sp, index, q, 5)
    assert torch.isnan(flat_bad).all()
    flat_v2, flat_i2 = ivf_flat.search(sp, index, q, 5)
    assert torch.equal(flat_v2, flat_v) and torch.equal(flat_i2, flat_i)


def test_corrupt_probe_budget_drill():
    rng = np.random.default_rng(SEED)
    cent = rng.normal(size=(16, 24)) * 1.5
    data = (cent[rng.integers(0, 16, 3000)] + rng.normal(size=(3000, 24))).astype(np.float32)
    q = torch.from_numpy(data[:32])
    index = ivf_flat.build(ivf_flat.IndexParams(n_lists=16, kmeans_n_iters=4), data,
                           device="cpu")
    sp = ivf_flat.SearchParams(n_probes=8, budget_tau=1.0, early_term=False)
    clean_v, clean_i = ivf_flat.search(sp, index, q, 10)
    plan = tf.FaultPlan([tf.Fault(kind="corrupt_shard", site="ivf.probe_budget",
                                  fraction=1.0)], seed=SEED)
    with plan.install():
        _, scanned = probe_budget.probe_plan(q, index.centers, n_probes=8, min_probes=1, k=10,
                                             metric=index.metric, tau=1.0)
        bad_v, bad_i = ivf_flat.search(sp, index, q, 10)
    assert (scanned == 1).all()
    assert tuple(bad_i.shape) == (32, 10) and bool((bad_i >= 0).all())
    assert not torch.equal(bad_i, clean_i)
    v2, i2 = ivf_flat.search(sp, index, q, 10)
    assert torch.equal(v2, clean_v) and torch.equal(i2, clean_i)


def test_rabitq_build_encode_chaos():
    data = np.random.default_rng(SEED).standard_normal((600, 32)).astype(np.float32)
    params = ivf_rabitq.IndexParams(n_lists=8, kmeans_n_iters=4)
    clean = ivf_rabitq.build(params, data, device="cpu")
    slow = tf.FaultPlan([tf.Fault(kind="slow_rank", site="ivf_rabitq.build.encode",
                                  latency_s=0.05)], seed=SEED)
    t0 = time.monotonic()
    with slow.install():
        slowed = ivf_rabitq.build(params, data, device="cpu")
    assert time.monotonic() - t0 >= 0.05
    assert torch.equal(slowed.codes, clean.codes) and torch.equal(slowed.aux, clean.aux)
    flaky = tf.FaultPlan([tf.Fault(kind="flaky_bootstrap", site="ivf_rabitq.build.encode",
                                   count=1)], seed=SEED)
    with flaky.install():
        with pytest.raises(tf.FaultInjected):
            ivf_rabitq.build(params, data, device="cpu")
        retry = ivf_rabitq.build(params, data, device="cpu")
    assert torch.equal(retry.codes, clean.codes)


def test_mutation_sites_raise_before_any_state_change():
    data = np.random.default_rng(SEED).standard_normal((600, 16)).astype(np.float32)
    idx = ivf_flat.build(ivf_flat.IndexParams(n_lists=8, kmeans_n_iters=3), data, device="cpu")
    dead = mutation.delete(idx, [1, 2])
    plan = tf.FaultPlan([tf.Fault(kind="flaky_bootstrap", site="mutation.tombstone"),
                         tf.Fault(kind="flaky_bootstrap", site="mutation.rebalance")],
                        seed=SEED)
    before = (dead.tombstones.clone(), dict(dead.list_digests))
    with plan.install():
        with pytest.raises(tf.FaultInjected, match="mutation.tombstone"):
            mutation.delete(dead, [3])
        with pytest.raises(tf.FaultInjected, match="mutation.rebalance"):
            mutation.rebalance(dead)
        again = mutation.delete(dead, [3])  # spent: the retry goes through
        packed, done = mutation.rebalance(again)
    assert torch.equal(dead.tombstones, before[0]) and dead.list_digests == before[1]
    assert again.n_tombstones == 3 and done and packed.tombstones is None


#: the mutation sequence of the kill drill (run in the child and here)
_SCRIPT = """
def _mutation_script(mut):
    rng = np.random.default_rng(9)
    for step in range(5):
        if step % 2 == 0:
            mut.upsert(rng.standard_normal((6, 16)).astype(np.float32),
                       np.arange(6 * step, 6 * step + 6))
        else:
            mut.delete(np.arange(100 + step, 110 + step))
    return mut.commit()
"""
exec(_SCRIPT)

_MUT_CHILD = """
import sys
sys.path.insert(0, {root!r})
import numpy as np
from raft_tpu_torch.core import faults
from raft_tpu_torch.neighbors import ivf_flat, mutation
{script}
idx = ivf_flat.load({base!r}, device="cpu")
plan = faults.FaultPlan([faults.Fault(kind="kill_rank", site="mutation.log.commit",
                                      count={count})], seed=1)
with plan.install():
    _mutation_script(mutation.Mutator({root_dir!r}, idx, ckpt_every=2, slack=8))
print("finished", flush=True)
"""


@pytest.mark.parametrize("count", [2, 3, 4])
def test_mutation_log_commit_kill_resumes_bit_for_bit(tmp_path, count):
    """The hook fires after each log append and after each commit
    (ckpt_every 2): count 2 kills after the second append, before any
    checkpoint (the resume replays both from the cold index); count 3
    right after the first commit (it replays nothing); count 4 after the
    third append (it replays one)."""
    data = np.random.default_rng(SEED).standard_normal((600, 16)).astype(np.float32)
    idx = ivf_flat.build(ivf_flat.IndexParams(n_lists=8, kmeans_n_iters=3), data, device="cpu")
    base = str(tmp_path / "base.ckpt")
    ivf_flat.save(base, idx)
    root = str(tmp_path / "killed")
    code = _MUT_CHILD.format(root=str(_ROOT), script=_SCRIPT, base=base, count=count,
                             root_dir=root)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr[-2000:])
    assert "finished" not in r.stdout
    assert (Path(root) / "index.ckpt").exists() == (count >= 3)
    resumed = _mutation_script(mutation.Mutator(root, ivf_flat.load(base, device="cpu"),
                                                ckpt_every=2, slack=8))
    clean = _mutation_script(mutation.Mutator(str(tmp_path / "clean"),
                                              ivf_flat.load(base, device="cpu"),
                                              ckpt_every=2, slack=8))
    for f in ("list_data", "slot_rows", "list_sizes", "source_ids", "tombstones"):
        a, b = getattr(resumed, f), getattr(clean, f)
        assert (a is None and b is None) or torch.equal(a, b), f
    assert (Path(root) / "index.ckpt").read_bytes() == \
        (tmp_path / "clean" / "index.ckpt").read_bytes()
    log = json.loads((Path(root) / "mutlog.jsonl").read_text().splitlines()[-1])
    assert log["seq"] == 4
