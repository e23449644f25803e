"""The port's process world: a real 2-process gloo world on the CPU
(`bootstrap_multihost` over torch.distributed), spawned once for the
module (tests/_torch_comms_dist_worker.py), against the in-process 2-rank
CPU world on the same seeded inputs.

- The collectives (allreduce SUM / MIN / MAX / PROD, bcast, reduce,
  allgather(v), reducescatter, shift, device_sendrecv with a pair to
  itself, comm_split groups of one and of two on `dist.new_group`s,
  barrier, the int8 ring allreduce over `batch_isend_irecv`) equal the
  in-process world's bit for bit on both processes.
- `knn_local` (replicated, sharded, prefiltered), `kmeans_fit_local`,
  `kmeans_predict_local` and the health barrier equal the in-process
  `knn` / `kmeans_fit` / `kmeans_predict` on the concatenated rows.
- The distributed IVF-PQ lifecycle `ivf_pq_build_local` ->
  `ivf_pq_save_local` -> `ivf_pq_extend_local` -> `ivf_pq_save_local` ->
  `ivf_pq_load`: the in-process 2-rank world loads the built checkpoint,
  extends it with the concatenated new rows, and answers as the process
  world did at every step, bit for bit; both load the extended checkpoint
  to the same tables; the process world's own load answers as its
  extended index did.
- `jobs.resumable_extend_local_from_file` on the process world: a stream
  preempted after its second checkpoint resumes from the agreed cursor
  (a MIN all-reduce over the process group) through `rehydrate` and
  answers as the uninterrupted 2-process run, bit for bit.
- It cannot hang: the process group's collectives time out at 60 s, each
  child has its own join deadline and is killed past it.
"""

import os
import socket
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent))

import _torch_comms_dist_worker as worker  # noqa: E402

from raft_tpu_torch.comms import Comms, mnmg  # noqa: E402
from raft_tpu_torch.comms.comms import P  # noqa: E402

_ROOT = Path(__file__).resolve().parent.parent
WORLD = 2
#: seconds both children have to finish, together
JOIN_S = 120.0


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Both children's results; a child that fails or misses its deadline
    fails the module (the other is killed)."""
    out = tmp_path_factory.mktemp("gloo")
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=str(_ROOT), OMP_NUM_THREADS="1")
    procs, logs = [], []
    for r in range(WORLD):
        log = open(out / f"rank{r}.log", "w")
        logs.append(log)
        procs.append(subprocess.Popen(
            [sys.executable, str(_ROOT / "tests" / "_torch_comms_dist_worker.py"), str(r),
             str(WORLD), str(port), str(out)], stdout=log, stderr=subprocess.STDOUT, env=env))
    failed = []
    deadline = time.monotonic() + JOIN_S
    try:
        for r, p in enumerate(procs):
            try:
                rc = p.wait(timeout=max(0.1, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                rc = "timeout"
            if rc != 0:
                failed.append((r, rc))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for log in logs:
            log.close()
    if failed:
        tails = {r: (out / f"rank{r}.log").read_text()[-3000:] for r in range(WORLD)}
        pytest.fail(f"gloo children failed: {failed}\n{tails}")
    return [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]


@pytest.fixture(scope="module")
def local_world():
    c = Comms(n_devices=WORLD, device="cpu", timeout_s=60)
    yield c
    c.destroy()


def test_collectives_equal_the_in_process_world(ranks, local_world):
    x, q, xf, xi = worker.dataset()
    want = local_world.run(worker.collectives, local_world.shard(xf), local_world.shard(xi),
                           in_specs=(P("data"), P("data")), out_specs=(P("data"),) * 19)
    for res in ranks:
        assert len(res["collectives"]) == len(want)
        for got, ref in zip(res["collectives"], want):
            assert got.dtype == ref.dtype and torch.equal(got, ref)


def test_knn_local_equals_the_in_process_knn(ranks, local_world):
    x, q, _, _ = worker.dataset()
    keep = np.random.default_rng(3).random(worker.N) < 0.5
    want = {"knn": mnmg.knn(local_world, x, q, worker.K),
            "knn_sharded": mnmg.knn(local_world, x, q, worker.K, query_mode="sharded"),
            "knn_prefilter": mnmg.knn(local_world, x, q, worker.K, prefilter=keep)}
    for res in ranks:
        for name, (wv, wi) in want.items():
            v, i = res[name]
            assert torch.equal(v, wv) and torch.equal(i, wi), name


def test_kmeans_local_equals_the_in_process_fit(ranks, local_world):
    x, _, _, _ = worker.dataset()
    centers, inertia, n_iter = mnmg.kmeans_fit(local_world, x, 6, max_iter=10, seed=0)
    labels = mnmg.kmeans_predict(local_world, x, centers).numpy()
    for r, res in enumerate(ranks):
        c, i, it = res["kmeans"]
        assert torch.equal(c, centers) and i == inertia and it == n_iter
        part = worker.partition(labels, WORLD, r)
        np.testing.assert_array_equal(res["labels"].numpy(), part)
        assert 0 <= res["barrier_s"] < 30


def test_ivf_pq_local_lifecycle_equals_the_in_process_world(ranks, local_world):
    _, q, _, _ = worker.dataset()
    out = Path(ranks[0]["out_dir"])
    built = mnmg.ivf_pq_load(local_world, str(out / "pq_built.ckpt"))
    extended = mnmg.ivf_pq_extend_local(built, worker.new_rows())
    assert extended.n == worker.N + worker.N_NEW
    want = {"pq_built": worker.pq_search(built, q),
            "pq_extended": worker.pq_search(extended, q)}
    for res in ranks:
        assert res["pq_n"] == extended.n
        for name, (wv, wi) in want.items():
            v, i = res[name]
            assert torch.equal(v, wv) and torch.equal(i, wi), name
        v, i = res["pq_loaded"]
        assert torch.equal(v, want["pq_extended"][0]) and torch.equal(i, want["pq_extended"][1])
    loaded = mnmg.ivf_pq_load(local_world, str(out / "pq_extended.ckpt"))
    assert torch.equal(loaded.codes.full(), extended.codes.full())
    assert torch.equal(loaded.slot_gids.full(), extended.slot_gids.full())
    assert loaded.extended and loaded.n == extended.n


def test_resumable_extend_local_resumes_after_a_preempt(ranks):
    n_batches = -(-worker.N_NEW // WORLD // worker.STREAM_BATCH)
    for res in ranks:
        ref, got = res["stream_ref_stats"], res["stream_resumed_stats"]
        assert ref["resumed_from_batch"] == 0 and ref["batches"] == n_batches
        assert got["resumed_from_batch"] == 2 and got["batches"] == n_batches - 2
        assert res["stream_n"][0] == res["stream_n"][1] == worker.N + worker.N_NEW
        (rv, ri), (gv, gi) = res["stream_ref"], res["stream_resumed"]
        assert torch.equal(gv, rv) and torch.equal(gi, ri)
    assert torch.equal(ranks[0]["stream_resumed"][1], ranks[1]["stream_resumed"][1])
