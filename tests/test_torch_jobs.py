"""PyTorch port: the jobs layer (raft_tpu_torch/jobs) against the JAX
package's raft_tpu/jobs — tests/test_jobs.py's cases, the job stages of
tests/test_integrity.py (`resumable_scrub`) and tests/test_mutation.py
(`resumable_mutate`), run through both packages where a result can be
compared.

- JobDir: `fingerprint_of` and `Job.fingerprint` equal JAX's; a manifest
  line the port commits is byte for byte the JAX line for the same
  entry, and either package's JobDir skips a stage the other committed.
- The runner: skip / resume / invalidate, failure and blocking, SIGTERM
  and the injected `job.preempt` site as a graceful suspend, watchdog
  stall-kills (`job.heartbeat.stall`) retried and rendered by the port's
  `obs.report`, supervised children (exit codes, silent children,
  grandchildren, the describe name).
- Streaming: a stream interrupted at a batch boundary (and in the torn
  commit window) resumes to a saved index byte for byte the saved index
  of an uninterrupted run, for each family; the JAX package loads the
  port's file and answers as its own stream of the same rows. A
  `resumable_write_npy` file is byte for byte the JAX one, and either
  package resumes a file the other began.
- Kill-and-resume (children that import torch and the port only,
  tests/_torch_job_crash_worker.py; one JAX build per kind in the
  parent): a stream SIGKILLed at `job.stage.crash` and resumed gives the
  uninterrupted run's file byte for byte; so does `make_data`; a scrub
  SIGKILLed at `integrity.scrub.crash` resumes from its cursor.
- MNMG: `checkpointed_mnmg_build` re-enters through `rehydrate` and
  answers as the build did; `resumable_extend_local_from_file` resumes
  after a preempt to the uninterrupted answer (in-process world; the
  2-process gloo world is in tests/test_torch_comms_dist.py).
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

from raft_tpu import jobs as jjobs
from raft_tpu import obs as jobs_obs
from raft_tpu.core import faults as jfaults
from raft_tpu_torch import jobs, obs
from raft_tpu_torch.core import faults
from raft_tpu_torch.jobs import (
    Heartbeat,
    Job,
    JobDir,
    JobPreempted,
    StageFailed,
    StageTimeout,
    Watchdog,
    fingerprint_of,
    run_supervised,
)
from raft_tpu_torch.neighbors import ivf_flat, mutation
from raft_tpu_torch.obs import report as obs_report

import _torch_job_crash_worker as worker
import _torch_serve_util as u

SEED = int(os.environ.get(faults.ENV_SEED, "1234"))
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(REPO, "tests", "_torch_job_crash_worker.py")
ROWS, DIM, BATCH = 80, 8, 16


@pytest.fixture
def obs_on():
    prev = signal.getsignal(signal.SIGTERM)
    for m in (obs, jobs_obs):
        m.reset()
        m.enable()
    yield
    for m in (obs, jobs_obs):
        m.reset()
        m.disable()
        m.flight.uninstall()
    signal.signal(signal.SIGTERM, prev)


# -- the streamed rows and one JAX cold-start build per kind -------------

def _small_params(kind, mod):
    if kind == "ivf_flat":
        return mod.IndexParams(n_lists=4, kmeans_n_iters=2, add_data_on_build=False)
    if kind == "ivf_pq":
        return mod.IndexParams(n_lists=4, pq_dim=4, pq_bits=4, kmeans_n_iters=2,
                               kmeans_trainset_fraction=1.0, add_data_on_build=False)
    return mod.IndexParams(n_lists=4, kmeans_n_iters=2, add_data_on_build=False,
                           store_dataset=False)


@pytest.fixture(scope="module")
def stream(tmp_path_factory):
    """(path of the (80, 8) rows, {kind: (JAX empty index, path of its
    port copy saved by the port)})."""
    d = tmp_path_factory.mktemp("stream")
    path = str(d / "ds.npy")
    np.save(path, np.random.default_rng(0).random((ROWS, DIM), dtype=np.float32))
    data = np.load(path)
    seeds = {}
    for kind in u.KINDS:
        jmod, tmod = u.JMOD[kind], u.TMOD[kind]
        if kind == "ivf_rabitq":
            jb = jmod.build(_small_params(kind, jmod), data[:40])
            perm = u.signed_perm(DIM)
            cent = (np.asarray(jb.centers) @ np.asarray(jb.rotation) @ perm.T).astype(np.float32)
            import jax.numpy as jnp

            jidx = jmod.Index(jb.params, jnp.asarray(perm), jnp.asarray(cent), jb.codes,
                              jb.aux, jb.slot_rows, jb.list_sizes, jb.source_ids)
        else:
            jidx = jmod.build(_small_params(kind, jmod), data[:40])
        arrays = {f: np.asarray(getattr(jidx, f)) for f in tmod.INDEX_FIELDS}
        tidx = tmod.index_from_arrays(arrays, _small_params(kind, tmod), device="cpu")
        seed_path = str(d / f"{kind}.seed.ckpt")
        tmod.save(seed_path, tidx)
        seeds[kind] = (jidx, seed_path)
    return path, seeds


def _fresh(stream, kind):
    """A new port copy of the kind's trained empty index."""
    return u.TMOD[kind].load(stream[1][kind][1], device="cpu")


def _saved(kind, index, path):
    u.TMOD[kind].save(path, index)
    with open(path, "rb") as fh:
        return fh.read()


# -- JobDir: the durable commit protocol --------------------------------

def test_fingerprint_of_equals_jax():
    payloads = [{"stage": "s", "inputs": {"rows": 10}}, {"inputs": {"rows": 10}, "stage": "s"},
                {"stage": "s", "inputs": {"rows": 11, "path": "/d/x.npy"}, "deps": {"a": "0f"}},
                "a string", [1, 2.5, None], {}]
    for p in payloads:
        assert fingerprint_of(p) == jjobs.fingerprint_of(p)
    a, b, c = (fingerprint_of(p) for p in payloads[:3])
    assert a == b and a != c and len(a) == 8 and int(a, 16) >= 0


def test_jobdir_commit_skip_and_artifact_verification(tmp_path):
    jd = JobDir(str(tmp_path / "jd"))
    art = jd.artifact_path("s1")
    with open(art, "w") as fh:
        fh.write("payload")
    entry = jd.commit("s1", "aaaa0000", artifacts={"artifact": art}, meta={"rows": 7},
                      provenance={"git_sha": "deadbee"})
    assert entry["artifacts"]["artifact"]["nbytes"] == 7
    got = jd.is_complete("s1", "aaaa0000")
    assert got is not None and got["meta"] == {"rows": 7}
    assert jd.is_complete("s1", "bbbb1111") is None
    jd.commit("s1", "bbbb1111", artifacts={"artifact": art}, meta={"rows": 8})
    assert jd.is_complete("s1", "aaaa0000") is None
    assert jd.is_complete("s1", "bbbb1111")["meta"] == {"rows": 8}
    # the JAX package reads the port's manifest to the same decisions
    jjd = jjobs.JobDir(str(tmp_path / "jd"))
    assert jjd.read_manifest() == jd.read_manifest()
    assert jjd.is_complete("s1", "bbbb1111")["meta"] == {"rows": 8}
    assert jjd.is_complete("s1", "aaaa0000") is None


def test_manifest_lines_are_byte_compatible_both_ways(tmp_path):
    """The same commits through either package write the same bytes, and
    each package skips the stages the other committed."""
    blobs = []
    for name, mod in (("port", jobs), ("jax", jjobs)):
        jd = mod.JobDir(str(tmp_path / name))
        art = jd.artifact_path("s1", "table")
        with open(art, "wb") as fh:
            fh.write(b"\x00\x01payload")
        os.utime(art, ns=(10**18, 10**18))
        jd.commit("s1", "aaaa0000", artifacts={"table": art}, meta={"rows": 7, "x": [1.5]},
                  provenance={"git_sha": "deadbee", "utc": "2026-01-01T00:00:00Z"})
        jd.commit("s2", "bbbb1111", meta={"n": 2})
        blobs.append(open(jd.manifest_path, "rb").read())
        JobDir.write_json(os.path.join(jd.scratch("s2"), "cursor.json"), {"batch": 3})
    assert blobs[0] == blobs[1]
    assert open(tmp_path / "port" / "scratch" / "s2" / "cursor.json", "rb").read() == \
        open(tmp_path / "jax" / "scratch" / "s2" / "cursor.json", "rb").read()
    assert jjobs.JobDir(str(tmp_path / "port")).is_complete("s1", "aaaa0000") is not None
    assert JobDir(str(tmp_path / "jax")).is_complete("s1", "aaaa0000") is not None
    assert jjobs.JobDir.read_json(str(tmp_path / "port" / "scratch" / "s2" / "cursor.json")) \
        == {"batch": 3}


def test_jobdir_artifact_rot_fails_closed(tmp_path):
    jd = JobDir(str(tmp_path / "jd"))
    art = jd.artifact_path("s1")
    with open(art, "w") as fh:
        fh.write("payload")
    jd.commit("s1", "aaaa0000", artifacts={"artifact": art})
    assert jd.is_complete("s1", "aaaa0000") is not None  # fast path OK
    with open(art, "w") as fh:
        fh.write("pAyload")  # same size, different bytes
    os.utime(art, ns=(1, 1))  # metadata moved -> full CRC catches it
    assert jd.is_complete("s1", "aaaa0000") is None
    assert jjobs.JobDir(str(tmp_path / "jd")).is_complete("s1", "aaaa0000") is None
    with open(art, "w") as fh:
        fh.write("payload")
    os.utime(art, ns=(2, 2))
    assert jd.is_complete("s1", "aaaa0000") is not None
    os.remove(art)
    assert jd.is_complete("s1", "aaaa0000") is None


def test_manifest_torn_line_is_skipped_and_terminated(tmp_path):
    jd = JobDir(str(tmp_path / "jd"))
    jd.commit("s1", "aaaa0000")
    with open(jd.manifest_path, "ab") as fh:
        fh.write(b'{"stage": "s2", "fingerpr')  # torn mid-write
    jd.commit("s3", "cccc2222")
    assert [e["stage"] for e in jd.read_manifest()] == ["s1", "s3"]
    assert jd.is_complete("s3", "cccc2222") is not None
    assert [e["stage"] for e in jjobs.JobDir(str(tmp_path / "jd")).read_manifest()] == \
        ["s1", "s3"]


# -- runner: DAG skip/resume/invalidate ---------------------------------

def _three_stage_job(root, calls, x=1, mod=jobs):
    job = mod.Job("demo", root)

    def a(ctx):
        calls.append("a")
        with open(ctx.artifact_path(), "w") as fh:
            fh.write("A")
        return {"n": 1}

    def b(ctx):
        calls.append("b")
        assert ctx.dep_meta("a") == {"n": 1}
        assert open(ctx.dep_artifact("a")).read() == "A"
        return {"n": 2}

    def c(ctx):
        calls.append("c")
        return {"n": 3}

    job.add_stage("a", a, inputs={"x": x})
    job.add_stage("b", b, deps=("a",))
    job.add_stage("c", c, deps=("b",))
    return job


def test_rerun_skips_completed_stages(tmp_path):
    calls = []
    root = str(tmp_path / "jd")
    job = _three_stage_job(root, calls)
    jjob = _three_stage_job(str(tmp_path / "jax"), [], mod=jjobs)
    for name in ("a", "b", "c"):
        assert job.fingerprint(name) == jjob.fingerprint(name)
    assert job.run() == {"a": "ran", "b": "ran", "c": "ran"}
    job2 = _three_stage_job(root, calls)
    assert job2.run() == {"a": "skipped", "b": "skipped", "c": "skipped"}
    assert calls == ["a", "b", "c"]  # nothing re-ran
    assert job2.results == {"a": {"n": 1}, "b": {"n": 2}, "c": {"n": 3}}
    # the JAX runner skips every stage the port committed
    jcalls = []
    assert _three_stage_job(root, jcalls, mod=jjobs).run() == {
        "a": "skipped", "b": "skipped", "c": "skipped"}
    assert jcalls == []


def test_changed_input_reruns_stage_and_everything_downstream(tmp_path):
    calls = []
    root = str(tmp_path / "jd")
    _three_stage_job(root, calls).run()
    job2 = _three_stage_job(root, calls, x=2)
    stale = os.path.join(job2.jobdir.scratch("a"), "cursor.json")
    with open(stale, "w") as fh:
        fh.write("{}")
    assert job2.run() == {"a": "ran", "b": "ran", "c": "ran"}
    assert not os.path.exists(stale)
    assert calls == ["a", "b", "c", "a", "b", "c"]


def test_commit_clears_stage_scratch(tmp_path):
    job = Job("clean", str(tmp_path / "jd"))

    def stage(ctx):
        with open(os.path.join(ctx.scratch(), "stream.ckpt"), "w") as fh:
            fh.write("x" * 64)
        return {}

    job.add_stage("s", stage)
    assert job.run() == {"s": "ran"}
    assert not os.listdir(job.jobdir.scratch("s"))


def test_stage_failure_raises_with_cause_and_blocks_dependents(tmp_path):
    boom = ValueError("boom")

    def bad(ctx):
        raise boom

    ran = []
    job = Job("fail", str(tmp_path / "jd"))
    job.add_stage("bad", bad)
    job.add_stage("after", lambda ctx: ran.append(1) or {}, deps=("bad",))
    with pytest.raises(StageFailed) as ei:
        job.run()
    assert ei.value.__cause__ is boom
    job2 = Job("fail", str(tmp_path / "jd"))
    job2.add_stage("bad", bad)
    job2.add_stage("after", lambda ctx: {}, deps=("bad",))
    job2.add_stage("indep", lambda ctx: {})
    st = job2.run(continue_on_error=True)
    assert st == {"bad": "failed", "after": "blocked", "indep": "ran"}
    assert not ran


def test_dag_declaration_errors(tmp_path):
    for mod in (jobs, jjobs):
        job = mod.Job("bad", str(tmp_path / mod.__name__))
        job.add_stage("a", lambda ctx: {})
        with pytest.raises(ValueError, match="duplicate"):
            job.add_stage("a", lambda ctx: {})
        with pytest.raises(ValueError, match="unknown stage"):
            job.add_stage("b", lambda ctx: {}, deps=("nope",))


# -- preemption: a graceful suspend, not a failure ----------------------

def test_sigterm_suspends_after_current_stage_and_rerun_resumes(tmp_path):
    prev = signal.getsignal(signal.SIGTERM)
    root = str(tmp_path / "jd")
    job = Job("pre", root)
    job.add_stage("s1", lambda ctx: {"n": 1})

    def s2(ctx):
        os.kill(os.getpid(), signal.SIGTERM)  # the preemption notice
        time.sleep(0.02)
        return {"n": 2}

    job.add_stage("s2", s2, deps=("s1",))
    job.add_stage("s3", lambda ctx: {"n": 3}, deps=("s2",))
    with pytest.raises(JobPreempted):
        job.run()
    assert job.statuses == {"s1": "ran", "s2": "ran"}
    assert signal.getsignal(signal.SIGTERM) is prev  # the handler is restored
    job2 = Job("pre", root)
    job2.add_stage("s1", lambda ctx: {"n": 1})
    job2.add_stage("s2", lambda ctx: {"n": 2}, deps=("s1",))
    job2.add_stage("s3", lambda ctx: {"n": 3}, deps=("s2",))
    assert job2.run() == {"s1": "skipped", "s2": "skipped", "s3": "ran"}


def test_sigterm_handler_installs_from_the_main_thread_only(tmp_path):
    """From another thread `Job.run` installs no handler (signal.signal
    refuses there) and runs to its end."""
    prev = signal.getsignal(signal.SIGTERM)
    seen = []

    def stage(ctx):
        seen.append(signal.getsignal(signal.SIGTERM))
        return {}

    job = Job("thread", str(tmp_path / "jd"))
    job.add_stage("s", stage)
    out = []
    th = threading.Thread(target=lambda: out.append(job.run()))
    th.start()
    th.join(30)
    assert out == [{"s": "ran"}] and seen == [prev]


def test_injected_preempt_fault_suspends_like_sigterm(tmp_path, obs_on):
    root = str(tmp_path / "jd")
    counts = []
    for mod, fl in ((jobs, faults), (jjobs, jfaults)):
        plan = fl.FaultPlan([fl.Fault(kind="flaky_bootstrap", site="job.preempt", count=1)],
                            seed=SEED)
        job = mod.Job("chaos_pre", root + mod.__name__)
        job.add_stage("s1", lambda ctx: {})
        job.add_stage("s2", lambda ctx: {}, deps=("s1",))
        with plan.install():
            with pytest.raises(mod.JobPreempted):
                job.run()
        counts.append(dict(job.statuses))
    evs = [e for e in obs.snapshot()["events"] if e["kind"] == "job"]
    assert "preempt" in [e.get("action") for e in evs]
    assert counts[0] == counts[1]
    job2 = Job("chaos_pre", root + jobs.__name__)
    job2.add_stage("s1", lambda ctx: {})
    job2.add_stage("s2", lambda ctx: {}, deps=("s1",))
    assert job2.run()["s2"] == "ran"


def test_preempt_point_mid_stage_leaves_durable_state(tmp_path):
    root = str(tmp_path / "jd")
    seen = []

    def build(job):
        def streamy(ctx):
            marker = os.path.join(ctx.scratch(), "cursor.json")
            done = (JobDir.read_json(marker) or {}).get("done", 0)
            for i in range(done, 3):
                ctx.jobdir.write_json(marker, {"done": i + 1})
                seen.append(i)
                if i == 1:
                    job.request_preempt()
                ctx.preempt_point()
            return {"done": 3}

        job.add_stage("streamy", streamy)
        return job

    with pytest.raises(JobPreempted):
        build(Job("mid", root)).run()
    assert seen == [0, 1]
    st = build(Job("mid", root)).run()
    assert st == {"streamy": "ran"} and seen == [0, 1, 2]


# -- watchdog: stalls become typed timeouts, retried --------------------

def _stall_job(mod, root, attempts):
    job = mod.Job("stall", root)

    def work(ctx):
        attempts.append(1)
        for _ in range(3):
            ctx.heartbeat()
            time.sleep(0.01)
        return {"ok": True}

    job.add_stage("w", work, retries=2, stall_timeout_s=0.3)
    return job


def test_injected_heartbeat_stall_is_killed_retried_and_reported(tmp_path, obs_on):
    """`job.heartbeat.stall`: an injected slow_rank stall swallows the
    stage's beats; the watchdog kills the attempt as StageTimeout, the
    seeded retry re-runs it and the job completes, in both packages; the
    stall, the kill and the retry land in the port's `obs.report` as in
    JAX's."""
    outs = []
    for mod, fl, om, rep in ((jobs, faults, obs, obs_report),
                             (jjobs, jfaults, jobs_obs, None)):
        plan = fl.FaultPlan([fl.Fault(kind="slow_rank", site="job.heartbeat.stall",
                                      latency_s=5.0, count=1)], seed=SEED)
        attempts = []
        with plan.install():
            st = _stall_job(mod, str(tmp_path / mod.__name__), attempts).run()
        assert st == {"w": "ran"} and len(attempts) == 2
        snap = om.snapshot()
        acts = [(e["kind"], e.get("action") or e.get("describe"))
                for e in snap["events"] if e["kind"] in ("fault", "retry")]
        outs.append(acts)
        if rep is not None:
            out = rep.render(snap)
            assert "watchdog_kill" in out and "action=stall" in out and "retry" in out
            assert "## Job timeline" in out and "stall.w" in out
    assert ("fault", "stall") in outs[0] and ("fault", "watchdog_kill") in outs[0]
    assert ("retry", "job.stall.w") in outs[0]
    assert outs[0] == outs[1]


def test_watchdog_deadline_kills_non_beating_stage(tmp_path):
    job = Job("dead", str(tmp_path / "jd"))

    def hang(ctx):
        time.sleep(30)
        return {}

    job.add_stage("h", hang, deadline_s=0.25)
    t0 = time.monotonic()
    with pytest.raises(StageFailed) as ei:
        job.run()
    assert isinstance(ei.value.__cause__, StageTimeout)
    assert time.monotonic() - t0 < 10


def test_watchdog_kill_breaks_a_device_wait():
    """The watchdog's kill reaches a stage blocked in a fence: the stage
    waits through `core.interruptible.synchronize` on a never-ready
    waitable, and `interruptible.cancel` (the kill) ends the wait."""
    from raft_tpu_torch.core import interruptible

    class Never:
        def query(self):
            return False

    unwound = []

    def stage():
        try:
            interruptible.synchronize(Never(), poll_interval_s=0.005)
        except interruptible.InterruptedException:
            unwound.append("interrupted")
            raise

    dog = Watchdog(stall_timeout_s=0.2)
    with pytest.raises(StageTimeout):
        dog.run(stage, describe="fence")
    assert unwound == ["interrupted"]


def test_watchdog_without_limits_is_a_plain_call():
    assert Watchdog().run(lambda: 42) == 42


def test_heartbeat_beat_raises_after_kill():
    hb = Heartbeat()
    hb._kill()
    with pytest.raises(jobs.StageCancelled):
        hb.beat()


def test_run_supervised_child_output_beats_and_exit_code_passthrough():
    cmd = [sys.executable, "-c", "print('line'); import sys; sys.exit(4)"]
    assert run_supervised(cmd, stall_timeout_s=30.0, echo=False) == 4
    assert jjobs.run_supervised(cmd, stall_timeout_s=30.0, echo=False) == 4


def test_run_supervised_kills_silent_child(obs_on):
    t0 = time.monotonic()
    with pytest.raises(StageTimeout, match="watchdog killed child"):
        run_supervised([sys.executable, "-c",
                        "print('warm', flush=True); import time; time.sleep(600)"],
                       describe="hung_bench", stall_timeout_s=0.5, echo=False)
    assert time.monotonic() - t0 < 30
    evs = [e for e in obs.snapshot()["events"]
           if e["kind"] == "fault" and e.get("action") == "watchdog_kill"]
    assert evs and evs[0]["stage"] == "hung_bench"


def test_run_supervised_kill_reaps_grandchildren(tmp_path):
    pidfile = str(tmp_path / "grandchild.pid")
    child = (
        "import subprocess, sys, time\n"
        "g = subprocess.Popen([sys.executable, '-c', 'import time; time.sleep(600)'])\n"
        f"open({pidfile!r}, 'w').write(str(g.pid))\n"
        "print('spawned', flush=True)\n"
        "time.sleep(600)\n"
    )
    with pytest.raises(StageTimeout):
        run_supervised([sys.executable, "-c", child], describe="treekill",
                       stall_timeout_s=0.5, echo=False)
    deadline = time.monotonic() + 10
    gpid = int(open(pidfile).read())
    while time.monotonic() < deadline:
        try:
            os.kill(gpid, 0)
        except ProcessLookupError:
            break  # reaped with the group
        time.sleep(0.1)
    else:
        os.kill(gpid, 9)
        raise AssertionError("grandchild survived the watchdog kill")


def test_run_supervised_default_describe_names_script(tmp_path):
    script = tmp_path / "toy_bench.py"
    script.write_text("import time; time.sleep(600)\n")
    with pytest.raises(StageTimeout, match="toy_bench.py"):
        run_supervised([sys.executable, str(script), "--apply"], stall_timeout_s=0.5,
                       echo=False)


def test_watchdog_zombie_attempt_cannot_be_revived_by_retry():
    hb = Heartbeat()
    zombie_result = []
    adopted = threading.Event()
    release = threading.Event()

    def zombie():
        hb.adopt()
        adopted.set()
        release.wait(10)
        try:
            hb.beat()
            zombie_result.append("revived")
        except jobs.StageCancelled:
            zombie_result.append("stayed_dead")

    th = threading.Thread(target=zombie, daemon=True)
    th.start()
    assert adopted.wait(10)
    hb._kill()
    hb.rearm()
    hb.adopt()
    hb.beat()
    release.set()
    th.join(10)
    assert zombie_result == ["stayed_dead"]


# -- streaming resume (in-process) --------------------------------------

class _Interrupted(RuntimeError):
    pass


def _interrupt_at(n):
    commits = []

    def preempt():
        commits.append(1)
        if len(commits) == n:
            raise _Interrupted("preempted at batch boundary")

    return preempt


def _reference(stream, kind, tmp_path):
    ref, _ = jobs.resumable_extend_from_file(kind, _fresh(stream, kind), stream[0], BATCH,
                                             scratch=str(tmp_path / "ref_scr"),
                                             checkpoint_every=1)
    return ref, _saved(kind, ref, str(tmp_path / "ref.ckpt"))


@pytest.mark.parametrize("kind", u.KINDS)
def test_streaming_preempt_at_batch_boundary_resumes_bit_identical(tmp_path, stream, kind):
    """Interrupt the stream at a batch-boundary checkpoint, re-enter: the
    saved index is byte for byte the uninterrupted run's; the JAX package
    loads it and answers as its own stream of the same rows."""
    ref, ref_bytes = _reference(stream, kind, tmp_path)
    scratch = str(tmp_path / "scr")
    with pytest.raises(_Interrupted):
        jobs.resumable_extend_from_file(kind, _fresh(stream, kind), stream[0], BATCH,
                                        scratch=scratch, checkpoint_every=1,
                                        preempt=_interrupt_at(2))
    got, stats = jobs.resumable_extend_from_file(kind, _fresh(stream, kind), stream[0], BATCH,
                                                 scratch=scratch, checkpoint_every=1)
    assert stats["resumed_from_batch"] == 2 and stats["rows_ingested"] == ROWS
    assert stats["rows_this_run"] == ROWS - 2 * BATCH
    assert _saved(kind, got, str(tmp_path / "got.ckpt")) == ref_bytes
    # the JAX package reads the port's file and answers as its own stream
    jmod = u.JMOD[kind]
    jref, jstats = jjobs.resumable_extend_from_file(
        kind, stream[1][kind][0], stream[0], BATCH, scratch=str(tmp_path / "jscr"),
        checkpoint_every=1)
    assert jstats["rows_ingested"] == stats["rows_ingested"]
    loaded = jmod.load(str(tmp_path / "got.ckpt"))
    for f in ("slot_rows", "list_sizes", "source_ids"):
        np.testing.assert_array_equal(np.asarray(getattr(loaded, f)), np.asarray(getattr(jref, f)))
    q = np.load(stream[0])[:7]
    sp = jmod.SearchParams(n_probes=4)
    jv, ji = jmod.search(sp, jref, q, 5)
    lv, li = jmod.search(sp, loaded, q, 5)
    u.assert_tie_equal(lv, li, jv, ji)


@pytest.mark.parametrize("kind", u.KINDS)
def test_stream_from_a_port_trained_empty_index(tmp_path, stream, kind):
    """The port's own trained empty index (`add_data_on_build=False`),
    saved and loaded, streams like the carried one: a loaded empty table
    (a stride-0 tensor) refreshes its digests on the first extend."""
    from raft_tpu_torch.integrity import digest

    mod = u.TMOD[kind]
    data = np.load(stream[0])
    built = mod.build(_small_params(kind, mod), data[:40], device="cpu")
    path = str(tmp_path / "seed.ckpt")
    mod.save(path, built)
    seed = mod.load(path, device="cpu")
    got, stats = jobs.resumable_extend_from_file(kind, seed, stream[0], BATCH,
                                                 scratch=str(tmp_path / "s"))
    assert stats["rows_ingested"] == ROWS and got.size == ROWS
    digest.check_fresh(got)
    ref = mod.extend(built, data, np.arange(ROWS, dtype=np.int32))
    np.testing.assert_array_equal(u.as_np(got.source_ids), u.as_np(ref.source_ids))


def test_streaming_torn_commit_window_resumes_consistently(tmp_path, stream):
    ref, ref_bytes = _reference(stream, "ivf_flat", tmp_path)
    scratch = str(tmp_path / "scr")
    with pytest.raises(_Interrupted):
        jobs.resumable_extend_from_file("ivf_flat", _fresh(stream, "ivf_flat"), stream[0],
                                        BATCH, scratch=scratch, checkpoint_every=1,
                                        preempt=_interrupt_at(2))
    shutil.copy(os.path.join(scratch, "stream_index.2.ckpt"),
                os.path.join(scratch, "stream_index.3.ckpt"))
    got, stats = jobs.resumable_extend_from_file("ivf_flat", _fresh(stream, "ivf_flat"),
                                                 stream[0], BATCH, scratch=scratch,
                                                 checkpoint_every=1)
    assert stats["resumed_from_batch"] == 2  # the cursor, not the orphan
    assert _saved("ivf_flat", got, str(tmp_path / "got.ckpt")) == ref_bytes
    assert [n for n in os.listdir(scratch) if n.startswith("stream_index.")] == \
        ["stream_index.5.ckpt"]


def test_stream_checkpoints_are_the_jax_format(tmp_path, stream):
    """A scratch directory the JAX stream left mid-file resumes in the port
    (its checkpoint and cursor read as written), and the other way."""
    path, seeds = stream
    jscratch, tscratch = str(tmp_path / "j"), str(tmp_path / "t")
    with pytest.raises(_Interrupted):
        jjobs.resumable_extend_from_file("ivf_flat", seeds["ivf_flat"][0], path, BATCH,
                                         scratch=jscratch, checkpoint_every=1,
                                         preempt=_interrupt_at(2))
    got, stats = jobs.resumable_extend_from_file("ivf_flat", _fresh(stream, "ivf_flat"), path,
                                                 BATCH, scratch=jscratch, checkpoint_every=1)
    assert stats["resumed_from_batch"] == 2
    with pytest.raises(_Interrupted):
        jobs.resumable_extend_from_file("ivf_flat", _fresh(stream, "ivf_flat"), path, BATCH,
                                        scratch=tscratch, checkpoint_every=1,
                                        preempt=_interrupt_at(3))
    jgot, jstats = jjobs.resumable_extend_from_file("ivf_flat", seeds["ivf_flat"][0], path,
                                                    BATCH, scratch=tscratch,
                                                    checkpoint_every=1)
    assert jstats["resumed_from_batch"] == 3
    for f in ("slot_rows", "list_sizes", "source_ids"):
        np.testing.assert_array_equal(u.as_np(getattr(got, f)), np.asarray(getattr(jgot, f)))


def test_streaming_flaky_crash_site_retried_by_supervised_runner(tmp_path, stream):
    plan = faults.FaultPlan(
        [faults.Fault(kind="flaky_bootstrap", site="job.stage.crash", count=2)], seed=SEED)
    job = Job("stream", str(tmp_path / "jd"))

    def stage(ctx):
        _, stats = jobs.resumable_extend_from_file("ivf_flat", _fresh(stream, "ivf_flat"),
                                                   stream[0], BATCH, ctx=ctx,
                                                   checkpoint_every=1)
        return stats

    job.add_stage("extend", stage, retries=3)
    with plan.install():
        assert job.run() == {"extend": "ran"}
    assert job.results["extend"]["rows_ingested"] == ROWS
    assert plan.fire_count("job.stage.crash", plan.faults[0]) == 2


def test_streaming_on_batch_times_each_fenced_extend(tmp_path, stream):
    seen = []
    _, stats = jobs.resumable_extend_from_file(
        "ivf_pq", _fresh(stream, "ivf_pq"), stream[0], BATCH, scratch=str(tmp_path),
        on_batch=lambda b, rows, s: seen.append((b, rows, s >= 0.0)))
    assert seen == [(b, BATCH, True) for b in range(ROWS // BATCH)]
    with pytest.raises(ValueError, match="STREAM_KINDS|one of"):
        jobs.resumable_extend_from_file("ivf_nope", None, stream[0], BATCH,
                                        scratch=str(tmp_path))
    assert jobs.STREAM_KINDS == jjobs.STREAM_KINDS


def _mk(seed, dim):
    return worker.make_chunk(seed, dim)


def test_resumable_write_npy_resumes_byte_identical(tmp_path):
    dim, rows, chunk = 4, 20, 3
    one = str(tmp_path / "one.npy")
    jobs.resumable_write_npy(one, rows, dim, chunk, _mk(5, dim), scratch=str(tmp_path / "s1"))
    jone = str(tmp_path / "jone.npy")
    jjobs.resumable_write_npy(jone, rows, dim, chunk, _mk(5, dim), scratch=str(tmp_path / "j1"))
    assert open(one, "rb").read() == open(jone, "rb").read()

    two = str(tmp_path / "two.npy")
    calls = []

    def mk_interrupted(lo, hi):
        if len(calls) == 2:
            raise RuntimeError("preempted mid-synthesis")
        calls.append(lo)
        return _mk(5, dim)(lo, hi)

    with pytest.raises(RuntimeError):
        jobs.resumable_write_npy(two, rows, dim, chunk, mk_interrupted,
                                 scratch=str(tmp_path / "s2"))
    with open(two, "ab") as fh:
        fh.write(b"\xff" * 7)  # a torn tail past the durable marker
    # the JAX package resumes the file the port began
    jjobs.resumable_write_npy(two, rows, dim, chunk, _mk(5, dim), scratch=str(tmp_path / "s2"))
    assert open(one, "rb").read() == open(two, "rb").read()
    np.testing.assert_array_equal(np.load(one), np.load(two))


def test_resumable_write_npy_bad_chunk_leaves_no_file(tmp_path):
    path = str(tmp_path / "bad.npy")
    with pytest.raises(ValueError, match="expected"):
        jobs.resumable_write_npy(path, 20, 4, 3,
                                 lambda lo, hi: np.zeros((hi - lo, 5), dtype=np.float32),
                                 scratch=str(tmp_path / "s"))
    assert not os.path.exists(path)


def test_resumable_write_npy_stale_config_starts_over(tmp_path):
    path = str(tmp_path / "d.npy")
    scratch = str(tmp_path / "s")
    jobs.resumable_write_npy(path, 6, 4, 3, _mk(5, 4), scratch=scratch)
    jobs.resumable_write_npy(path, 9, 4, 3, _mk(5, 4), scratch=scratch)
    assert np.load(path).shape == (9, 4)


# -- kill-and-resume (child-process SIGKILL drills) ---------------------

def _child(args, workdir):
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, WORKER, *args, "--workdir", str(workdir)], env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("kind", u.KINDS)
def test_sigkill_mid_stream_resumes_bit_identical(tmp_path, stream, kind):
    """A child SIGKILLed at the second `job.stage.crash` (after its
    checkpoint commit) leaves a scratch directory the resume carries to a
    saved index byte for byte the uninterrupted run's."""
    _, ref_bytes = _reference(stream, kind, tmp_path)
    kill_dir = tmp_path / "kill"
    kill_dir.mkdir()
    r1 = _child(["stream", "--data", stream[0], "--kind", kind, "--index", stream[1][kind][1],
                 "--kill", "2", "--seed", str(SEED)], kill_dir)
    assert r1.returncode == -signal.SIGKILL, (r1.returncode, r1.stderr[-2000:])
    got, stats = jobs.resumable_extend_from_file(kind, _fresh(stream, kind), stream[0], BATCH,
                                                 scratch=str(kill_dir / "scratch"),
                                                 checkpoint_every=1)
    assert stats["resumed_from_batch"] == 2  # really resumed, not redone
    assert _saved(kind, got, str(kill_dir / "out.ckpt")) == ref_bytes


def test_sigkill_mid_make_data_resumes_byte_identical(tmp_path):
    args = ["datagen", "--rows", "40", "--dim", "6", "--chunk", "8", "--seed", str(SEED)]
    killed = tmp_path / "killed"
    killed.mkdir()
    r1 = _child(args + ["--kill", "2"], killed)
    assert r1.returncode == -signal.SIGKILL, (r1.returncode, r1.stderr[-2000:])
    marker = JobDir.read_json(str(killed / "scratch" / "datagen_progress.json"))
    assert marker and 0 < marker["rows_done"] < 40  # died mid-file
    jobs.resumable_write_npy(str(killed / "data.npy"), 40, 6, 8, _mk(SEED, 6),
                             scratch=str(killed / "scratch"))
    one = str(tmp_path / "one.npy")
    jjobs.resumable_write_npy(one, 40, 6, 8, _mk(SEED, 6), scratch=str(tmp_path / "j"))
    assert open(one, "rb").read() == open(killed / "data.npy", "rb").read()


@pytest.fixture(scope="module")
def scrub_index(tmp_path_factory):
    """A saved port copy of a JAX IVF-Flat index (64 x 8 rows, 8 lists),
    its digest sidecar attached (as a build attaches it)."""
    from raft_tpu_torch.integrity import digest

    data = np.random.default_rng(7).standard_normal((64, 8)).astype(np.float32)
    jidx = u.JMOD["ivf_flat"].build(u.JMOD["ivf_flat"].IndexParams(n_lists=8, kmeans_n_iters=2),
                                    data)
    arrays = {f: np.asarray(getattr(jidx, f)) for f in ivf_flat.INDEX_FIELDS}
    idx = ivf_flat.index_from_arrays(arrays, ivf_flat.IndexParams(n_lists=8), device="cpu")
    digest.attach(idx, "ivf_flat")
    path = str(tmp_path_factory.mktemp("scrub") / "built.ckpt")
    ivf_flat.save(path, idx)
    return path


def test_sigkill_mid_scrub_resumes_from_cursor(tmp_path, scrub_index):
    """A child SIGKILLed at the second `integrity.scrub.crash` (a lap
    boundary: 8 lists, 4-list slices, 2 laps = 4 cursor commits); the walk
    resumes from the committed cursor, scans only the remainder and still
    names the rotted last list."""
    kill = 2
    r1 = _child(["scrub", "--index", scrub_index, "--kill", str(kill), "--seed", str(SEED)],
                tmp_path)
    assert r1.returncode == -signal.SIGKILL, (r1.returncode, r1.stderr[-2000:])
    index = ivf_flat.load(scrub_index, device="cpu")
    rot = worker.rotted("ivf_flat", index, SEED)
    bad, st = jobs.resumable_scrub("ivf_flat", index, scratch=str(tmp_path / "scratch"),
                                   budget_lists=4, laps=2)
    assert st["resumed_at"] == kill * 4
    assert st["lists_scanned"] == 16 - kill * 4  # no committed re-scan
    assert (rot[0], rot[1]) in bad and st["laps"] == 2


# -- the resumable scrub and mutation stages (in-process) ---------------

def test_resumable_scrub_cursor_resume_no_rescan(tmp_path, scrub_index):
    idx = ivf_flat.load(scrub_index, device="cpu")
    d = str(tmp_path)
    _, st = jobs.resumable_scrub("ivf_flat", idx, scratch=d, budget_lists=4, laps=1)
    assert st["laps"] == 1 and st["lists_scanned"] == 8
    bad, st = jobs.resumable_scrub("ivf_flat", idx, scratch=d, budget_lists=4, laps=3)
    assert st["resumed_at"] == 8 and st["lists_scanned"] == 16 and bad == []


def test_resumable_scrub_transient_fault_reentry(tmp_path, scrub_index):
    idx = ivf_flat.load(scrub_index, device="cpu")
    d = str(tmp_path)
    plan = faults.FaultPlan([faults.Fault(kind="flaky_bootstrap", site="integrity.scrub.crash",
                                          count=1)], seed=SEED)
    with plan.install():
        with pytest.raises(faults.FaultInjected):
            jobs.resumable_scrub("ivf_flat", idx, scratch=d, budget_lists=4)
        bad, st = jobs.resumable_scrub("ivf_flat", idx, scratch=d, budget_lists=4)
    assert st["laps"] == 1 and bad == []


def test_resumable_scrub_stale_cursor_restarts_and_matches_jax(tmp_path, scrub_index):
    idx = ivf_flat.load(scrub_index, device="cpu")
    d = str(tmp_path / "t")
    jobs.resumable_scrub("ivf_flat", idx, scratch=d, budget_lists=4, laps=1)
    moved = mutation._clone(mutation.delete(idx, u.as_np(idx.source_ids[:1])))
    moved.mut_cursor = 1  # a commit happened since the cursor was cut
    _, st = jobs.resumable_scrub("ivf_flat", moved, scratch=d, budget_lists=4, laps=1)
    assert st["resumed_at"] == 0 and st["lists_scanned"] == 8
    # the cursor sidecar is the JAX one: the JAX walk of the same index
    # resumes from the port's cursor
    jidx = u.JMOD["ivf_flat"].load(scrub_index)
    d2 = str(tmp_path / "x")
    jobs.resumable_scrub("ivf_flat", idx, scratch=d2, budget_lists=4, laps=1)
    _, jst = jjobs.resumable_scrub("ivf_flat", jidx, scratch=d2, budget_lists=4, laps=2)
    assert jst["resumed_at"] == 8 and jst["lists_scanned"] == 8


def test_resumable_mutate_flaky_reentry_converges(tmp_path, scrub_index):
    idx = ivf_flat.load(scrub_index, device="cpu")
    rng = np.random.default_rng(17)
    ops = [("upsert", rng.standard_normal((4, 8)).astype(np.float32),
            np.array([2, 3, 700, 701])),
           ("delete", np.array([3, 10])),
           ("rebalance",),
           ("upsert", rng.standard_normal((2, 8)).astype(np.float32), np.array([10, 702]))]
    q = rng.standard_normal((9, 8)).astype(np.float32)
    sp = ivf_flat.SearchParams(n_probes=8, engine="query")
    ref, _ = jobs.resumable_mutate("ivf_flat", idx, ops, scratch=str(tmp_path / "ref"),
                                   ckpt_every=2)
    want_v, want_i = ivf_flat.search(sp, ref, q, 5)
    plan = faults.FaultPlan([faults.Fault(kind="flaky_bootstrap", site="mutation.tombstone",
                                          count=1)], seed=SEED)
    scratch = str(tmp_path / "chaos")
    with plan.install():
        with pytest.raises(faults.FaultInjected):
            jobs.resumable_mutate("ivf_flat", idx, ops, scratch=scratch, ckpt_every=2)
        got, stats = jobs.resumable_mutate("ivf_flat", idx, ops, scratch=scratch, ckpt_every=2)
    assert stats["resumed_at"] > 0 and stats["applied"] == len(ops)
    got_v, got_i = ivf_flat.search(sp, got, q, 5)
    u.assert_bitwise(got_v, got_i, want_v, want_i)
    # the JAX stage over the same ops: the same live rows, tombstones and answers
    jidx = u.JMOD["ivf_flat"].load(scrub_index)
    jout, jstats = jjobs.resumable_mutate("ivf_flat", jidx, ops, scratch=str(tmp_path / "jax"),
                                          ckpt_every=2)
    assert {k: jstats[k] for k in ("ops", "applied", "live_rows", "tombstones")} == \
        {k: stats[k] for k in ("ops", "applied", "live_rows", "tombstones")}
    jv, ji = u.JMOD["ivf_flat"].search(u.JMOD["ivf_flat"].SearchParams(n_probes=8,
                                                                        engine="query"),
                                       jout, q, 5)
    u.assert_tie_equal(got_v, got_i, jv, ji)


def test_resumable_mutate_rebalance_only_is_compaction_stage(tmp_path, scrub_index):
    idx = ivf_flat.load(scrub_index, device="cpu")
    dead = mutation.delete(idx, np.arange(12))
    out, stats = jobs.resumable_mutate("ivf_flat", dead, [("rebalance",)],
                                       scratch=str(tmp_path / "s"))
    assert out.tombstones is None and stats["tombstones"] == 0
    assert stats["live_rows"] == mutation.live_rows(dead)
    with pytest.raises(ValueError, match="unknown mutation op"):
        jobs.resumable_mutate("ivf_flat", idx, [("drop",)], scratch=str(tmp_path / "x"))


# -- MNMG: checkpointed distributed build stages ------------------------

@pytest.fixture(scope="module")
def comms4():
    from raft_tpu_torch.comms import Comms

    c = Comms(n_devices=4, device="cpu", timeout_s=60)
    yield c
    c.destroy()


@pytest.fixture(scope="module")
def mnmg_blobs():
    return u.blobs(800)


def test_agreed_on_all_hosts_single_process_passthrough():
    from raft_tpu.jobs.streaming import _agreed_on_all_hosts as jagreed

    from raft_tpu_torch.jobs.streaming import _agreed_on_all_hosts, _process_reduce

    for flag in (True, False):
        assert _agreed_on_all_hosts(flag) is jagreed(flag) is flag
    assert _process_reduce(7, "min") == 7 and _process_reduce(7, "max") == 7


def test_checkpointed_mnmg_build_resumes_via_rehydrate(tmp_path, comms4, mnmg_blobs):
    from raft_tpu_torch.comms import mnmg

    ckpt = str(tmp_path / "mnmg_flat.ckpt")

    def build_fn():
        return mnmg.ivf_flat_build(comms4, ivf_flat.IndexParams(n_lists=8, kmeans_n_iters=4),
                                   mnmg_blobs)

    index, health, resumed = jobs.checkpointed_mnmg_build(comms4, "ivf_flat", build_fn, ckpt)
    assert not resumed and health.coverage() == 1.0
    q = mnmg_blobs[:23]
    v0, i0 = mnmg.ivf_flat_search(index, q, 5, n_probes=8)

    def must_not_build():
        raise AssertionError("resume must skip the build")

    index2, health2, resumed2 = jobs.checkpointed_mnmg_build(comms4, "ivf_flat",
                                                             must_not_build, ckpt)
    assert resumed2 and health2.coverage() == 1.0
    v1, i1 = mnmg.ivf_flat_search(index2, q, 5, n_probes=8)
    u.assert_bitwise(v1, i1, v0, i0)
    with pytest.raises(ValueError, match="unknown MNMG index kind"):
        jobs.checkpointed_mnmg_build(comms4, "ivf_nope", build_fn, str(tmp_path / "x.ckpt"))


def test_resumable_extend_local_interrupt_and_resume(tmp_path, comms4, mnmg_blobs):
    from raft_tpu_torch.comms import mnmg

    path = str(tmp_path / "part.npy")
    np.save(path, np.random.default_rng(3).random((64, 16), dtype=np.float32))
    params = ivf_flat.IndexParams(n_lists=8, kmeans_n_iters=4)

    def fresh():
        return mnmg.ivf_flat_build_local(comms4, params, mnmg_blobs)

    ref, _ = jobs.resumable_extend_local_from_file(
        comms4, "ivf_flat", fresh(), mnmg.ivf_flat_extend_local, path, 16,
        scratch=str(tmp_path / "ref_scr"), ckpt_path=str(tmp_path / "ref.ckpt"),
        checkpoint_every=1)
    q = mnmg_blobs[:23]
    v0, i0 = mnmg.ivf_flat_search(ref, q, 5, n_probes=8)
    scratch = str(tmp_path / "scr")
    ckpt = str(tmp_path / "mn.ckpt")
    with pytest.raises(_Interrupted):
        jobs.resumable_extend_local_from_file(
            comms4, "ivf_flat", fresh(), mnmg.ivf_flat_extend_local, path, 16,
            scratch=scratch, ckpt_path=ckpt, checkpoint_every=1, preempt=_interrupt_at(2))
    got, stats = jobs.resumable_extend_local_from_file(
        comms4, "ivf_flat", fresh(), mnmg.ivf_flat_extend_local, path, 16, scratch=scratch,
        ckpt_path=ckpt, checkpoint_every=1)
    assert stats["resumed_from_batch"] == 2 and stats["batches"] == 2
    v1, i1 = mnmg.ivf_flat_search(got, q, 5, n_probes=8)
    u.assert_bitwise(v1, i1, v0, i0)


# -- obs.report: the job timeline section, and the package surface ------

def test_job_timeline_and_retry_render_sections():
    snap = {
        "metrics": {"counters": {}, "gauges": {}, "histograms": {}},
        "events": [
            {"kind": "job", "seq": 1, "t": 10.0, "job": "b100m", "stage": "make_data",
             "action": "start", "fingerprint": "ab12cd34"},
            {"kind": "retry", "seq": 2, "t": 10.5, "describe": "job.b100m.make_data",
             "attempt": 1, "max_retries": 2, "delay_s": 0.05, "error": "X"},
            {"kind": "job", "seq": 3, "t": 11.0, "job": "b100m", "stage": "make_data",
             "action": "commit", "fingerprint": "ab12cd34"},
        ],
    }
    out = obs_report.render(snap, title="pinned jobs")
    from raft_tpu.obs import report as jreport

    assert out == jreport.render(snap, title="pinned jobs")
    assert "## Job timeline (stage transitions; last 80)" in out
    assert "b100m.make_data" in out and "commit" in out and "attempt=1" in out


def test_jobs_exports_the_jax_all():
    assert jobs.__all__ == jjobs.__all__
    from raft_tpu_torch.jobs import runner, streaming, watchdog

    assert (runner.PREEMPT_SITE, streaming.STREAM_CRASH_SITE, watchdog.HEARTBEAT_SITE) == (
        "job.preempt", "job.stage.crash", "job.heartbeat.stall")
    assert json.loads(json.dumps(jobs.STREAM_KINDS)) == list(jjobs.STREAM_KINDS)
