"""The port's communicator (raft_tpu_torch/comms/comms.py) against the JAX
`Comms` on the 8 virtual CPU devices of tests/conftest.py: 8 in-process
CPU ranks and the JAX mesh run the same collectives on the same numpy
inputs (made from seeds).

- Every collective of `tests/test_comms.py` and its self-tests: allreduce
  SUM / MAX / MIN / PROD, bcast and reduce at nonzero roots, allgather
  (new axis, axis 1, tiled), allgatherv, gather, gatherv, reducescatter
  SUM / MIN / MAX / PROD, shift, device_sendrecv, multicast, barrier.
  Integer payloads and integer-valued f32 payloads (exact in any order)
  equal the JAX outputs bit for bit, dtypes included.
- PROD on 5,000 floats (the log-space planes): zeros and signs exactly
  as JAX's, magnitudes within 2e-4 relative (the JAX test's bound).
- comm_split: equal and unequal groups, both grouped schedules (ring and
  planes) forced through the tuned key, bit for bit against JAX (SUM,
  MIN, MAX, bcast, reduce, allgather) and against the numpy oracle (PROD,
  reducescatter, shift).
- The guards raise as JAX's do; a rank that raises ends `run` with its
  own error, a missed collective raises `HealthCheckTimeout` by its
  deadline; `obs.collective` counters after one call equal the JAX
  counters after its first (tracing) call; a dropped allreduce
  contribution equals JAX's.
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from raft_tpu import obs as jobs
from raft_tpu.comms import Comms as JComms
from raft_tpu.comms import op_t as jop
from raft_tpu.core import faults as jfaults
from raft_tpu_torch import Resources, obs as tobs
from raft_tpu_torch.comms import Comms, init_comms, local_handle, op_t
from raft_tpu_torch.comms import comms as comms_mod
from raft_tpu_torch.comms.comms import P, CommsAborted
from raft_tpu_torch.comms.resilience import HealthCheckTimeout
from raft_tpu_torch.core import faults as tfaults
from raft_tpu_torch.core import tuned as ttuned

WORLD = 8
SEED = 1234


@pytest.fixture(scope="module")
def jc():
    return JComms()


@pytest.fixture(scope="module")
def tc():
    c = Comms(n_devices=WORLD, device="cpu", timeout_s=60)
    yield c
    c.destroy()


def _jax_run(jc, body, *arrays):
    out = jax.shard_map(body, mesh=jc.mesh, in_specs=tuple(JP("data") for _ in arrays),
                        out_specs=JP("data"), check_vma=False)(*arrays)
    return [np.asarray(o) for o in out]


def _port_run(tc, body, *arrays, **kw):
    out = tc.run(body, *arrays, in_specs=tuple(P("data") for _ in arrays),
                 out_specs=tuple(P("data") for _ in range(kw.pop("n_out"))), **kw)
    return [o.numpy() for o in out]


def _data():
    rng = np.random.default_rng(7)
    xf = rng.integers(-5, 6, (WORLD, 16)).astype(np.float32)
    xi = rng.integers(-5, 6, (WORLD, 16)).astype(np.int32)
    xi[xi == 0] = 1
    return xf, xi


COUNTS = list(range(1, WORLD + 1))
DESTS = [[(i + 1) % WORLD, (i + 3) % WORLD] for i in range(WORLD)]
PERM = [(0, 1), (1, 0), (2, 5), (6, 6)]


def _jax_body(ac):
    def body(xf, xi):
        f, i = xf[0], xi[0]
        outs = [
            ac.allreduce(f, jop.SUM), ac.allreduce(f, jop.MAX), ac.allreduce(f, jop.MIN),
            ac.allreduce(i, jop.SUM), ac.allreduce(i, jop.PROD), ac.allreduce(f[:4], jop.PROD),
            ac.bcast(f, root=3), ac.reduce(f, root=5), ac.reduce(i, root=0, op=jop.MAX),
            ac.allgather(f).reshape(-1), ac.allgather(f.reshape(4, 4), axis=1).reshape(-1),
            ac.allgather(f, tiled=True),
            ac.allgatherv(f.reshape(8, 2), COUNTS).reshape(-1),
            ac.gather(i, root=2).reshape(-1),
            ac.gatherv(f.reshape(8, 2), COUNTS, root=6).reshape(-1),
            ac.reducescatter(f, jop.SUM), ac.reducescatter(f, jop.MIN),
            ac.reducescatter(f, jop.MAX), ac.reducescatter(i, jop.PROD),
            ac.shift(f, 1), ac.shift(i, -3), ac.device_sendrecv(f, PERM),
            ac.device_multicast_sendrecv(f, DESTS), ac.barrier(),
            ac.get_rank().astype(jnp.int32),
        ]
        return tuple(o[None] for o in outs)

    return body


def _port_body(ac, xf, xi):
    f, i = xf[0], xi[0]
    outs = [
        ac.allreduce(f, op_t.SUM), ac.allreduce(f, op_t.MAX), ac.allreduce(f, op_t.MIN),
        ac.allreduce(i, op_t.SUM), ac.allreduce(i, op_t.PROD), ac.allreduce(f[:4], op_t.PROD),
        ac.bcast(f, root=3), ac.reduce(f, root=5), ac.reduce(i, root=0, op=op_t.MAX),
        ac.allgather(f).reshape(-1), ac.allgather(f.reshape(4, 4), axis=1).reshape(-1),
        ac.allgather(f, tiled=True),
        ac.allgatherv(f.reshape(8, 2), COUNTS).reshape(-1),
        ac.gather(i, root=2).reshape(-1),
        ac.gatherv(f.reshape(8, 2), COUNTS, root=6).reshape(-1),
        ac.reducescatter(f, op_t.SUM), ac.reducescatter(f, op_t.MIN),
        ac.reducescatter(f, op_t.MAX), ac.reducescatter(i, op_t.PROD),
        ac.shift(f, 1), ac.shift(i, -3), ac.device_sendrecv(f, PERM),
        ac.device_multicast_sendrecv(f, DESTS), ac.barrier(),
        torch.tensor(ac.get_rank(), dtype=torch.int32),
    ]
    return tuple(o[None] for o in outs)


N_OUT = 25


def _comms_counters(reg):
    """The comms counters a call moved (a registry keeps the names of
    instruments earlier tests made, at zero, across `reset()`)."""
    return {k: v for k, v in reg.snapshot()["counters"].items()
            if k.startswith("comms.") and v}


@pytest.fixture(scope="module")
def collective_outputs(jc, tc):
    """Both packages' outputs and obs counters for one call of the body."""
    xf, xi = _data()
    jobs.enable()
    tobs.enable()
    try:
        jobs.reset()
        jout = _jax_run(jc, _jax_body(jc.comms), xf, xi)
        jcount = _comms_counters(jobs.registry())
        tobs.reset()
        tout = _port_run(tc, _port_body, xf, xi, n_out=N_OUT)
        tcount = _comms_counters(tobs.registry())
    finally:
        jobs.disable()
        jobs.reset()
        tobs.disable()
        tobs.reset()
    return jout, tout, jcount, tcount


def test_init_and_handle_injection():
    res = Resources(device="cpu")
    c = init_comms(res, n_devices=WORLD, device="cpu")
    assert res.comms_initialized()
    assert local_handle(res) is c
    assert c.get_size() == WORLD and c.comms.get_size() == WORLD
    assert c.nccl_initialized and not c.spans_processes()
    c.destroy()
    assert not c.nccl_initialized


@pytest.mark.parametrize("idx", range(N_OUT))
def test_collectives_equal_jax(collective_outputs, idx):
    jout, tout = collective_outputs[0][idx], collective_outputs[1][idx]
    assert jout.dtype == tout.dtype, idx
    assert jout.shape == tout.shape, idx
    np.testing.assert_array_equal(tout, jout)


def test_collective_counters_equal_jax_after_one_call(collective_outputs):
    """The port counts each collective once a call on rank 0; JAX counts
    at trace time: one call of each equals the other."""
    jcount, tcount = collective_outputs[2], collective_outputs[3]
    assert jcount and tcount == jcount


def test_allreduce_prod_large_array(jc, tc):
    """The O(1)-memory log-space PROD (size > 4096) with a zero and
    negatives: zeros and signs exact, magnitudes within 2e-4."""
    rng = np.random.default_rng(0)
    x = rng.uniform(0.5, 2.0, size=(WORLD, 5000)).astype(np.float32)
    x[1, 0] = 0.0
    x[2, 1] *= -1.0
    x[5, 1] *= -1.0
    x[4, 2] *= -1.0
    jac = jc.comms
    (jout,) = _jax_run(jc, lambda s: (jac.allreduce(s[0], jop.PROD)[None],), x)
    (tout,) = _port_run(tc, lambda ac, s: (ac.allreduce(s[0], op_t.PROD)[None],), x, n_out=1)
    want = np.prod(x, axis=0)
    for r in range(WORLD):
        np.testing.assert_array_equal(tout[r], tout[0])
    np.testing.assert_array_equal(np.sign(tout[0]), np.sign(jout[0]))
    np.testing.assert_allclose(tout[0], want, rtol=2e-4)
    np.testing.assert_allclose(tout[0], jout[0], rtol=2e-4)
    assert tout[0, 0] == 0.0 and tout[0, 1] > 0 and tout[0, 2] < 0


COLORS = [0, 1, 1, 2, 2, 2, 2, 3]  # ragged: sizes 1, 2, 4, 1


def _groups(colors):
    groups = {}
    for r, c in enumerate(colors):
        groups.setdefault(c, []).append(r)
    return list(groups.values())


def _grouped_data():
    rng = np.random.default_rng(5)
    xf = rng.integers(-9, 10, (WORLD, 16)).astype(np.float32)
    xi = rng.integers(-3, 4, (WORLD, 16)).astype(np.int32)
    return xf, xi


@pytest.fixture(scope="module")
def grouped_jax(jc):
    """The JAX grouped program's outputs (its default schedule; on
    integer-valued floats every schedule gives these bits)."""
    jac = jc.comms

    def jbody(xf, xi):
        sub = jac.comm_split(COLORS)
        f = xf[0]
        return tuple(o[None] for o in (
            sub.allreduce(f, jop.SUM), sub.allreduce(f, jop.MIN), sub.allreduce(f, jop.MAX),
            sub.bcast(f, root=0), sub.reduce(f, root=0, op=jop.SUM), sub.allgather(f, axis=0)))

    return _jax_run(jc, jbody, *_grouped_data())


@pytest.mark.parametrize("schedule", ["ring", "planes"])
def test_grouped_schedules_equal_jax(grouped_jax, tc, schedule, monkeypatch):
    """Both grouped-reduce schedules (forced through the tuned key), ragged
    groups and size-1 groups: JAX's outputs bit for bit (integer-valued
    floats), the rest against the per-group numpy oracle."""
    monkeypatch.setattr(ttuned, "applies", lambda device: True)
    monkeypatch.setattr(ttuned, "get", lambda key, default=None:
                        schedule if key == "grouped_reduce_schedule" else default)
    xf, xi = _grouped_data()
    m = 4

    def tbody(ac, xf, xi):
        sub = ac.comm_split(COLORS)
        assert sub._grouped_schedule() == schedule
        f, i = xf[0], xi[0]
        return tuple(o[None] for o in (
            sub.allreduce(f, op_t.SUM), sub.allreduce(f, op_t.MIN), sub.allreduce(f, op_t.MAX),
            sub.bcast(f, root=0), sub.reduce(f, root=0, op=op_t.SUM), sub.allgather(f, axis=0),
            sub.allreduce(i, op_t.PROD), sub.reducescatter(f, op_t.SUM),
            sub.reducescatter(f, op_t.MIN), sub.shift(f, 1),
            torch.tensor(sub.get_size()), torch.tensor(sub.get_rank())))

    tout = _port_run(tc, tbody, xf, xi, n_out=12)
    for a, b in zip(grouped_jax, tout[:6]):
        np.testing.assert_array_equal(b, a)
    per = 4 * m // m
    for g in _groups(COLORS):
        for pos, r in enumerate(g):
            np.testing.assert_array_equal(tout[6][r], np.prod(xi[g], 0))
            sl = slice(pos * per, (pos + 1) * per)
            np.testing.assert_array_equal(tout[7][r], xf[g].sum(0)[sl])
            np.testing.assert_array_equal(tout[8][r], xf[g].min(0)[sl])
            np.testing.assert_array_equal(tout[9][r], xf[g[(pos - 1) % len(g)]])
            assert tout[10][r] == len(g) and tout[11][r] == pos


def test_comm_split_equal_groups(tc):
    """Even / odd split: a grouped SUM is the group size, the ring shift
    stays in the group (rank - 2 mod n), per the self-test."""
    colors = [r % 2 for r in range(WORLD)]

    def body(ac):
        sub = ac.comm_split(colors)
        rank = float(ac.get_rank())
        return (sub.allreduce(torch.ones(())).reshape(1),
                sub.shift(torch.tensor(rank), offset=1).reshape(1))

    s, got = tc.run(body, in_specs=(), out_specs=(P("data"), P("data")))
    assert s.tolist() == [WORLD // 2] * WORLD
    assert got.tolist() == [float((r - 2) % WORLD) for r in range(WORLD)]


def test_reducescatter_minmax_equal_jax(jc, tc):
    rng = np.random.default_rng(9)
    x = rng.standard_normal((WORLD, 3 * WORLD)).astype(np.float32)
    jac = jc.comms
    jout = _jax_run(jc, lambda x: (jac.reducescatter(x[0], jop.MIN)[None],
                                   jac.reducescatter(x[0], jop.MAX)[None]), x)
    tout = _port_run(tc, lambda ac, x: (ac.reducescatter(x[0], op_t.MIN)[None],
                                        ac.reducescatter(x[0], op_t.MAX)[None]), x, n_out=2)
    for a, b in zip(jout, tout):
        np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("case", ["allgatherv_extent", "allgatherv_counts", "reducescatter",
                                  "comm_split"])
def test_guards_raise_as_jax(tc, case):
    def body(ac):
        if case == "allgatherv_extent":
            return ac.allgatherv(torch.ones((2, 3)), counts=[3] * WORLD)
        if case == "allgatherv_counts":
            return ac.allgatherv(torch.ones((8, 2)), counts=[1, 2, 3])
        if case == "reducescatter":
            return ac.reducescatter(torch.ones((WORLD + 1,)))
        return ac.comm_split([0, 1])

    match = {"allgatherv_extent": "max.counts.", "allgatherv_counts": "len.counts.",
             "reducescatter": "not divisible", "comm_split": "one color per rank"}[case]
    with pytest.raises(ValueError, match=match):
        tc.run(body, in_specs=(), out_specs=P())


def test_a_raising_rank_ends_run_with_its_error(tc):
    """Rank 3 raises before the collective the others wait in: `run`
    re-raises rank 3's error promptly instead of waiting out the deadline,
    and the session runs again afterwards."""
    def body(ac):
        if ac.get_rank() == 3:
            raise KeyError("rank three failed")
        return ac.allreduce(torch.ones(()))

    t0 = time.monotonic()
    with pytest.raises(KeyError, match="rank three failed"):
        tc.run(body, in_specs=(), out_specs=P(), timeout_s=60.0)
    assert time.monotonic() - t0 < 10.0
    assert float(tc.run(lambda ac: ac.allreduce(torch.ones(())), in_specs=(),
                        out_specs=P())) == WORLD


def test_a_missed_collective_raises_health_check_timeout(tc):
    """Rank 0 never joins the allreduce: the others give up at the
    deadline with HealthCheckTimeout (no hang)."""
    def body(ac):
        if ac.get_rank() == 0:
            return torch.zeros(())
        return ac.allreduce(torch.ones(()))

    t0 = time.monotonic()
    with pytest.raises(HealthCheckTimeout):
        tc.run(body, in_specs=(), out_specs=P(), timeout_s=0.3)
    assert time.monotonic() - t0 < 10.0
    assert issubclass(CommsAborted, RuntimeError)


def test_dropped_allreduce_contribution_equals_jax(jc, tc):
    """drop_collective at comms.allreduce on rank 3: its contribution is
    the identity on every call, as in the JAX program."""
    x = np.arange(1.0, WORLD * 4 + 1, dtype=np.float32).reshape(WORLD, 4)
    jac = jc.comms

    def jbody(x):
        return (jac.allreduce(x[0], jop.SUM)[None], jac.allreduce(x[0], jop.MIN)[None])

    def tbody(ac, x):
        return (ac.allreduce(x[0], op_t.SUM)[None], ac.allreduce(x[0], op_t.MIN)[None])

    jplan = jfaults.FaultPlan([jfaults.Fault(kind="drop_collective", site="comms.allreduce",
                                             rank=3)], seed=SEED)
    tplan = tfaults.FaultPlan([tfaults.Fault(kind="drop_collective", site="comms.allreduce",
                                             rank=3)], seed=SEED)
    with jplan.install():
        jout = _jax_run(jc, jbody, x)
    with tplan.install():
        tout = _port_run(tc, tbody, x, n_out=2)
        again = _port_run(tc, tbody, x, n_out=2)
    for a, b, c in zip(jout, tout, again):
        np.testing.assert_array_equal(b, a)
        np.testing.assert_array_equal(c, a)
    assert tout[0][0, 0] == x.sum(0)[0] - x[3, 0]


def test_host_p2p_stubs_point_at_device_sendrecv():
    ac = Comms(n_devices=2, device="cpu", timeout_s=60).comms
    for name in ("isend", "irecv", "waitall", "group_start", "group_end"):
        with pytest.raises(NotImplementedError, match="Comms.run"):
            getattr(ac, name)()
    with pytest.raises(RuntimeError, match="inside Comms.run"):
        ac.allreduce(torch.ones(()))


def test_shard_and_replicate_place_blocks_per_rank(tc):
    x = np.arange(WORLD * 6, dtype=np.float32).reshape(WORLD * 2, 3)
    sh = tc.shard(x)
    assert sh.shape == x.shape and len(sh.blocks) == WORLD
    np.testing.assert_array_equal(sh.full().numpy(), x)
    rep = tc.replicate(x)
    assert rep.shape == x.shape and len(rep.copies) == 1  # one device, one copy
    with pytest.raises(ValueError, match="equal blocks"):
        tc.shard(np.ones((WORLD + 1, 2), np.float32))


def test_default_world_needs_a_card(monkeypatch):
    """The default world is every visible CUDA device; without a card it
    raises, as core.config.resolve_device does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Comms()
    with pytest.raises(RuntimeError):
        Comms(n_devices=2, device="cuda")


def test_bootstrap_is_idempotent_and_retries(monkeypatch):
    """The bootstrap retry (flaky comms.bootstrap plan: two injected
    failures, then one real init) and idempotence, with the process-group
    init stubbed."""
    calls = {"n": 0}
    monkeypatch.setattr(comms_mod, "_init_process_group",
                        lambda **kw: calls.__setitem__("n", calls["n"] + 1))
    monkeypatch.setattr(comms_mod, "_MULTIHOST_INITIALIZED", False)
    monkeypatch.setattr(comms_mod, "_PROCESS_STATE", {})
    plan = tfaults.FaultPlan([tfaults.Fault(kind="flaky_bootstrap", site="comms.bootstrap",
                                            count=2)], seed=SEED)
    with plan.install():
        assert comms_mod.bootstrap_multihost(backoff_s=0.01, device="cpu") is True
    assert calls["n"] == 1
    assert plan.fire_count("comms.bootstrap", plan.faults[0]) == 2
    assert comms_mod.bootstrap_multihost() is False


def test_bootstrap_multihost_defaults_to_the_card(monkeypatch):
    """With no device, a fresh bootstrap asks for cuda:LOCAL_RANK; without
    a card that raises before any process group starts (a CPU world is
    asked for with device="cpu"), as `core.config.resolve_device` does."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default lands there")
    calls = {"n": 0}
    monkeypatch.setattr(comms_mod, "_init_process_group",
                        lambda **kw: calls.__setitem__("n", calls["n"] + 1))
    monkeypatch.setattr(comms_mod, "_MULTIHOST_INITIALIZED", False)
    monkeypatch.setattr(comms_mod, "_PROCESS_STATE", {})
    monkeypatch.setattr(comms_mod, "_process_world_active", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        comms_mod.bootstrap_multihost(backoff_s=0.01)
    assert calls["n"] == 0


def test_exchange_under_fast_thread_switching(tc):
    """200 allreduces and ring shifts on 8 rank threads while the
    interpreter switches threads as often as it can: every result holds,
    so no deposit is read before it is made or after it is replaced."""
    import sys

    def body(ac):
        r = ac.get_rank()
        ok = True
        for i in range(200):
            ok &= float(ac.allreduce(torch.tensor(float(r + i)))) == WORLD * i + 28
            ok &= float(ac.shift(torch.tensor(float(r * 1000 + i)))) == ((r - 1) % WORLD) * 1000 + i
        return torch.tensor(ok)[None]

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t0 = time.monotonic()
        got = tc.run(body, in_specs=(), out_specs=P("data"), timeout_s=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert bool(got.all()) and time.monotonic() - t0 < 60


def test_threads_share_one_pool_per_session(tc):
    """The rank threads are a pool that lives as long as the session."""
    def names(ac):
        return threading.current_thread().name

    first = tc.run(names, in_specs=(), out_specs=P())
    second = tc.run(names, in_specs=(), out_specs=P())
    assert first.startswith("raft-comms-rank") and second.startswith("raft-comms-rank")
    assert tc._pool is not None and tc._pool._max_workers == WORLD


def test_runs_from_several_threads_take_turns(tc):
    """Four threads run collectives on one in-process world at once: the
    runs take turns (each answers within seconds, where runs that shared
    the pool's R threads would each hold some ranks at a barrier while
    their other ranks queued, until the deadline), and the world's
    `timeout_s` is the default deadline of its runs."""
    def body(ac):
        time.sleep(0.02)
        return ac.allreduce(torch.ones(()) * (ac.get_rank() + 1))

    out, errors = [], []
    start = threading.Barrier(4)

    def go():
        start.wait(timeout=30.0)  # all four runs begin together
        try:
            out.append(float(tc.run(body, in_specs=(), out_specs=P(), timeout_s=30.0)))
        except Exception as e:  # the thread's boundary: reported by the assert below
            errors.append(e)

    import sys

    threads = [threading.Thread(target=go) for _ in range(4)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)  # the runs' submits interleave in the pool's queue
    try:
        t0 = time.monotonic()
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors and out == [WORLD * (WORLD + 1) / 2] * 4
    assert time.monotonic() - t0 < 20.0
    assert tc.timeout_s == 60.0


def test_a_run_waiting_past_its_deadline_for_another_raises(tc):
    """A run that waits for another thread's run of the same world longer
    than its own deadline raises HealthCheckTimeout instead of waiting on."""
    started = threading.Event()

    def slow(ac):
        started.set()
        time.sleep(1.0)
        return ac.allreduce(torch.ones(()))

    t = threading.Thread(target=lambda: tc.run(slow, in_specs=(), out_specs=P()))
    t.start()
    try:
        assert started.wait(timeout=30.0)
        with pytest.raises(HealthCheckTimeout, match="another run"):
            tc.run(lambda ac: ac.allreduce(torch.ones(())), in_specs=(), out_specs=P(),
                   timeout_s=0.2)
    finally:
        t.join(timeout=60.0)
    assert not t.is_alive()
    assert float(tc.run(lambda ac: ac.allreduce(torch.ones(())), in_specs=(),
                        out_specs=P())) == WORLD
