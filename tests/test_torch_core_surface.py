"""PyTorch port: the core surface and the helpers around it, on the CPU:
`core.operators` against the JAX operators, `util` against the JAX
`util`, `Resources` (device, generator stream, registry, comms, sync),
`device_ndarray`, the `mdarray` factories, `interruptible` (cancel and
timeout on pending waitables), the logger's callback sink, `trace_range`
in a CPU profiler trace, output conversion through
`auto_convert_output`, and the validation helpers.
"""

import importlib
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import raft_tpu.core.operators as jop
import raft_tpu.util as jutil
import raft_tpu_torch.core as tcore
import raft_tpu_torch.core.operators as top
import raft_tpu_torch.util as tutil
from raft_tpu_torch.core import interruptible, tracing
from raft_tpu_torch.core.interruptible import InterruptedException, TimeoutException


# -- operators ---------------------------------------------------------------

A = np.array([-2.0, 0.0, 1.5, 3.0], np.float32)
B = np.array([1.0, 0.0, -1.5, 2.0], np.float32)

UNARY = ["identity_op", "sq_op", "abs_op", "nz_op"]
BINARY = ["add_op", "sub_op", "mul_op", "min_op", "max_op", "equal_op", "notequal_op"]


def test_operator_vocabulary_is_the_jax_one():
    assert top.__all__ == jop.__all__
    for name in top.__all__:
        assert callable(getattr(top, name)), name


@pytest.mark.parametrize("name", UNARY + ["sqrt_op"])
def test_unary_ops(name):
    x = np.abs(A) if name == "sqrt_op" else A
    got = getattr(top, name)(torch.as_tensor(x))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(getattr(jop, name)(jnp.asarray(x))))


@pytest.mark.parametrize("name", BINARY + ["div_op", "pow_op", "mod_op"])
def test_binary_ops(name):
    a, b = (np.abs(A) + 1, B + 3) if name in ("div_op", "pow_op", "mod_op") else (A, B)
    got = getattr(top, name)(torch.as_tensor(a), torch.as_tensor(b))
    want = getattr(jop, name)(jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6)


def test_structural_ops_and_key_value_pairs():
    kv = top.KeyValuePair
    a = kv(torch.tensor([0, 5]), torch.tensor([3.0, 1.0]))
    b = kv(torch.tensor([1, 2]), torch.tensor([2.0, 1.0]))
    assert top.argmin_op(a, b).key.tolist() == [1, 2]  # equal values: the smaller key
    assert top.argmax_op(a, b).key.tolist() == [0, 2]
    assert top.key_op(a) is a.key and top.value_op(a) is a.value
    assert float(top.compose_op(top.sqrt_op, top.sq_op)(torch.tensor(-4.0))) == 4.0
    assert top.cast_op(torch.int32)(torch.tensor(3.7)).dtype == torch.int32
    assert top.const_op(7)(123) == 7 and top.void_op(1, 2) is None
    f = top.map_args_op(top.add_op, top.sq_op, top.abs_op)
    assert float(f(torch.tensor(3.0), torch.tensor(-2.0))) == 11.0
    from raft_tpu_torch.linalg import reduce

    x = np.arange(12, dtype=np.float32).reshape(3, 4)
    r = reduce(x, axis=1, main_op=top.sq_op, final_op=top.sqrt_op, device="cpu")
    np.testing.assert_allclose(r.numpy(), np.linalg.norm(x, axis=1), rtol=1e-6)


# -- util --------------------------------------------------------------------


@pytest.mark.parametrize("v", [1, 2, 3, 31, 32, 33, 1000, 1 << 20])
def test_integer_helpers_match_jax(v):
    for name in ("next_pow2", "prev_pow2", "is_pow2"):
        assert getattr(tutil, name)(v) == getattr(jutil, name)(v), name
    for m in (1, 8, 128):
        assert tutil.ceil_div(v, m) == jutil.ceil_div(v, m)
        assert tutil.round_up_safe(v, m) == jutil.round_up_safe(v, m)
        assert tutil.round_down_safe(v, m) == jutil.round_down_safe(v, m)


def test_pow2_lru_and_sieve():
    assert tutil.__all__ == jutil.__all__
    p, q = tutil.Pow2(64), jutil.Pow2(64)
    for x in (0, 1, 63, 64, 65, 1000):
        assert (p.quot(x), p.rem(x), p.round_up(x), p.round_down(x), p.is_aligned(x)) == \
            (q.quot(x), q.rem(x), q.round_up(x), q.round_down(x), q.is_aligned(x))
    assert tutil.log2_int(1024) == 10
    with pytest.raises(ValueError):
        tutil.Pow2(48)
    c = tutil.LRUCache(2)
    c.put("a", 1)
    c.put("b", 2)
    assert c.get("a") == 1
    c.put("c", 3)  # evicts b, the least recently used
    assert "b" not in c and len(c) == 2 and c.hits == 1 and c.misses == 0
    assert list(tutil.Sieve(100).primes()) == list(jutil.Sieve(100).primes())
    assert tutil.Sieve(97).is_prime(97) and not tutil.Sieve(97).is_prime(91)


# -- Resources, device_ndarray, mdarray ---------------------------------------


def test_resources_device_keys_registry_and_comms():
    r = tcore.Resources(device="cpu", seed=1)
    assert r.device == torch.device("cpu")
    k1, k2 = r.new_key(), r.new_key()
    assert isinstance(k1, torch.Generator) and k1.device.type == "cpu"
    assert not torch.equal(torch.rand(8, generator=k1), torch.rand(8, generator=k2))
    r2 = tcore.Resources(device="cpu", seed=1)
    assert torch.equal(torch.rand(8, generator=r2.new_key()),
                       torch.rand(8, generator=tcore.Resources(device="cpu", seed=1).new_key()))
    calls = []
    r.add_resource_factory("thing", lambda: calls.append(1) or {"x": 1})
    assert r.has_resource("thing") and r.get_resource("thing")["x"] == 1
    r.get_resource("thing")
    assert len(calls) == 1
    with pytest.raises(KeyError):
        r.get_resource("missing")
    assert not r.comms_initialized()
    with pytest.raises(RuntimeError):
        r.get_comms()
    r.set_comms("fake-comms")
    r.set_sub_comms("tp", "sub")
    r3 = r.with_mesh("mesh")
    assert r3.get_comms() == "fake-comms" and r3.get_sub_comms("tp") == "sub"
    assert r3.mesh == "mesh" and r.mesh is None
    with pytest.raises(RuntimeError):
        r.get_sub_comms("dp")
    r.track(torch.ones(3))
    r.sync()


def test_auto_sync_resources():
    seen = {}

    @tcore.auto_sync_resources
    def f(x, resources=None):
        seen["res"] = resources
        return x + 1

    assert f(1, resources=tcore.Resources(device="cpu")) == 2
    assert seen["res"].device.type == "cpu"


def test_device_ndarray_and_mdarray():
    x = np.random.default_rng(0).random((4, 5), dtype=np.float32)
    d = tcore.device_ndarray(x, device="cpu")
    assert d.shape == (4, 5) and d.dtype == np.float32 and len(d) == 4 and d.ndim == 2
    np.testing.assert_array_equal(d.copy_to_host(), x)
    np.testing.assert_array_equal(np.asarray(d), x)
    assert not hasattr(d, "__cuda_array_interface__")  # a CPU tensor has none
    t = torch.arange(6.0).reshape(2, 3)
    assert tcore.device_ndarray(t).array.data_ptr() == t.data_ptr()
    assert tcore.device_ndarray.from_tensor(t).array is t
    z = tcore.device_ndarray.zeros((2, 2), dtype=np.int32, device="cpu")
    assert z.dtype == np.int32 and not z.copy_to_host().any()
    m = tcore.make_device_matrix(2, 3, device="cpu")
    assert m.shape == (2, 3) and m.dtype == torch.float32 and not m.any()
    assert tcore.make_device_vector(4, dtype=torch.int32, device="cpu").dtype == torch.int32
    assert float(tcore.make_device_scalar(2.5, device="cpu")) == 2.5
    assert tcore.make_host_matrix(2, 2).shape == (2, 2)
    assert tcore.make_host_vector(3, np.int8).dtype == np.int8
    assert tcore.make_device_matrix_view(t, (3, 2)).shape == (3, 2)
    with pytest.raises(ValueError):
        tcore.make_device_matrix_view(torch.zeros(4))
    assert tcore.make_device_vector_view(np.zeros(4), device="cpu").shape == (4,)
    with pytest.raises(ValueError):
        tcore.make_device_vector_view(t)


def test_validation_helpers():
    with pytest.raises(ValueError):
        tcore.check_matrix(np.zeros(3), device="cpu")
    with pytest.raises(ValueError, match="dtype"):
        tcore.check_array(np.zeros((2, 2), np.int16), dtypes=[np.float32], device="cpu")
    out = tcore.check_array(torch.zeros((2, 2)), dtypes=[np.float32, torch.float16], ndim=2)
    assert out.shape == (2, 2)
    assert tcore.check_vector(np.zeros(3, np.float32), device="cpu").ndim == 1
    w = tcore.cai_wrapper(torch.zeros((3, 2)).T)
    assert w.shape == (2, 3) and w.dtype == np.float32 and not w.c_contiguous
    assert w.validate_shape_dtype(2, np.float32) is w
    with pytest.raises(ValueError):
        w.validate_shape_dtype(expected_dtype=np.int32)


# -- interruptible -----------------------------------------------------------


class _Pending:
    """A waitable that never completes (an event whose work is stuck)."""

    def query(self):
        return False


def test_synchronize_cancel_before_and_mid_wait():
    tid = threading.get_ident()
    tcore.cancel(tid)
    with pytest.raises(InterruptedException):
        tcore.synchronize()
    tcore.synchronize(torch.ones(3))  # the flag cleared; CPU tensors are ready
    t = threading.Timer(0.05, tcore.cancel, args=(tid,))
    t.start()
    try:
        with pytest.raises(InterruptedException):
            tcore.synchronize(_Pending(), timeout_s=10, poll_interval_s=0.005)
    finally:
        t.join()
    tcore.synchronize()


def test_synchronize_timeout():
    t0 = time.monotonic()
    with pytest.raises(TimeoutException, match="timeout_s=0.1"):
        tcore.synchronize(_Pending(), timeout_s=0.1, poll_interval_s=0.005)
    assert time.monotonic() - t0 >= 0.1
    tcore.synchronize(np.zeros(1), timeout_s=0.001)
    with interruptible.interruptible():
        tcore.cancel(threading.get_ident())
    tcore.synchronize()  # the scope cleared the stale flag


# -- logger, tracing, output conversion ---------------------------------------


def test_logger_callback_sink():
    lg = importlib.import_module("raft_tpu_torch.core.logger")
    assert tcore.logger is lg.logger and lg.logger.name == "raft_tpu_torch"
    records, flushes = [], []
    lg.set_callback(lambda lvl, msg: records.append((lvl, msg)), flush_cb=lambda: flushes.append(1))
    try:
        tcore.set_level(lg.RAFT_LEVEL_INFO)
        lg.logger.info("cb %s", "works")
        assert len(records) == 1 and records[0][1].endswith("cb works")
        [h.flush() for h in lg.logger.handlers if isinstance(h, lg._CallbackHandler)]
        assert flushes == [1]
        lg.set_pattern("%(message)s")
        lg.set_callback(None)
        lg.logger.info("after removal")
        assert len(records) == 1
    finally:
        lg.set_callback(None)
        lg.set_level(lg.RAFT_LEVEL_WARN)


def test_trace_range_in_a_cpu_profiler_trace():
    @tracing.annotate("raft_tpu_torch.test.annotated", n=3)
    def work(x):
        return x @ x

    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with tcore.trace_range("raft_tpu_torch.test.range", size=8):
            work(torch.ones(8, 8))
    names = {e.key for e in prof.key_averages()}
    assert {"raft_tpu_torch.test.range", "raft_tpu_torch.test.annotated"} <= names
    tracing.enable(False)
    try:
        with tcore.trace_range("off", a=1):
            pass
    finally:
        tracing.enable(True)


def test_output_conversion():
    from raft_tpu_torch.neighbors import brute_force

    x = np.random.default_rng(0).random((40, 3), dtype=np.float32)
    try:
        assert tcore.get_output_as() == "torch"
        tcore.set_output_as("numpy")
        d, i = brute_force.knn(x, x[:2], 3, device="cpu")
        assert isinstance(d, np.ndarray) and isinstance(i, np.ndarray) and i.dtype == np.int32
        out = tcore.convert_output({"a": torch.ones(2), "b": [torch.zeros(1), 5]})
        assert isinstance(out["a"], np.ndarray) and out["b"][1] == 5
        tcore.set_output_as(lambda t: "custom")
        assert tcore.convert_output(torch.ones(1)) == "custom"

        @tcore.auto_convert_output
        def outer():
            inner = brute_force.knn(x, x[:2], 3, device="cpu")  # no conversion inside
            assert isinstance(inner[0], torch.Tensor)
            return inner[0]

        assert outer() == "custom"
        with pytest.raises(ValueError):
            tcore.set_output_as("cupy")
    finally:
        tcore.set_output_as("torch")


def test_top_level_surface():
    import raft_tpu_torch

    assert raft_tpu_torch.__version__ == "0.1.0"
    assert raft_tpu_torch.Resources is tcore.Resources
    assert raft_tpu_torch.device_ndarray is tcore.device_ndarray
    for name in raft_tpu_torch._SUBPACKAGES:
        assert getattr(raft_tpu_torch, name) is importlib.import_module(f"raft_tpu_torch.{name}")
        assert name in dir(raft_tpu_torch)
    from raft_tpu_torch.neighbors import ivf_rabitq

    assert raft_tpu_torch.ivf_rabitq_build is ivf_rabitq.build
    # the serving and jobs layers resolve on the top level like the rest
    assert "serve" in raft_tpu_torch._SUBPACKAGES and "jobs" in raft_tpu_torch._SUBPACKAGES
    with pytest.raises(AttributeError):
        raft_tpu_torch.no_such_layer  # noqa: B018
