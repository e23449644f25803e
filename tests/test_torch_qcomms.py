"""The port's quantized transport (raft_tpu_torch/comms/quantized.py)
against the JAX package's, on 8 in-process CPU ranks and the 8 virtual
devices of tests/conftest.py, same numpy inputs.

- The codec (quantize_blocks / dequantize_blocks) bit for bit for every
  block choice, zero blocks and pads included; `packet_bytes`.
- `QuantConfig` validation and `resolve`: explicit modes, "auto" exact
  where the tuned table does not govern (the CPU), the tuned mode where
  it does.
- Each quantized collective against the JAX output, bit for bit: the
  ring int8 allreduce (SUM) and reduce-scatter on 4 ranks of each package
  (the JAX compiler takes ~25 s for each 8-rank ring), the grouped int8
  allreduce, int8 allgather, int8 bcast at root 3 and the exact fallbacks
  (int payloads, PROD) on 8; the bf16 allreduce within 1e-2 of the
  result's scale (JAX sums its bf16 all-reduce in another order), the
  same on every rank. The ring MIN against the exact MIN within the
  codec's bound, the same on every rank.
- `exchange_candidates` (int8, bf16, a saturated shortlist) on 4 ranks:
  values and ids equal to JAX's.
- "off" bit-identical to the exact collectives and to the exact k-NN and
  k-means drivers; quantized k-NN recall as the JAX test's bound.
- The wire-byte counters after one call equal the JAX counters after its
  first (tracing) call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from raft_tpu import obs as jobs
from raft_tpu.comms import Comms as JComms
from raft_tpu.comms import op_t as jop
from raft_tpu.comms import quantized as jq
from raft_tpu_torch import obs as tobs
from raft_tpu_torch.comms import Comms, mnmg, op_t
from raft_tpu_torch.comms import quantized as tq
from raft_tpu_torch.comms.comms import P
from raft_tpu_torch.core import tuned as ttuned

WORLD = 8


@pytest.fixture(scope="module")
def jc():
    return JComms()


@pytest.fixture(scope="module")
def tc():
    c = Comms(n_devices=WORLD, device="cpu", timeout_s=60)
    yield c
    c.destroy()


def _recall(got, ref) -> float:
    got, ref = np.asarray(got), np.asarray(ref)
    return float(np.mean([len(set(g.tolist()) & set(r.tolist())) / ref.shape[1]
                          for g, r in zip(got, ref)]))


# -- codec ---------------------------------------------------------------

@pytest.mark.parametrize("block", tq.BLOCK_CHOICES)
def test_codec_bit_for_bit(block):
    rng = np.random.default_rng(block)
    x = (rng.standard_normal(1000) * rng.uniform(0.1, 50, 1000)).astype(np.float32)
    x[:block] = 0.0  # an all-zero block
    x[block:block + 3] = [127.0, -127.0, 0.5]
    jqv, jsc = jq.quantize_blocks(jnp.asarray(x), block)
    tqv, tsc = tq.quantize_blocks(torch.from_numpy(x), block)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tsc.numpy(), np.asarray(jsc))
    assert tqv.dtype == torch.int8 and tsc.dtype == torch.float32
    jd = jq.dequantize_blocks(jqv, jsc, (10, 100))
    td = tq.dequantize_blocks(tqv, tsc, (10, 100))
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    assert tq.packet_bytes(1000, block) == jq.packet_bytes(1000, block)
    bound = np.abs(x).reshape(-1, block).max(1) / 254.0 + 1e-6 if 1000 % block == 0 else None
    if bound is not None:
        err = np.abs(td.numpy().reshape(-1) - x).reshape(-1, block).max(1)
        assert np.all(err <= bound)


def test_quantconfig_and_resolve(monkeypatch):
    for kw in ({"mode": "int4"}, {"mode": "int8", "block": 0},
               {"mode": "int8", "exchange_mult": 0.5}):
        with pytest.raises(ValueError):
            tq.QuantConfig(**kw)
        with pytest.raises(ValueError):
            jq.QuantConfig(**kw)
    cfg = tq.QuantConfig("int8", 64)
    assert hash(cfg) == hash(tq.QuantConfig("int8", 64))
    for q in (None, False, "off", tq.QuantConfig("off"), "auto"):
        assert tq.resolve(q, "cpu") is None
        assert jq.resolve(q if not isinstance(q, tq.QuantConfig) else jq.QuantConfig("off")) is None
    assert tq.resolve("int8", "cpu") == tq.QuantConfig("int8", 32)
    assert tq.resolve("bf16", "cpu").mode == "bf16"
    assert tq.resolve(cfg, "cpu") is cfg
    with pytest.raises(ValueError, match="unknown quantization"):
        tq.resolve("fp8")
    # where the tuned table governs the device, "auto" reads its mode
    table = {"comms_quant_mode": "int8", "comms_quant_block": 64}
    monkeypatch.setattr(ttuned, "applies", lambda device: True)
    monkeypatch.setattr(ttuned, "get", lambda key, default=None: table.get(key, default))
    assert tq.resolve("auto", "cuda") == tq.QuantConfig("int8", 64)
    table["comms_quant_block"] = 48  # outside the choices: the default block
    assert tq.resolve("int8", "cuda") == tq.QuantConfig("int8", 32)


# -- quantized collectives ----------------------------------------------

COLORS = [0, 0, 0, 0, 1, 1, 1, 1]
#: the ring schedules unroll 2 (w - 1) hops, which the JAX compiler takes
#: ~25 s for at 8 ranks: they run on 4 ranks of each package
RING_WORLD = 4


def _data(world):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(world, 257)).astype(np.float32)
    g = rng.normal(size=(world, 64)).astype(np.float32)
    rs = rng.normal(size=(world, world * 12, 7)).astype(np.float32)
    xi = np.arange(world * 16, dtype=np.int32).reshape(world, 16)
    return x, g, rs, xi


def _jax_body(ac, cfg8, cfg16, ring):
    def body(x, g, rs, xi):
        x, g, rs, xi = x[0], g[0], rs[0], xi[0]
        if ring:
            outs = (ac.allreduce(x, jop.SUM, quantization=cfg8),
                    ac.reducescatter(rs, jop.SUM, quantization=cfg8).reshape(-1))
        else:
            outs = (ac.allreduce(x, jop.SUM, quantization=cfg16),
                    ac.comm_split(COLORS).allreduce(g, quantization=cfg8),
                    ac.allgather(g, quantization=cfg8).reshape(-1),
                    ac.bcast(x, root=3, quantization=cfg8),
                    ac.allreduce(xi, jop.SUM, quantization=cfg8),
                    ac.allreduce(x[:8], jop.PROD, quantization=cfg8))
        return tuple(o[None] for o in outs)

    return body


def _port_body(ac, x, g, rs, xi, cfg8, cfg16, ring):
    x, g, rs, xi = x[0], g[0], rs[0], xi[0]
    if ring:
        outs = (ac.allreduce(x, op_t.SUM, quantization=cfg8),
                ac.reducescatter(rs, op_t.SUM, quantization=cfg8).reshape(-1))
    else:
        outs = (ac.allreduce(x, op_t.SUM, quantization=cfg16),
                ac.comm_split(COLORS).allreduce(g, quantization=cfg8),
                ac.allgather(g, quantization=cfg8).reshape(-1),
                ac.bcast(x, root=3, quantization=cfg8),
                ac.allreduce(xi, op_t.SUM, quantization=cfg8),
                ac.allreduce(x[:8], op_t.PROD, quantization=cfg8))
    return tuple(o[None] for o in outs)


NAMES = ("ring-int8-sum", "ring-reducescatter-int8", "bf16-sum",
         "grouped-int8", "allgather-int8", "bcast-int8", "int-payload", "prod")


def _counters(reg):
    """The comms counters a call moved (a registry keeps the names of
    instruments earlier tests made, at zero, across `reset()`)."""
    return {k: v for k, v in reg.snapshot()["counters"].items()
            if k.startswith("comms.") and v}


def _both(world, ring):
    """Both packages' outputs and comms counters for one call."""
    data = _data(world)
    jcm = JComms(n_devices=world)
    tcm = Comms(n_devices=world, device="cpu", timeout_s=60)
    jobs.enable()
    tobs.enable()
    try:
        jobs.reset()
        jout = jax.shard_map(
            _jax_body(jcm.comms, jq.QuantConfig("int8", 32), jq.QuantConfig("bf16"), ring),
            mesh=jcm.mesh, in_specs=(JP("data"),) * 4, out_specs=JP("data"),
            check_vma=False)(*data)
        jout = [np.asarray(o) for o in jout]
        jcount = _counters(jobs.registry())
        tobs.reset()
        tout = tcm.run(_port_body, *data, tq.QuantConfig("int8", 32), tq.QuantConfig("bf16"),
                       ring, in_specs=(P("data"),) * 4 + (P(),) * 3,
                       out_specs=(P("data"),) * len(jout))
        tout = [o.numpy() for o in tout]
        tcount = _counters(tobs.registry())
    finally:
        tcm.destroy()
        for o in (jobs, tobs):
            o.disable()
            o.reset()
    return jout, tout, jcount, tcount


@pytest.fixture(scope="module")
def quant_outputs():
    ring = _both(RING_WORLD, True)
    rest = _both(WORLD, False)
    return ring[0] + rest[0], ring[1] + rest[1], (ring[2], rest[2]), (ring[3], rest[3])


@pytest.mark.parametrize("idx", range(len(NAMES)), ids=NAMES)
def test_quantized_collectives_match_jax(quant_outputs, idx):
    """int8 paths and the exact fallbacks bit for bit; the bf16 SUM (JAX
    accumulates its bf16 all-reduce in another order) within 1e-2 of the
    result's scale, the same on every rank."""
    j, t = quant_outputs[0][idx], quant_outputs[1][idx]
    assert j.shape == t.shape and j.dtype == t.dtype
    if NAMES[idx] != "bf16-sum":
        np.testing.assert_array_equal(t, j)
        return
    for r in range(WORLD):
        np.testing.assert_array_equal(t[r], t[0])
    assert np.abs(t.astype(np.float64) - j).max() <= 1e-2 * np.abs(j).max()


def test_ring_min_within_the_codec_bound(tc):
    """The ring int8 MIN (the SUM's schedule with another combine) on 8
    ranks: the same bits on every rank, within a few encodes' absmax/254
    of the exact MIN."""
    x = _data(WORLD)[0]

    def body(ac, x):
        return ac.allreduce(x[0], op_t.MIN, quantization=tq.QuantConfig("int8", 32))[None]

    got = tc.run(body, x, in_specs=P("data"), out_specs=P("data")).numpy()
    for r in range(WORLD):
        np.testing.assert_array_equal(got[r], got[0])
    exact = x.min(0)
    assert np.abs(got[0] - exact).max() <= 2 * WORLD * np.abs(x).max() / 254.0
    assert np.any(got[0] != exact)


def test_wire_byte_counters_equal_jax_after_one_call(quant_outputs):
    for jcount, tcount in zip(quant_outputs[2], quant_outputs[3]):
        assert any(k.endswith(".wire_bytes") for k in jcount)
        assert tcount == jcount


def test_off_is_the_exact_collective(tc):
    x = np.random.default_rng(5).normal(size=(WORLD, 257)).astype(np.float32)

    def body(ac, x):
        return (ac.allreduce(x[0])[None], ac.allreduce(x[0], quantization="off")[None],
                ac.allreduce(x[0], quantization="auto")[None])

    a, b, c = tc.run(body, x, in_specs=P("data"), out_specs=(P("data"),) * 3)
    assert torch.equal(a, b) and torch.equal(a, c)


# -- candidate exchange --------------------------------------------------

@pytest.fixture(scope="module")
def exchange_data():
    rng = np.random.default_rng(23)
    nq, kk = 16, 16
    v = np.sort(rng.uniform(0, 100, size=(WORLD, nq, kk)), axis=2).astype(np.float32)
    ids = rng.permutation(WORLD * nq * kk).reshape(WORLD, nq, kk).astype(np.int32)
    return v, ids


EXCHANGE_MODES = ("int8", "bf16", "saturated")


@pytest.fixture(scope="module")
def exchange_outputs(exchange_data):
    """The three exchanges in one program of each package, on 4 ranks."""
    v, ids = (a[:RING_WORLD] for a in exchange_data)
    jc = JComms(n_devices=RING_WORLD)
    tc = Comms(n_devices=RING_WORLD, device="cpu", timeout_s=60)
    k = 10
    jcfgs = [jq.QuantConfig("int8", 32), jq.QuantConfig("bf16"),
             jq.QuantConfig("int8", 32, exchange_mult=1000.0)]
    tcfgs = [tq.QuantConfig(c.mode, c.block, c.exchange_mult) for c in jcfgs]
    jac = jc.comms

    def jbody(vs, is_):
        outs = []
        for cfg in jcfgs:
            outs += list(jq.exchange_candidates(jac, vs[0], is_[0], k, True, cfg))
        return tuple(o[None] for o in outs)

    jout = jax.shard_map(jbody, mesh=jc.mesh, in_specs=(JP("data"), JP("data")),
                         out_specs=JP("data"), check_vma=False)(v, ids)

    def tbody(ac, vs, is_):
        outs = []
        for cfg in tcfgs:
            outs += list(tq.exchange_candidates(ac, vs[0], is_[0], k, True, cfg))
        return tuple(o[None] for o in outs)

    tout = tc.run(tbody, v, ids, in_specs=(P("data"), P("data")), out_specs=(P("data"),) * 6)
    tc.destroy()
    return [np.asarray(o) for o in jout], [o.numpy() for o in tout]


@pytest.mark.parametrize("i", range(3), ids=EXCHANGE_MODES)
def test_exchange_candidates_match_jax(exchange_outputs, i):
    jout, tout = exchange_outputs
    np.testing.assert_array_equal(tout[2 * i], jout[2 * i])
    np.testing.assert_array_equal(tout[2 * i + 1], jout[2 * i + 1])
    assert tout[2 * i + 1].dtype == np.int32


# -- the drivers ---------------------------------------------------------

@pytest.fixture(scope="module")
def blobs():
    from raft_tpu.random import make_blobs

    data, _ = make_blobs(1024, 16, n_clusters=6, cluster_std=0.4, seed=13)
    return np.asarray(data)


def test_knn_off_bit_identical_and_quantized_recall(tc, blobs):
    from raft_tpu_torch.neighbors import brute_force

    q = blobs[:19]
    bv, bi = mnmg.knn(tc, blobs, q, 10)
    ov, oi = mnmg.knn(tc, blobs, q, 10, quantization="off")
    assert torch.equal(bv, ov) and torch.equal(bi, oi)
    _, truth = brute_force.knn(blobs, q, 10, device="cpu")
    for mode in ("int8", "bf16"):
        qv, qi = mnmg.knn(tc, blobs, q, 10, quantization=mode)
        assert _recall(qi, oi) >= 1.0 - 1e-3
        assert _recall(qi, truth) >= 1.0 - 1e-3


def test_kmeans_off_bit_identical_and_quantized_tolerance(tc, blobs):
    base = mnmg.kmeans_fit(tc, blobs, 6, max_iter=5, seed=0)
    off = mnmg.kmeans_fit(tc, blobs, 6, max_iter=5, seed=0, quantization="off")
    assert torch.equal(base[0], off[0]) and base[1] == off[1] and base[2] == off[2]
    ci, inertia_i, _ = mnmg.kmeans_fit(tc, blobs, 6, max_iter=5, seed=0, quantization="int8")
    cb, inertia_b, _ = mnmg.kmeans_fit(tc, blobs, 6, max_iter=5, seed=0, quantization="bf16")
    scale = base[0].abs().max()
    assert (ci - base[0]).abs().max() <= 0.25 * scale
    assert (cb - base[0]).abs().max() <= 0.1 * scale
    assert inertia_i <= base[1] * 1.1 and inertia_b <= base[1] * 1.05
