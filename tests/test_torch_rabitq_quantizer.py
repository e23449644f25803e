"""PyTorch port: the RaBitQ half of the quantizer against the JAX package.

Packed words are int32 tensors holding the JAX package's uint32 bits
(carried across with `.view(np.int32)`); torch has no popcount and no
uint32 shifts, so the port counts and shifts in int64.

- `pack_bits`/`unpack_bits`: equal words (bit 31 included) and a round
  trip; `popcount32` against Python's own bit count.
- `quantize_queries`: planes, lo and delta bit for bit against the jitted
  JAX function (the path its search engines run), on gaussian, ragged
  and tie-heavy rows at 1, 4 and 8 bits. Both delta and every plane bit
  depend on XLA compiling the division by the level count into a multiply
  by its f32 reciprocal; the port multiplies the same way. torch.round
  and jnp.round both round half to even.
- `binary_dot`: exact (integer sums).
- `encode`: codes and aux bit for bit equal to the jitted JAX encode
  (`_encode_rotated`, the path its build runs): the port takes |r|'s and
  sum |r|'s sums in the compiled reference's order and a correctly
  rounded square root. torch.sum's order, or torch's CPU sqrt (not
  correctly rounded), would put them an ulp or three apart.
- `estimate_distances` with and without `exact_queries`, and `decode`:
  rtol 1e-5 of the row's largest magnitude (the eager JAX verbs divide by
  sqrt(D) where the port multiplies by its reciprocal, and sum in another
  order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import torch

from raft_tpu.neighbors import ivf_rabitq as jr
from raft_tpu.neighbors import quantizer as jq
from raft_tpu_torch.neighbors import quantizer as tq


def _words(rng, shape):
    w = rng.integers(0, 2**32, shape, dtype=np.uint64).astype(np.uint32)
    w.reshape(-1)[:4] = [0, 0xFFFFFFFF, 0x80000000, 0x7FFFFFFF]
    return w


def _ulps(a, b):
    return np.abs(a.astype(np.float32).view(np.int32).astype(np.int64)
                  - b.astype(np.float32).view(np.int32))


def _rows(rng, kind, n, d):
    if kind == "gaussian":
        return (3 * rng.standard_normal((n, d))).astype(np.float32)
    if kind == "ties":
        return rng.integers(-3, 4, (n, d)).astype(np.float32)
    q = (rng.standard_normal((n, d)) * np.exp(rng.uniform(-8, 8, (n, 1)))).astype(np.float32)
    q[:3] = 1.0  # constant rows: delta hits its 1e-12 floor
    q[3:6, ::2] = 0.5
    return q


def test_pack_unpack_round_trip_including_bit_31(rng):
    bits = rng.integers(0, 2, (50, 96)).astype(np.uint32)
    bits[:, 31] = 1  # the sign bit of the first int32 word
    bits[0] = 1
    jw = np.asarray(jq.pack_bits(bits)).view(np.int32)
    tw = tq.pack_bits(torch.tensor(bits.astype(np.int32)))
    assert tw.dtype == torch.int32
    np.testing.assert_array_equal(tw.numpy(), jw)
    np.testing.assert_array_equal(tq.unpack_bits(tw, 96).numpy(), bits.astype(np.int32))
    np.testing.assert_array_equal(
        tq.unpack_bits(tw, 96).numpy(), np.asarray(jq.unpack_bits(jw.view(np.uint32), 96)))
    assert tq.packed_words(96) == 3
    with pytest.raises(ValueError, match="multiple of 32"):
        tq.packed_words(33)


def test_popcount32_counts_every_bit(rng):
    w = _words(rng, (1000,))
    want = np.array([bin(int(x)).count("1") for x in w], np.int32)
    np.testing.assert_array_equal(tq.popcount32(torch.tensor(w.view(np.int32))).numpy(), want)


@pytest.mark.parametrize("bits", [1, 4, 8])
@pytest.mark.parametrize("kind", ["gaussian", "ragged", "ties"])
@pytest.mark.parametrize("d", [32, 96])
def test_quantize_queries_bitwise_equal_to_jitted_jax(rng, bits, kind, d):
    q = _rows(rng, kind, 300, d)
    jp, jl, jd = (np.asarray(a) for a in
                  jax.jit(jq.quantize_queries, static_argnums=1)(jnp.asarray(q), bits))
    tp, tl, td = tq.quantize_queries(torch.tensor(q), bits)
    assert tp.shape == (300, bits, d // 32) and tp.dtype == torch.int32
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(td.numpy().view(np.int32), jd.view(np.int32))
    np.testing.assert_array_equal(tp.numpy(), jp.view(np.int32))


def test_quantize_queries_division_would_move_plane_bits(rng):
    """The reason for the reciprocal: (hi - lo) / 255, correctly rounded,
    differs from the jitted reference's delta in most tie-heavy rows, and
    then planes differ too."""
    q = _rows(rng, "ties", 300, 96)
    jd = np.asarray(jax.jit(jq.quantize_queries, static_argnums=1)(jnp.asarray(q), 8)[2])
    t = torch.tensor(q)
    divided = torch.clamp((t.amax(-1, keepdim=True) - t.amin(-1, keepdim=True)) / 255, min=1e-12)
    assert (divided.numpy() != jd).mean() > 0.5


def test_binary_dot_exact(rng):
    codes = _words(rng, (40, 3))
    q = _rows(rng, "gaussian", 7, 96)
    planes = np.asarray(jax.jit(jq.quantize_queries, static_argnums=1)(jnp.asarray(q), 8)[0])
    jdot = np.asarray(jq.binary_dot(jnp.asarray(codes)[None], jnp.asarray(planes)[:, None]))
    tdot = tq.binary_dot(torch.tensor(codes.view(np.int32))[None],
                         torch.tensor(planes.view(np.int32))[:, None])
    assert tdot.shape == (7, 40) and tdot.dtype == torch.float32
    np.testing.assert_array_equal(tdot.numpy(), jdot)


@pytest.mark.parametrize("d", [32, 96])
def test_encode_matches_the_jitted_jax_encode(rng, d):
    r = rng.standard_normal((2000, d)).astype(np.float32)
    r[0] = 0.0  # a row on its center: o_dot 1
    r[1, :5] = -0.0  # -0.0 >= 0 sets the bit in both
    labels = np.zeros(2000, np.int32)
    jc, ja = (np.asarray(a) for a in jr._encode_rotated(
        jnp.asarray(r), jnp.asarray(labels), jnp.zeros((1, d), jnp.float32)))
    out = tq.RabitqQuantizer(d).encode(torch.tensor(r))
    np.testing.assert_array_equal(out["codes"].numpy(), jc.view(np.int32))
    ta = out["aux"].numpy()
    np.testing.assert_array_equal(ta.view(np.int32), ja.view(np.int32))
    assert ta[0, 1] == 1.0
    # what the ordered sums and the rounded sqrt buy: the plain torch
    # expressions are an ulp or more away from the reference in some rows
    t = torch.tensor(r)
    plain_rnorm = torch.sqrt(torch.sum(t * t, dim=-1)).numpy()
    assert _ulps(plain_rnorm, ja[:, 0]).max() >= 1


def _table_payload(rng, d=96, n=300, nq=9):
    quant_j, quant_t = jq.RabitqQuantizer(d), tq.RabitqQuantizer(d)
    r = rng.standard_normal((n, d)).astype(np.float32)
    qres = rng.standard_normal((nq, d)).astype(np.float32)
    jpay = quant_j.encode(jnp.asarray(r))
    tpay = quant_t.encode(torch.tensor(r))
    return quant_j, quant_t, qres, jpay, tpay


def _close_rows(t, j, rtol=1e-5):
    scale = np.maximum(np.abs(j).max(axis=-1, keepdims=True), 1.0)
    err = np.abs(t - j)
    assert (err <= rtol * scale).all(), float(err.max())


@pytest.mark.parametrize("exact", [False, True])
def test_estimate_distances_matches_jax(rng, exact):
    quant_j, quant_t, qres, jpay, tpay = _table_payload(rng)
    jt = quant_j.score_table(jnp.asarray(qres))
    tt = quant_t.score_table(torch.tensor(qres))
    np.testing.assert_array_equal(tt["planes"].numpy(), np.asarray(jt["planes"]).view(np.int32))
    ex_j = jnp.asarray(qres) if exact else None
    ex_t = torch.tensor(qres) if exact else None
    jd = np.asarray(quant_j.estimate_distances(jt, jpay, exact_queries=ex_j))
    td = quant_t.estimate_distances(tt, tpay, exact_queries=ex_t).numpy()
    assert td.shape == jd.shape == (9, 300)
    _close_rows(td, jd)


def test_decode_matches_jax(rng):
    quant_j, quant_t, _, jpay, tpay = _table_payload(rng)
    _close_rows(quant_t.decode(tpay).numpy(), np.asarray(quant_j.decode(jpay)))


def test_query_bits_range():
    with pytest.raises(ValueError, match=r"\[1, 8\]"):
        tq.RabitqQuantizer(96, query_bits=9)
    assert tq.RabitqQuantizer(96).query_bits == tq.DEFAULT_QUERY_BITS == 8
