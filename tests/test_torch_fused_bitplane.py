"""PyTorch port: the RaBitQ bit-plane list scan (`fused_bitplane_topk`)
against the JAX Pallas kernel in interpret mode.

The integer scores S_u are exact in any order. The f32 estimator is
rounded as the JAX kernel rounds it on the CPU, where XLA contracts its
mul+add pairs into fused multiply-adds and turns the division by the
constant sqrt(D) into a multiply by the reciprocal
(`ops.fused_scan.bitplane_scores`), so values and slots match bit for bit:
the stated tolerance is zero. One geometry is the exception: with a single
plane word (rot_dim 32 and 1 query bit) XLA fuses the other product of
`lo * pop + delta * S_u`; there the values agree to 1e-5 of the row's
largest magnitude (the rounding of s moves through the estimator's
cancellation) and the slots exactly.

The JAX package's own oracle test
(`test_fused_int_scan.py::test_fused_bitplane_kernel_matches_quantizer_reference`)
fails by a few ulps for that reason: it recomputes the estimator with
another contraction. The port is held to the kernel itself.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch

from raft_tpu.neighbors.quantizer import binary_dot, pack_bits, quantize_queries
from raft_tpu.ops import fused_scan as jfs
from raft_tpu_torch.matrix.select_k import (
    bitplane_scan_select_k,
    check_bitplane_request,
    resolve_bitplane_strategy,
)
from raft_tpu_torch.ops import fused_scan as tfs


def _case(rng, n_lists=4, L=256, rot=64, chunk=8, bits=8, ncb=9, inf_frac=0.0, ties=False):
    """The operands of test_fused_int_scan.py:195-226 (a ragged +inf tail
    per list), optionally with duplicate codes (ties) and random +inf
    slots. Returns numpy arrays: uint32 planes and codes."""
    W = rot // 32
    resid = rng.standard_normal((n_lists, L, rot)).astype(np.float32)
    if ties:
        resid[:, 1::2] = resid[:, 0::2]  # every code twice: equal scores
    codes = np.asarray(pack_bits((resid >= 0).astype(np.uint32)))
    rnorm = np.sqrt((resid ** 2).sum(-1)).astype(np.float32)
    o_dot = (np.abs(resid).sum(-1) / (np.maximum(rnorm, 1e-30) * np.sqrt(rot))).astype(np.float32)
    pop = np.array([[sum(bin(int(w)).count("1") for w in row) for row in lst] for lst in codes],
                   np.float32)
    base = np.zeros((n_lists, 1, L), np.float32)
    for lst in range(n_lists):
        base[lst, 0, L - 1 - lst * 17:] = np.inf
    base[rng.random((n_lists, 1, L)) < inf_frac] = np.inf
    qres = rng.standard_normal((ncb, chunk, rot)).astype(np.float32)
    planes, lo, delta = (np.asarray(a) for a in quantize_queries(jnp.asarray(qres), bits))
    qmeta = np.stack([lo[..., 0], delta[..., 0], qres.sum(-1), (qres ** 2).sum(-1)],
                     axis=1).astype(np.float32)
    codes_t = np.ascontiguousarray(np.transpose(codes, (0, 2, 1)))
    meta = np.stack([pop, rnorm, o_dot], axis=1)
    lof = rng.integers(0, n_lists, ncb).astype(np.int32)
    return lof, planes.reshape(ncb, chunk, bits * W), codes_t, meta, base, qmeta


def _jax(args, k, rot, bits, ip, cv=None):
    lof, planes, codes_t, meta, base, qmeta = args
    out = jfs.fused_bitplane_topk(
        jnp.asarray(lof), jnp.asarray(planes), jnp.asarray(codes_t), jnp.asarray(meta),
        jnp.asarray(base), jnp.asarray(qmeta), k, rot_dim=rot, bits=bits, inner_product=ip,
        interpret=True, chunk_valid=None if cv is None else jnp.asarray(cv))
    return tuple(np.asarray(a) for a in out)


def _torch_args(args):
    lof, planes, codes_t, meta, base, qmeta = args
    return (torch.tensor(lof), torch.tensor(planes.view(np.int32)),
            torch.tensor(codes_t.view(np.int32)), torch.tensor(meta), torch.tensor(base),
            torch.tensor(qmeta))


def _port(args, k, rot, bits, ip, cv=None, rows=None):
    v, i = tfs.fused_bitplane_topk(*_torch_args(args), k, rot_dim=rot, bits=bits,
                                   inner_product=ip,
                                   chunk_valid=None if cv is None else torch.tensor(cv),
                                   chunk_rows=None if rows is None else torch.tensor(rows))
    return v.numpy(), i.numpy()


def _bitwise(port, ref):
    (tv, ti), (jv, ji) = port, ref
    assert tv.shape == jv.shape and ti.dtype == np.int32
    np.testing.assert_array_equal(tv.view(np.int32), jv.view(np.int32))
    np.testing.assert_array_equal(ti, ji)


@pytest.mark.parametrize("ip", [False, True])
def test_plain_bitwise_equal_to_jax_on_the_reference_inputs(rng, ip):
    args = _case(rng)
    _bitwise(_port(args, 16, 64, 8, ip), _jax(args, 16, 64, 8, ip))


@pytest.mark.parametrize("bits, rot, k", [(1, 64, 1), (4, 96, 40), (8, 96, 256), (8, 64, 40),
                                          (1, 96, 256), (4, 64, 1)])
def test_plain_bitwise_equal_to_jax_bits_words_k(rng, bits, rot, k):
    args = _case(rng, n_lists=3, L=384, rot=rot, chunk=16, bits=bits, ncb=5, inf_frac=0.1)
    _bitwise(_port(args, k, rot, bits, k == 40), _jax(args, k, rot, bits, k == 40))


@pytest.mark.parametrize("ip", [False, True])
def test_plain_ties_go_to_the_smaller_slot(rng, ip):
    args = _case(rng, L=256, rot=96, ties=True)
    port = _port(args, 40, 96, 8, ip)
    _bitwise(port, _jax(args, 40, 96, 8, ip))
    v, i = port
    tied = v[:, :, 1:40] == v[:, :, :39]
    assert tied.any() and (i[:, :, 1:40][tied] > i[:, :, :39][tied]).all()


@pytest.mark.parametrize("ip", [False, True])
def test_plain_empty_chunks_and_k_past_the_finite_slots(rng, ip):
    args = _case(rng, n_lists=3, L=256, rot=96, ncb=6, inf_frac=0.6)
    cv = np.array([1, 0, 1, 1, 0, 1], np.int32)
    port = _port(args, 200, 96, 8, ip, cv=cv)
    _bitwise(port, _jax(args, 200, 96, 8, ip, cv=cv))
    v, i = port
    assert (i[cv == 0] == tfs._ID_SENTINEL).all() and np.isinf(v[cv == 0]).all()
    assert np.isinf(v[cv == 1][..., 199]).all()  # fewer than 200 finite slots in every list


def test_plain_live_row_prefixes(rng):
    """chunk_rows, the port's addition: rows at or past a chunk's live
    count hold (+inf, sentinel); the leading rows are the kernel's own."""
    args = _case(rng, n_lists=3, L=256, rot=96, chunk=16, ncb=6)
    rows = np.array([16, 0, 5, 16, 1, 9], np.int32)
    v, i = _port(args, 10, 96, 8, False, rows=rows)
    jv, ji = _jax(args, 10, 96, 8, False)
    for c, live in enumerate(rows):
        np.testing.assert_array_equal(v[c, :live], jv[c, :live])
        np.testing.assert_array_equal(i[c, :live], ji[c, :live])
        assert np.isinf(v[c, live:]).all() and (i[c, live:] == tfs._ID_SENTINEL).all()


def test_plain_single_plane_word_within_tolerance(rng):
    """rot_dim 32 and 1 query bit: XLA contracts the other product (see
    the module docstring). Slots exact, values to 1e-5 of the row's
    largest magnitude."""
    args = _case(rng, n_lists=3, L=256, rot=32, chunk=16, bits=1, ncb=5)
    (tv, ti), (jv, ji) = _port(args, 100, 32, 1, False), _jax(args, 100, 32, 1, False)
    np.testing.assert_array_equal(ti, ji)
    fin = np.isfinite(jv)
    np.testing.assert_array_equal(np.isfinite(tv), fin)
    scale = np.where(fin, np.abs(jv), 0).max(axis=-1, keepdims=True)
    err = np.where(fin, np.abs(tv - jv), 0)
    assert (err <= 1e-5 * scale).all(), float(err.max())


def test_integer_scores_equal_binary_dot(rng):
    args = _case(rng, rot=96, bits=8)
    lof, planes, codes_t = args[:3]
    su = tfs.bitplane_su(torch.tensor(planes.view(np.int32)),
                         torch.tensor(codes_t.view(np.int32))[lof], 8)
    codes = np.transpose(codes_t, (0, 2, 1))[lof]  # (ncb, L, W)
    want = np.asarray(binary_dot(jnp.asarray(codes)[:, None, :, :],
                                 jnp.asarray(planes).reshape(9, 8, 1, 8, 3)))
    np.testing.assert_array_equal(su.numpy(), want.astype(np.int32))


def test_select_k_door_and_strategy(rng):
    args = _case(rng, rot=96)
    out = bitplane_scan_select_k(*_torch_args(args), 10, rot_dim=96, bits=8)
    ref = _port(args, 10, 96, 8, False)
    np.testing.assert_array_equal(out[0].numpy(), ref[0])
    # "auto" is "xla" without a tuned value for the device; explicit wins
    geo = (384, 3, 8, 40)
    assert (resolve_bitplane_strategy(*geo) == resolve_bitplane_strategy(*geo, strategy="auto")
            == "xla")
    assert resolve_bitplane_strategy(*geo, strategy="fused_bitplane") == "fused_bitplane"
    with pytest.raises(ValueError, match="unknown"):
        resolve_bitplane_strategy(*geo, strategy="nope")
    assert check_bitplane_request("x", 384, 3, 8, 40, None, "y") == 128
    assert check_bitplane_request("x", 384, 3, 8, 40, 256, "y") == 256
    with pytest.raises(ValueError, match="caps scan candidates at 256"):
        check_bitplane_request("x", 384, 3, 8, 257, None, "y")


def test_envelope_and_argument_checks(rng):
    assert tfs.fits_fused_bitplane(3840, 3, 8, 256)
    assert not tfs.fits_fused_bitplane(3840, 3, 9, 10)
    assert not tfs.fits_fused_bitplane(3840, 3, 8, 257)
    assert not tfs.fits_fused_bitplane(300, 3, 8, 10)  # not a multiple of 128
    assert not tfs.fits_fused_bitplane(3840, 3, 8, 200, kbuf=128)
    # no width is past shared memory now (the codes stream in K-blocks);
    # 8-bit levels over 32 x 2057 positions would take S_u past 2^24
    assert tfs.fits_fused_bitplane(3840, 2000, 8, 10)
    assert tfs.fits_fused_bitplane(3840, 2056, 8, 10)
    assert not tfs.fits_fused_bitplane(3840, 2057, 8, 10)
    assert tfs.fits_fused_bitplane(3840, 2057, 7, 10)
    lof, planes, codes_t, meta, base, qmeta = _torch_args(_case(rng, rot=96))
    with pytest.raises(ValueError, match="bits"):
        tfs.fused_bitplane_topk(lof, planes, codes_t, meta, base, qmeta, 10, rot_dim=96, bits=9)
    with pytest.raises(ValueError, match="planes width"):
        tfs.fused_bitplane_topk(lof, planes, codes_t, meta, base, qmeta, 10, rot_dim=96, bits=4)
    with pytest.raises(ValueError, match="dtype"):
        tfs.fused_bitplane_topk(lof, planes.float(), codes_t, meta, base, qmeta, 10, rot_dim=96,
                                bits=8)
    with pytest.raises(ValueError, match="meta must be"):
        tfs.fused_bitplane_topk(lof, planes, codes_t, meta[:, :2].contiguous(), base, qmeta, 10,
                                rot_dim=96, bits=8)
    with pytest.raises(ValueError, match="cannot hold"):
        tfs.fused_bitplane_topk(lof, planes, codes_t, meta, base, qmeta, 200, rot_dim=96, bits=8,
                                kbuf=128)


def test_selection_by_k_and_its_shared_memory_budget(rng):
    """The kernel's selection is picked by k alone: register lists up to
    k = 32, shared-memory lists past it, which add 16 rows x (list width +
    128) pairs to the block's shared memory, the list width the smallest
    of 64, 128 and 256 that holds k. The rest of the block is one K-block
    of expanded codes (128 slots x 32 bytes a word of the K-block: 4
    words, or 2 with the 256-pair lists), the query levels (16 rows x the
    same bytes a K-block when resident, else a slice a warpgroup) and the
    score tile, whose pads hold the qmeta. The plain version answers for
    both sides of the switch, bit for bit as the JAX kernel does."""
    assert tfs.MAX_REGISTER_K == 32
    regs = tfs._bitplane_smem_bytes(3, 32)
    assert regs == tfs._bitplane_smem_bytes(3) == 1024 + 128 * 128 + 16 * 128 + 4 * 16 * 132
    for k, width in ((33, 64), (64, 64), (65, 128), (128, 128)):
        assert tfs._bitplane_smem_bytes(3, k) == regs + 16 * (width + 128) * 8
    narrow = 1024 + 128 * 64 + 2 * 16 * 64 + 4 * 16 * 132  # 2-word K-blocks
    for k in (129, 250, 256):
        assert tfs._bitplane_smem_bytes(3, k) == narrow + 16 * (256 + 128) * 8
    # a K-block of levels a 4 words, resident; two slices streamed
    assert tfs._bitplane_smem_bytes(9, 10) == regs + 2 * 16 * 128
    assert tfs._bitplane_smem_bytes(9, 10, resident=False) == regs + 16 * 128
    # the main path's width leaves room for the blocks an SM the kernel is
    # built for: four with register lists and 64-pair lists, three past them
    for k in (10, 40, 64):
        assert 4 * (tfs._bitplane_smem_bytes(3, k) + 1024) <= 228 * 1024
    for k in (65, 128, 250):
        assert 3 * (tfs._bitplane_smem_bytes(3, k) + 1024) <= 228 * 1024
    assert tfs.fits_fused_bitplane(4992, 3, 8, 250)
    assert tfs.fits_fused_bitplane(3840, 400, 8, 32)
    assert tfs.fits_fused_bitplane(3840, 400, 8, 33)  # past the resident levels: streamed
    assert tfs.bitplane_resident(400, 32) and not tfs.bitplane_resident(400, 33)
    args = _case(rng, rot=96)
    for k in (32, 33):
        _bitwise(_port(args, k, 96, 8, False), _jax(args, k, 96, 8, False))


def _old_fits(L, words, bits, k, kbuf=None):
    """The envelope of the CUDA-core bit-plane scan this kernel replaced:
    the tile's scores, the block's plane words and qmeta, past k 32 the
    lists, within SMEM_LIMIT."""
    if not (0 < k <= 256 and 1 <= bits <= 8 and words >= 1):
        return False
    if kbuf is not None and kbuf < tfs.fused_kbuf(k):
        return False
    b = 4 * 16 * 128 + 4 * 16 * (bits * words + 4)
    cap = 0 if k <= 32 else 64 if k <= 64 else 128 if k <= 128 else 256
    if cap:
        b = -(-b // 16) * 16 + 8 * 16 * (cap + 128)
    return L % 128 == 0 and b <= tfs.SMEM_LIMIT


def test_envelope_admits_every_shape_the_popcount_scan_did():
    """Every (L, words, bits, k, kbuf) the earlier envelope admitted, the
    K-blocked tensor-core scan admits too (it streams codes and, past the
    resident edge, query levels, so shared memory bounds no width)."""
    widths = list(range(1, 48)) + list(range(48, 3600, 29)) + [400, 437, 438, 3500, 3501]
    admitted = 0
    for L in (128, 300, 3840, 4992):
        for bits in range(1, 9):
            for words in widths:
                for k in (1, 10, 32, 33, 64, 65, 128, 129, 250, 256):
                    for kbuf in (None, 128, 256):
                        if _old_fits(L, words, bits, k, kbuf):
                            admitted += 1
                            assert tfs.fits_fused_bitplane(L, words, bits, k, kbuf), (
                                L, words, bits, k, kbuf)
    assert admitted > 10_000
    assert _old_fits(3840, 437, 8, 10) and not _old_fits(3840, 438, 8, 10)
    assert _old_fits(3840, 3500, 1, 10) and tfs.fits_fused_bitplane(3840, 3500, 1, 10)


_IDENTITY_WORDS = (1, 3, 4, 5, 8, 9, 32)


@pytest.mark.parametrize("words", _IDENTITY_WORDS)
def test_levels_times_code_bits_is_the_bitplane_sum(rng, words):
    """The identity the kernel rests on: S_u = sum_d u[d] b[d], the u8
    query levels (`bitplane_levels`) against the {0, 1} code bits
    (`expand_code_bits`), equals `bitplane_su` and JAX's `binary_dot` bit
    for bit, for 1 to 8 query bits, on random words, all-ones planes
    (level 2^bits - 1), all-ones codes (bit 31 set) and zero words."""
    ncb, chunk, L = 2, 4, 128
    for bits in range(1, 9):
        planes = rng.integers(0, 2**32, (ncb, chunk, bits * words), dtype=np.uint64).astype(
            np.uint32)
        codes_t = rng.integers(0, 2**32, (ncb, words, L), dtype=np.uint64).astype(np.uint32)
        planes[0, 0] = 0xFFFFFFFF  # every level 2^bits - 1
        planes[0, 1] = 0
        planes[1, 0, ::2] = 0x80000000
        codes_t[0, :, 0] = 0xFFFFFFFF  # every bit set, bit 31 too
        codes_t[0, :, 1] = 0
        codes_t[1, words // 2, 2:] = 0x80000001
        tp, tc = torch.tensor(planes.view(np.int32)), torch.tensor(codes_t.view(np.int32))
        levels = tfs.bitplane_levels(tp, bits)
        cbits = tfs.expand_code_bits(tc)
        assert levels.dtype == cbits.dtype == torch.uint8
        assert levels.shape == (ncb, chunk, 32 * words) and cbits.shape == (ncb, 32 * words, L)
        assert int(levels.max()) <= (1 << bits) - 1 and int(cbits.max()) <= 1
        assert int(levels[0, 0].min()) == (1 << bits) - 1 and int(cbits[0, :, 0].min()) == 1
        prod = torch.bmm(levels.to(torch.int64), cbits.to(torch.int64)).to(torch.int32)
        su = tfs.bitplane_su(tp, tc, bits)
        np.testing.assert_array_equal(prod.numpy(), su.numpy())
        assert int(su[0, 0, 0]) == ((1 << bits) - 1) * 32 * words
        want = np.asarray(binary_dot(jnp.asarray(np.transpose(codes_t, (0, 2, 1)))[:, None],
                                     jnp.asarray(planes).reshape(ncb, chunk, 1, bits, words)))
        np.testing.assert_array_equal(prod.numpy(), want.astype(np.int32))
