"""PyTorch port: core/bitset against the JAX package's on the same masks.

The JAX Bitset packs uint32 words; the port's holds the same bits as
int32, so the words compare through `view(np.int32)`, and a JAX bitset
carries across word for word. `test` of ids out of [0, n) is False in
both. `filter_slot_table` and `make_slot_filter` on a lane-padded slot
table (its pad columns read -1) give JAX's table exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import torch

from raft_tpu.core import bitset as jbs
from raft_tpu_torch.core import bitset as tbs


def _words(jb):
    return np.asarray(jb.bits).view(np.int32)


@pytest.mark.parametrize("n", [0, 1, 32, 33, 1000])
def test_masks_pack_to_the_same_words(rng, n):
    mask = rng.random(n) < 0.5
    jb, tb = jbs.Bitset.from_mask(mask), tbs.Bitset.from_mask(mask)
    np.testing.assert_array_equal(tb.bits.numpy(), _words(jb))
    assert tb.bits.dtype == torch.int32 and len(tb) == n
    assert int(tb.count()) == int(jb.count()) == int(mask.sum())
    ids = np.arange(-3, n + 40)
    np.testing.assert_array_equal(tb.test(torch.tensor(ids)).numpy(),
                                  np.asarray(jb.test(jnp.asarray(ids))))
    np.testing.assert_array_equal(tb.to_mask().numpy(), mask)
    carried = tbs.Bitset(np.asarray(jb.bits), n)  # uint32 words, carried as int32
    np.testing.assert_array_equal(carried.bits.numpy(), tb.bits.numpy())


@pytest.mark.parametrize("n", [1, 45, 300])
def test_constructors_and_mutators_match_jax(rng, n):
    for value in (True, False):
        np.testing.assert_array_equal(tbs.Bitset.full(n, value).bits.numpy(),
                                      _words(jbs.Bitset.full(n, value)))
    ids = rng.integers(-5, n + 5, 20)  # duplicates and ids out of range
    np.testing.assert_array_equal(tbs.Bitset.excluding(n, torch.tensor(ids)).bits.numpy(),
                                  _words(jbs.Bitset.excluding(n, jnp.asarray(ids))))
    a, b = rng.random(n) < 0.3, rng.random(n) < 0.6
    ja, jb = jbs.Bitset.from_mask(a), jbs.Bitset.from_mask(b)
    ta, tb = tbs.Bitset.from_mask(a), tbs.Bitset.from_mask(b)
    np.testing.assert_array_equal(ta.set(torch.tensor(ids)).bits.numpy(),
                                  _words(ja.set(jnp.asarray(ids))))
    np.testing.assert_array_equal(ta.set(torch.tensor(ids), False).bits.numpy(),
                                  _words(ja.set(jnp.asarray(ids), False)))
    np.testing.assert_array_equal(ta.flip().bits.numpy(), _words(ja.flip()))
    np.testing.assert_array_equal((ta & tb).bits.numpy(), _words(ja & jb))
    np.testing.assert_array_equal((ta | tb).bits.numpy(), _words(ja | jb))
    assert int(ta.flip().count()) == int(ja.flip().count()) == n - int(a.sum())
    with pytest.raises(ValueError, match="length mismatch"):
        ta & tbs.Bitset.full(n + 1)


def test_as_bitset_checks_what_it_is_given(rng):
    mask = rng.random(50) < 0.5
    b = tbs.as_bitset(mask, 50)
    np.testing.assert_array_equal(b.bits.numpy(), _words(jbs.as_bitset(mask, 50)))
    assert tbs.as_bitset(b, 50) is b
    with pytest.raises(ValueError, match="covers 50 ids"):
        tbs.as_bitset(b, 51)
    with pytest.raises(ValueError, match="has 49 entries"):
        tbs.as_bitset(mask[:49], 50)
    with pytest.raises(ValueError, match="boolean mask"):
        tbs.as_bitset(mask.astype(np.int32), 50)


def _padded_table(rng, n_lists=6, width=40, lpad=128):
    """A slot table with -1 holes in its lists and -1 lane padding, its
    positions a permutation of the rows, and source ids past the row count."""
    sizes = rng.integers(0, width + 1, n_lists)
    n = int(sizes.sum())
    perm = rng.permutation(n).astype(np.int32)
    table = np.full((n_lists, lpad), -1, np.int32)
    at = 0
    for li, s in enumerate(sizes):
        table[li, :s] = perm[at:at + s]
        at += s
    source_ids = rng.permutation(3 * n)[:n].astype(np.int32)
    return table, source_ids


def test_filter_slot_table_and_make_slot_filter_match_jax(rng):
    table, source_ids = _padded_table(rng)
    id_bound = int(source_ids.max()) + 1
    mask = rng.random(id_bound) < 0.5
    jb, tb = jbs.Bitset.from_mask(mask), tbs.Bitset.from_mask(mask)
    want = np.asarray(jbs.filter_slot_table(jnp.asarray(table), jnp.asarray(source_ids), jb))
    got = tbs.filter_slot_table(torch.tensor(table), torch.tensor(source_ids), tb)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == -1).sum() > (table == -1).sum()  # the filter removed live slots
    # a table that holds the ids itself
    want = np.asarray(jbs.filter_slot_table(jnp.asarray(table), None,
                                            jbs.Bitset.from_mask(mask[:len(source_ids)])))
    got = tbs.filter_slot_table(torch.tensor(table), None,
                                tbs.Bitset.from_mask(mask[:len(source_ids)]))
    np.testing.assert_array_equal(got.numpy(), want)
    # bound to an index's id space, with and without a tombstone mask
    # narrower than the lane-padded table
    tomb = rng.random((table.shape[0], 40)) < 0.2
    for prefilter in (None, mask, tb):
        for tombstones in (None, tomb):
            if prefilter is None and tombstones is None:
                f = tbs.make_slot_filter(None, id_bound, torch.tensor(source_ids))
                t = torch.tensor(table)
                assert f(t) is t
                continue
            jf = jbs.make_slot_filter(jb if isinstance(prefilter, tbs.Bitset) else prefilter,
                                      id_bound, jnp.asarray(source_ids), tombstones=tombstones)
            tf = tbs.make_slot_filter(prefilter, id_bound, torch.tensor(source_ids),
                                      tombstones=tombstones)
            np.testing.assert_array_equal(tf(torch.tensor(table)).numpy(),
                                          np.asarray(jf(jnp.asarray(table))))
    with pytest.raises(ValueError, match="has 10 entries"):
        tbs.make_slot_filter(mask[:10], id_bound, torch.tensor(source_ids))


def test_carry_tombstones_matches_jax(rng):
    assert tbs.carry_tombstones(None, 64) is None
    t = rng.random((4, 32)) < 0.3
    for width in (16, 32, 96):
        np.testing.assert_array_equal(tbs.carry_tombstones(t, width).numpy(),
                                      np.asarray(jbs.carry_tombstones(t, width)))
