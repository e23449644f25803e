"""Packed bitset over device memory, the sample-filter primitive
(counterpart of raft_tpu/core/bitset.py).

`n` logical bits pack 32 to a word, little-endian: bit i lives at word
i >> 5, lane i & 31. The JAX package holds the words as uint32; torch's
uint32 has few operations on the CPU and on CUDA alike, so the port holds
them as int32 with the same bits (a JAX bitset carries across as
`bits.view(np.int32)`, word for word). A lane is read as
`(w >> (i & 31)) & 1`, which an arithmetic shift leaves correct.

Mutators are functional: each returns a new Bitset. Ids outside [0, n)
test False and are dropped by the mutators.

`filter_slot_table` is the one filtering mechanism of every IVF engine:
each masks candidate scores to the worst value wherever its slot table
reads -1, before any trim or selection, so a filtered view of the table
is the whole prefilter (`make_slot_filter` binds it to an index).
"""

from __future__ import annotations

import numpy as np
import torch

_FULL_WORD = -1  # 0xFFFFFFFF as int32


def _words(n: int) -> int:
    return (int(n) + 31) // 32


def _tail_mask(n: int) -> int:
    """The valid lanes of the last word as an int32 value (all lanes: -1)."""
    tail = _words(n) * 32 - int(n)
    return _FULL_WORD if tail == 0 else (1 << (32 - tail)) - 1


def _to_int32_bits(v: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) to the int32 of the same 32 bits."""
    return torch.where(v >= (1 << 31), v - (1 << 32), v).to(torch.int32)


class Bitset:
    """`n` logical bits packed little-endian into int32 words (`bits`,
    ((n + 31) // 32,) on one device). Bits past n in the last word stay 0."""

    def __init__(self, bits, n: int):
        if isinstance(bits, np.ndarray):
            if bits.dtype == np.uint32:
                bits = bits.view(np.int32)
            bits = torch.tensor(np.array(bits))
        if bits.dtype != torch.int32 or bits.ndim != 1:
            raise ValueError(f"bitset words must be a 1-d int32 tensor, got {bits.dtype} "
                             f"ndim={bits.ndim}")
        if bits.shape[0] != _words(n):
            raise ValueError(f"{bits.shape[0]} words cannot hold exactly {n} bits")
        self.bits = bits
        self.n = int(n)

    @property
    def device(self) -> torch.device:
        return self.bits.device

    def to(self, device) -> "Bitset":
        return Bitset(self.bits.to(device), self.n)

    # -- constructors --
    @classmethod
    def full(cls, n: int, value: bool = True, device=None) -> "Bitset":
        """All-set (default) or all-clear bitset of `n` bits, on `device`
        (default: the card, `core.config.resolve_device`; raises without
        one unless device="cpu" is passed)."""
        from raft_tpu_torch.core.config import resolve_device

        device = resolve_device(device)
        bits = torch.full((_words(n),), _FULL_WORD if value else 0, dtype=torch.int32,
                          device=device)
        if value and bits.numel():
            bits[-1] = _tail_mask(n)  # the lanes past n stay clear, so count() is exact
        return cls(bits, n)

    @classmethod
    def from_mask(cls, mask, device=None) -> "Bitset":
        """Pack a boolean mask (mask[i] == bit i)."""
        if not isinstance(mask, torch.Tensor):
            mask = torch.as_tensor(np.asarray(mask))
        if device is not None:
            mask = mask.to(device)
        n = mask.shape[0]
        lanes = torch.nn.functional.pad(mask.to(torch.int64), (0, _words(n) * 32 - n))
        weights = torch.ones(32, dtype=torch.int64, device=mask.device) << torch.arange(
            32, device=mask.device)
        words = torch.sum(lanes.reshape(-1, 32) * weights[None, :], dim=1)
        return cls(_to_int32_bits(words), n)

    @classmethod
    def excluding(cls, n: int, ids, device=None) -> "Bitset":
        """All bits set except `ids` (the deleted-samples filter shape), on
        `device` as for `full`."""
        return cls.full(n, True, device).set(ids, False)

    # -- queries --
    def test(self, ids) -> torch.Tensor:
        """Bit value per id (bool, the shape of `ids`). Negative or >= n
        ids test False."""
        ids = torch.as_tensor(ids, device=self.device)
        if self.n == 0:
            return torch.zeros(ids.shape, dtype=torch.bool, device=self.device)
        in_range = (ids >= 0) & (ids < self.n)
        safe = torch.clamp(ids, 0, self.n - 1).long()
        word = self.bits[safe >> 5]
        return (((word >> (safe & 31)) & 1) == 1) & in_range

    def to_mask(self) -> torch.Tensor:
        """Unpack to a boolean mask of length n."""
        lanes = (self.bits[:, None] >> torch.arange(32, device=self.device)[None, :]) & 1
        return lanes.reshape(-1)[:self.n] == 1

    def count(self) -> torch.Tensor:
        """Number of set bits (an int32 scalar on the bitset's device)."""
        v = self.bits.to(torch.int64) & 0xFFFFFFFF
        v = v - ((v >> 1) & 0x55555555)
        v = (v & 0x33333333) + ((v >> 2) & 0x33333333)
        v = (v + (v >> 4)) & 0x0F0F0F0F
        return torch.sum(((v * 0x01010101) & 0xFFFFFFFF) >> 24).to(torch.int32)

    def __len__(self) -> int:
        return self.n

    # -- functional mutators --
    def set(self, ids, value: bool = True) -> "Bitset":
        """A new Bitset with `ids` set to `value` (duplicates fine; ids out
        of range dropped)."""
        ids = torch.as_tensor(ids, device=self.device).reshape(-1).long()
        if self.n == 0:
            return self
        mask = self.to_mask()
        mask[ids[(ids >= 0) & (ids < self.n)]] = bool(value)
        return Bitset.from_mask(mask)

    def flip(self) -> "Bitset":
        bits = ~self.bits
        if bits.numel():
            bits[-1] = bits[-1] & _tail_mask(self.n)
        return Bitset(bits, self.n)

    def _check_len(self, other: "Bitset") -> None:
        if self.n != other.n:
            raise ValueError(f"bitset length mismatch: {self.n} vs {other.n}")

    def __and__(self, other: "Bitset") -> "Bitset":
        self._check_len(other)
        return Bitset(self.bits & other.bits.to(self.device), self.n)

    def __or__(self, other: "Bitset") -> "Bitset":
        self._check_len(other)
        return Bitset(self.bits | other.bits.to(self.device), self.n)

    def __repr__(self):
        return f"Bitset(n={self.n}, device={self.device})"


def as_bitset(prefilter, n: int, device=None) -> Bitset:
    """Coerce a search `prefilter` (a Bitset or a 1-d boolean mask of
    length `n`, the index's id space) into a Bitset on `device`, checking
    the length (a short filter would quietly exclude every tail sample)."""
    if isinstance(prefilter, Bitset):
        if prefilter.n != n:
            raise ValueError(f"prefilter covers {prefilter.n} ids but the index has {n}")
        return prefilter if device is None else prefilter.to(device)
    mask = prefilter if isinstance(prefilter, torch.Tensor) else torch.as_tensor(
        np.asarray(prefilter))
    if mask.dtype != torch.bool or mask.ndim != 1:
        raise ValueError("prefilter must be a Bitset or a 1-D boolean mask, got "
                         f"{mask.dtype} ndim={mask.ndim}")
    if mask.shape[0] != n:
        raise ValueError(f"prefilter mask has {mask.shape[0]} entries but the index has {n}")
    return Bitset.from_mask(mask, device)


def _filter_slot_table_ids(slot_rows: torch.Tensor, ids: torch.Tensor,
                           bitset: Bitset) -> torch.Tensor:
    keep = bitset.test(ids) & (slot_rows >= 0)
    return torch.where(keep, slot_rows, -1).to(slot_rows.dtype)


def filter_slot_table(slot_rows: torch.Tensor, source_ids, bitset: Bitset) -> torch.Tensor:
    """The slot table with filtered-out samples turned into pad (-1).
    `source_ids` maps slot values (source positions) to the ids the filter
    speaks; None when the table holds those ids itself."""
    pos = torch.clamp(slot_rows, min=0).long()
    ids = pos if source_ids is None else source_ids[pos]
    return _filter_slot_table_ids(slot_rows, ids, bitset)


def make_slot_filter(prefilter, id_bound: int, source_ids, tombstones=None):
    """Bind a search `prefilter` to an index's id space: returns the
    `maybe_filter(slot_rows)` callable that a search applies to each
    engine's slot table (the identity when there is neither a prefilter
    nor tombstones). `id_bound` is one past the largest id the index can
    return (`index.id_bound`: ids given to extend live past `size`).

    `tombstones` is an optional (n_lists, max_list) dead-slot mask
    (nonzero = dead), applied before the prefilter and aware of a
    lane-padded table (wider than the mask: its pad columns already read
    -1)."""
    if prefilter is None and tombstones is None:
        return lambda sr: sr
    device = None if source_ids is None else source_ids.device
    bs = as_bitset(prefilter, id_bound, device) if prefilter is not None else None

    def maybe_filter(slot_rows):
        sr = slot_rows
        if tombstones is not None:
            t = torch.as_tensor(tombstones, device=sr.device).bool()
            if t.shape[1] < sr.shape[1]:
                t = torch.nn.functional.pad(t, (0, sr.shape[1] - t.shape[1]))
            sr = torch.where(t, -1, sr).to(sr.dtype)
        if bs is not None:
            sr = filter_slot_table(sr, source_ids, bs)
        return sr

    return maybe_filter


def carry_tombstones(tombstones, new_width: int):
    """Carry an index's dead-slot mask across a store regrow (extend, lane
    padding): new tail columns are live appends, so the mask pads with
    False. None (all live) stays None."""
    if tombstones is None:
        return None
    t = torch.as_tensor(tombstones).bool()
    if new_width > t.shape[1]:
        t = torch.nn.functional.pad(t, (0, new_width - t.shape[1]))
    return t
