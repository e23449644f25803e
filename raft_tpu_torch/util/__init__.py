"""Host-side utilities (counterpart of raft_tpu/util; the reference's
`util/`): the power-of-two tiling math (`util/pow2_utils.cuh`), integer
helpers (`util/integer_utils.hpp`), a host LRU cache (`util/cache.cuh:34`
role) and the prime sieve (`util/seive.hpp`). The port keeps its own
copy of these pure-Python helpers.
"""

from __future__ import annotations

import collections
import threading
from typing import Any, Hashable, Iterator, Optional

__all__ = [
    "Pow2",
    "ceil_div",
    "round_up_safe",
    "round_down_safe",
    "is_pow2",
    "next_pow2",
    "prev_pow2",
    "log2_int",
    "LRUCache",
    "Sieve",
]


def ceil_div(a: int, b: int) -> int:
    """ceil(a/b) for non-negative ints (util/integer_utils.hpp ceildiv)."""
    if b <= 0:
        raise ValueError("divisor must be positive")
    return -(-a // b)


def round_up_safe(a: int, multiple: int) -> int:
    """Smallest multiple of `multiple` >= a (util/integer_utils.hpp)."""
    return ceil_div(a, multiple) * multiple


def round_down_safe(a: int, multiple: int) -> int:
    if multiple <= 0:
        raise ValueError("multiple must be positive")
    return a // multiple * multiple


def is_pow2(v: int) -> bool:
    return v > 0 and (v & (v - 1)) == 0


def next_pow2(v: int) -> int:
    """Smallest power of two >= v."""
    if v <= 1:
        return 1
    return 1 << (v - 1).bit_length()


def prev_pow2(v: int) -> int:
    """Largest power of two <= v."""
    if v < 1:
        raise ValueError("v must be >= 1")
    return 1 << (v.bit_length() - 1)


def log2_int(v: int) -> int:
    if not is_pow2(v):
        raise ValueError(f"{v} is not a power of two")
    return v.bit_length() - 1


class Pow2:
    """Power-of-two alignment math (util/pow2_utils.cuh `Pow2<Value>`).

    The same quotient/remainder/round/align helpers the reference uses for
    warp- and tile-granularity math.
    """

    def __init__(self, value: int):
        if not is_pow2(value):
            raise ValueError(f"Pow2 value must be a power of two, got {value}")
        self.value = value
        self.mask = value - 1
        self.log2 = log2_int(value)

    def quot(self, x: int) -> int:
        return x >> self.log2

    def rem(self, x: int) -> int:
        return x & self.mask

    def div(self, x: int) -> tuple[int, int]:
        return self.quot(x), self.rem(x)

    def round_up(self, x: int) -> int:
        return (x + self.mask) & ~self.mask

    def round_down(self, x: int) -> int:
        return x & ~self.mask

    def is_aligned(self, x: int) -> bool:
        return (x & self.mask) == 0


class LRUCache:
    """Thread-safe host LRU cache (util/cache.cuh:34 `cache::Cache` role).

    The reference caches device buffers keyed by integer ids with
    set-associative eviction; here a plain LRU memoizes host-side
    artifacts.
    """

    def __init__(self, capacity: int = 128):
        if capacity <= 0:
            raise ValueError("capacity must be positive")
        self.capacity = capacity
        self._store: "collections.OrderedDict[Hashable, Any]" = collections.OrderedDict()
        self._lock = threading.Lock()
        self.hits = 0
        self.misses = 0

    def get(self, key: Hashable, default: Any = None) -> Any:
        with self._lock:
            if key in self._store:
                self._store.move_to_end(key)
                self.hits += 1
                return self._store[key]
            self.misses += 1
            return default

    def put(self, key: Hashable, value: Any) -> None:
        with self._lock:
            if key in self._store:
                self._store.move_to_end(key)
            self._store[key] = value
            while len(self._store) > self.capacity:
                self._store.popitem(last=False)

    def __contains__(self, key: Hashable) -> bool:
        with self._lock:
            return key in self._store

    def __len__(self) -> int:
        with self._lock:
            return len(self._store)


class Sieve:
    """Prime sieve (util/seive.hpp) — odd-only bitset of primes up to n."""

    def __init__(self, n: int):
        self.n = n
        size = max(0, (n + 1) // 2)
        self._odd = bytearray([1]) * size if size else bytearray()
        if size:
            self._odd[0] = 0  # 1 is not prime
        i = 3
        while i * i <= n:
            if self._odd[i // 2]:
                for j in range(i * i, n + 1, 2 * i):
                    self._odd[j // 2] = 0
            i += 2

    def is_prime(self, v: int) -> bool:
        if v == 2:
            return self.n >= 2
        if v < 2 or v % 2 == 0 or v > self.n:
            return False
        return bool(self._odd[v // 2])

    def primes(self) -> Iterator[int]:
        if self.n >= 2:
            yield 2
        for v in range(3, self.n + 1, 2):
            if self._odd[v // 2]:
                yield v
