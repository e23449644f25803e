"""CRC-32C (Castagnoli, reflected, init and final xor 0xFFFFFFFF) of each
row of a byte table, in plain NumPy: one table lookup a byte, all rows
in step, four bytes an iteration (slicing by four)."""

from __future__ import annotations

import numpy as np

_POLY = np.uint32(0x82F63B78)


def _tables() -> np.ndarray:
    t = np.zeros((4, 256), np.uint32)
    for b in range(256):
        c = np.uint32(b)
        for _ in range(8):
            c = (c >> np.uint32(1)) ^ (_POLY if c & np.uint32(1) else np.uint32(0))
        t[0, b] = c
    for j in range(1, 4):
        t[j] = (t[j - 1] >> np.uint32(8)) ^ t[0][t[j - 1] & np.uint32(0xFF)]
    return t


_T = _tables()


def crc32c_rows(rows: np.ndarray) -> np.ndarray:
    """(n,) uint32: the CRC-32C of each row's bytes of a C-contiguous
    (n, ...) array."""
    a = np.ascontiguousarray(rows)
    buf = a.reshape(a.shape[0], -1).view(np.uint8)
    n, m = buf.shape
    crc = np.full(n, 0xFFFFFFFF, np.uint32)
    whole = m - m % 4
    if whole:
        words = np.ascontiguousarray(buf[:, :whole]).view("<u4")
        for j in range(words.shape[1]):
            x = crc ^ words[:, j]
            crc = (_T[3][x & 0xFF] ^ _T[2][(x >> 8) & 0xFF]
                   ^ _T[1][(x >> 16) & 0xFF] ^ _T[0][x >> 24])
    for j in range(whole, m):
        crc = _T[0][(crc ^ buf[:, j]) & 0xFF] ^ (crc >> np.uint32(8))
    return crc ^ np.uint32(0xFFFFFFFF)
