"""Bit-exact replica of glibc's default ``rand()`` (TYPE_3 additive feedback).

The reference's whole instance is fixed by ``srand(0)`` and a strictly
ordered sequence of ``rand()`` calls (tsp.cpp:273, assignment2.h:86-91), so
this generator is the determinism root of oracle parity. Host-side numpy:
the stream is sequential by construction and tiny next to the solve.

Algorithm (glibc stdlib/random_r.c): a 31-word additive-feedback generator
with taps at lags 3 and 31.

    seed 0 is mapped to 1;
    r[0]   = seed
    r[i]   = 16807 * r[i-1] mod 2147483647      for i in [1, 31)
    r[i]   = r[i-31]                            for i in [31, 34)
    r[i]   = (r[i-31] + r[i-3]) mod 2^32        for i >= 34
    the first 310 post-warmup words are discarded; each output is the next
    r[i] >> 1 (a 31-bit value).

Checked against the committed stream ``goldens/glibc_rand_seed0.json``.
"""

from __future__ import annotations

import numpy as np

_MOD31 = 2147483647  # 2^31 - 1
_MASK32 = 0xFFFFFFFF


class GlibcRand:
    """Sequential replica of glibc ``srand``/``rand``.

    >>> GlibcRand(0).next()  # first value of the reference's stream
    1804289383
    """

    def __init__(self, seed: int = 0):
        self.seed(seed)

    def seed(self, seed: int) -> None:
        seed = seed & _MASK32
        if seed == 0:
            seed = 1
        r = [0] * 344
        r[0] = seed
        # glibc seeds with int32 words and C division (truncation toward
        # zero), which differs from an unsigned `16807*r % (2^31-1)` when
        # the seed's int32 value is negative
        word = seed - (1 << 32) if seed >= (1 << 31) else seed
        for i in range(1, 31):
            hi = int(word / 127773)
            lo = word - hi * 127773
            word = 16807 * lo - 2836 * hi
            if word < 0:
                word += _MOD31
            r[i] = word
        for i in range(31, 34):
            r[i] = r[i - 31]
        for i in range(34, 344):
            r[i] = (r[i - 31] + r[i - 3]) & _MASK32
        self._window = r[344 - 31:]  # the lag-31 sliding window

    def next(self) -> int:
        w = self._window
        val = (w[0] + w[28]) & _MASK32  # lags: i-31 is w[0], i-3 is w[28]
        w.pop(0)
        w.append(val)
        return val >> 1

    def fill(self, n: int) -> np.ndarray:
        """Next ``n`` outputs as an int64 array (values fit in 31 bits)."""
        out = np.empty(n, dtype=np.int64)
        w = self._window
        for i in range(n):
            val = (w[0] + w[28]) & _MASK32
            w.pop(0)
            w.append(val)
            out[i] = val >> 1
        return out

    def frand(self, fmin: float, fmax: float) -> float:
        """The reference's ``fRand`` (assignment2.h:86-91):
        ``fMin + ((double)rand() / RAND_MAX) * (fMax - fMin)``."""
        f = float(self.next()) / float(_MOD31)
        return fmin + f * (fmax - fmin)
