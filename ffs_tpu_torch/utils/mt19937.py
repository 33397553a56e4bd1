"""C++-std::mt19937-compatible generator and the reference's random
subsample selection.

The reference's pre-refinement sampling uses std::mt19937 with seed 43
(reference: baseline/indexer/reflection_filter.cc:31-48); NumPy's MT19937
seeding differs, so this is a direct implementation of the classic
init_genrand + tempering so subsamples match the reference bit-for-bit.
"""

from __future__ import annotations

import numpy as np

_N = 624
_M = 397
_MATRIX_A = 0x9908B0DF
_UPPER = 0x80000000
_LOWER = 0x7FFFFFFF


class MT19937Cpp:
    def __init__(self, seed: int = 5489):
        mt = np.empty(_N, dtype=np.uint64)
        mt[0] = seed & 0xFFFFFFFF
        for i in range(1, _N):
            mt[i] = (1812433253 * (mt[i - 1] ^ (mt[i - 1] >> np.uint64(30))) + i) & np.uint64(
                0xFFFFFFFF
            )
        self._mt = mt.astype(np.uint32)
        self._index = _N

    def _generate(self):
        mt = self._mt.astype(np.uint64)
        for i in range(_N):
            y = (mt[i] & _UPPER) | (mt[(i + 1) % _N] & _LOWER)
            nxt = mt[(i + _M) % _N] ^ (y >> np.uint64(1))
            if y & np.uint64(1):
                nxt ^= np.uint64(_MATRIX_A)
            mt[i] = nxt
        self._mt = mt.astype(np.uint32)
        self._index = 0

    def __call__(self) -> int:
        if self._index >= _N:
            self._generate()
        y = int(self._mt[self._index])
        self._index += 1
        y ^= y >> 11
        y ^= (y << 7) & 0x9D2C5680
        y ^= (y << 15) & 0xEFC60000
        y ^= y >> 18
        return y & 0xFFFFFFFF


def random_selection(pop_size: int, sample_size: int, seed: int = 43) -> np.ndarray:
    """Random subsample of indices, matching reflection_filter.cc:31-48:
    a forward pass of swaps r[i] <-> r[mt() % pop], then truncate + sort."""
    mt = MT19937Cpp(seed)
    result = list(range(pop_size))
    for i in range(pop_size):
        j = mt() % pop_size
        result[i], result[j] = result[j], result[i]
    return np.sort(np.asarray(result[:sample_size], dtype=np.int64))
