"""xoshiro256+ PRNG — bit-exact reproduction of the reference's generator.

The reference seeds one global xoshiro256+ with a fixed seed and draws
`random64() % prime` row-major over the initial vector block
(reference: sequential/lanczos_modp.c:67-87 and :624-625).  Matching that
stream exactly is the anchor for bit-identical iterates across the whole
solve.  Pure Python ints; the generator is sequential by nature.
"""

from __future__ import annotations

import numpy as np

MASK64 = (1 << 64) - 1

# The reference's fixed seed (the reproducibility anchor;
# reference: sequential/lanczos_modp.c:67).
DEFAULT_SEED = (0x1415926535, 0x8979323846, 0x2643383279, 0x5028841971)


class Xoshiro256Plus:
    def __init__(self, seed=DEFAULT_SEED):
        self.state = [int(s) & MASK64 for s in seed]

    def next64(self) -> int:
        return int(self.fill_u64(1)[0])

    def fill_u64(self, count: int) -> list:
        """The next `count` raw 64-bit outputs (advances the state)."""
        s0, s1, s2, s3 = self.state
        out = [0] * count
        for k in range(count):
            x = (s0 + s3) & MASK64
            out[k] = (((x << 23) | (x >> 41)) + s0) & MASK64
            t = (s1 << 17) & MASK64
            s2 ^= s0
            s3 ^= s1
            s1 ^= s2
            s0 ^= s3
            s2 ^= t
            s3 = ((s3 << 45) | (s3 >> 19)) & MASK64
        self.state = [s0, s1, s2, s3]
        return out

    def fill_mod(self, count: int, prime: int) -> np.ndarray:
        """Draw `count` values of random64() % prime as uint32."""
        out = np.empty(count, np.uint32)
        step = 1 << 20  # bounds the transient list of Python ints
        for lo in range(0, count, step):
            hi = min(lo + step, count)
            out[lo:hi] = [r % prime for r in self.fill_u64(hi - lo)]
        return out
