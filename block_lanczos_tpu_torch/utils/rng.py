"""xoshiro256+ PRNG — bit-exact reproduction of the reference's generator.

The reference seeds one global xoshiro256+ with a fixed seed and draws
`random64() % prime` row-major over the initial vector block
(reference: sequential/lanczos_modp.c:67-87 and :624-625).  Matching that
stream exactly is the anchor for bit-identical iterates across the whole
solve.  Pure Python ints; long draws run the same stream as many
generators side by side in NumPy, each jumped ahead by a power of the
step's bit matrix (`fill_mod`).
"""

from __future__ import annotations

import functools

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
        return self._fill(count, prime, np.uint32)

    def fill_mod64(self, count: int, prime: int) -> np.ndarray:
        """The same stream as fill_mod, kept whole as uint64: the wide
        field's v0 (p < 2^62).  At a narrow prime the values equal
        fill_mod's."""
        return self._fill(count, prime, np.uint64)

    def _fill(self, count: int, prime: int, dtype) -> np.ndarray:
        """`count` values of random64() % prime as `dtype`.

        The stream is drawn by up to LANES generators side by side in
        NumPy.  The state update is linear over GF(2), so the state m draws
        ahead is T^m times the state, T the 256 x 256 bit matrix of one
        step: lane l starts at T^(l m) s and draws the m values
        l m .. l m + m - 1 of the stream; the generator then holds the
        state after the last value, as if it had drawn them one by one."""
        if count == 0:
            return np.zeros(0, dtype)
        lanes = min(LANES, count)
        m = -(-count // lanes)
        S = np.zeros((256, lanes), np.float32)
        S[:, 0] = _state_bits(self.state)
        jump, done = _bit_matrix_power(_transition(), m), 1
        while done < lanes:         # lanes [done, 2 done) from [0, done)
            k = min(done, lanes - done)
            S[:, done:done + k] = (jump @ S[:, :k]) % 2
            jump = (jump @ jump) % 2
            done += k
        s0, s1, s2, s3 = (_bits_to_u64(S[64 * w:64 * w + 64])
                          for w in range(4))
        out = np.empty((m, lanes), dtype)
        last, tail = divmod(count, m)          # the stream ends in lane
        if tail == 0:                          # `last` after `tail` draws
            last, tail = last - 1, m
        p = np.uint64(prime)
        for k in range(m):
            if k == tail:
                self.state = [int(s[last]) for s in (s0, s1, s2, s3)]
            x = s0 + s3
            out[k] = (((x << _U23) | (x >> _U41)) + s0) % p
            t = s1 << _U17
            s2 ^= s0
            s3 ^= s1
            s1 ^= s2
            s0 ^= s3
            s2 ^= t
            s3 = (s3 << _U45) | (s3 >> _U19)
        if tail == m:
            self.state = [int(s[last]) for s in (s0, s1, s2, s3)]
        return np.ascontiguousarray(out.T).reshape(-1)[:count]


# Generators fill_mod runs side by side: one at a time, in Python ints, a
# draw takes about a microsecond, ~50 s for the 300000 x 128 v0 of a GF(2)
# solve at n = 128.
LANES = 4096
_U17, _U19, _U23, _U41, _U45 = (np.uint64(k) for k in (17, 19, 23, 41, 45))


def _state_bits(state) -> np.ndarray:
    """The 256-bit state as 0/1: bit k of word w at index 64 w + k."""
    return np.array([(int(s) >> k) & 1 for s in state for k in range(64)],
                    np.float32)


def _bits_to_u64(bits: np.ndarray) -> np.ndarray:
    """(64, L) 0/1 -> (L,) uint64 words (bit k from row k)."""
    shifts = np.arange(64, dtype=np.uint64)[:, None]
    return (bits.astype(np.uint64) << shifts).sum(axis=0, dtype=np.uint64)


@functools.lru_cache(maxsize=1)
def _transition() -> np.ndarray:
    """T: column c is the state one step after the state with bit c alone
    (the step is linear over GF(2)), as a float32 0/1 matrix."""
    T = np.zeros((256, 256), np.float32)
    for c in range(256):
        state = [0, 0, 0, 0]
        state[c // 64] = 1 << (c % 64)
        g = Xoshiro256Plus(state)
        g.fill_u64(1)
        T[:, c] = _state_bits(g.state)
    return T


def _bit_matrix_power(A: np.ndarray, e: int) -> np.ndarray:
    """A^e over GF(2), by squaring; float32 products of 0/1 matrices are
    exact (sums of at most 256 ones)."""
    R = np.eye(A.shape[0], dtype=np.float32)
    while e:
        if e & 1:
            R = (R @ A) % 2
        A = (A @ A) % 2
        e >>= 1
    return R
