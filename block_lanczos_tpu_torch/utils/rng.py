"""xoshiro256+ PRNG — bit-exact reproduction of the reference's generator.

The reference seeds one global xoshiro256+ with a fixed seed and draws
`random64() % prime` row-major over the initial vector block
(reference: sequential/lanczos_modp.c:67-87 and :624-625).  Matching that
stream exactly is the anchor for bit-identical iterates across the whole
solve.  Pure Python ints; long draws (`fill_mod`) run the same stream
in lanes of m values, as many NumPy generators side by side, each started
from the jump matrices T^(m 2^k) at the set bits of its lane's index.  On
a CUDA device the solvers draw v0 on the card in the same lanes, from the
same matrices (ops/xoshiro.py, the kernel csrc/xoshiro_fill.cu).
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
        """`count` values of random64() % prime as `dtype`, drawn by
        `draw_lanes` in the lanes of `lane_plan` (the card's lanes too:
        ops/xoshiro.py); the generator then holds the state after the last
        value, as if it had drawn them one by one."""
        if count == 0:
            return np.zeros(0, dtype)
        m, lanes = lane_plan(count)
        p = np.uint64(prime)
        out, self.state = draw_lanes(
            self.state, jump_columns(m, (lanes - 1).bit_length()), count, m,
            lambda x: x % p, dtype)
        return out


# The most lanes a draw runs side by side, on the host (NumPy generators, a
# vector op a step each) as on the card (csrc/xoshiro_fill.cu).  A lane
# costs up to log2(lanes) mat-vecs of 256 x 256 bits before its first draw,
# so more lanes trade draws for jumps.  Swept from 2^10 to 2^18 on the H100
# (PERF.md): 2^14 was the fastest at the GF(2) cell's 64M draws (16,261
# lanes of 3,936, 0.288 ms against 0.331 at 2^16) and within 2% of the
# fastest at 100,000 x 32; at 100,000 x 4 the 12,500 lanes of 32 it gives
# take 0.24 ms, the jumps' latency.
LANES = 1 << 14
_U17, _U19, _U23, _U41, _U45 = (np.uint64(k) for k in (17, 19, 23, 41, 45))


def _next_np(g: list) -> np.ndarray:
    """One step of generators side by side: g = [s0, s1, s2, s3], uint64
    arrays of their states, updated in place; returns their outputs."""
    s0, s1, s2, s3 = g
    x = s0 + s3
    out = ((x << _U23) | (x >> _U41)) + s0
    t = s1 << _U17
    s2 ^= s0
    s3 ^= s1
    s1 ^= s2
    s0 ^= s3
    s2 ^= t
    g[3] = (s3 << _U45) | (s3 >> _U19)
    return out


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


# ---------------------------------------------------------------------------
# Lanes: the stream split into runs of m values, each from its own start state
# ---------------------------------------------------------------------------

def lane_plan(count: int) -> tuple:
    """(m, L): a draw of `count` values as L <= LANES lanes of m values each
    (the last one fewer), m the least multiple of 32 for which LANES lanes
    hold them all (so a lane of the card's GF(2) draw owns whole words)."""
    m = 32 * max(1, -(-count // (32 * LANES)))
    return m, max(1, -(-count // m))


@functools.lru_cache(maxsize=8)
def _step_power(e: int) -> np.ndarray:
    """T^e over GF(2) (float32 0/1), kept for the counts and lane lengths
    of the solvers in this process."""
    return _bit_matrix_power(_transition(), e)


@functools.lru_cache(maxsize=8)
def jump_columns(m: int, levels: int) -> np.ndarray:
    """J_k = T^(m 2^k) for k < levels as the kernel reads them: (levels,
    256, 4) uint64, [k, c, w] holding bits 64 w .. 64 w + 63 of column c
    of J_k (the state that state bit c alone reaches)."""
    out = np.empty((levels, 256, 4), np.uint64)
    if levels:
        J = _step_power(m)
        for k in range(levels):
            for w in range(4):
                out[k, :, w] = _bits_to_u64(J[64 * w:64 * w + 64])
            J = (J @ J) % 2
    return out


def lane_starts(state, jumps: np.ndarray, lanes: int) -> list:
    """The lanes' start states, [s0, s1, s2, s3] uint64 arrays: lane l's is
    `state` under the J_k (`jumps`, as jump_columns gives them) of the set
    bits of l, as the kernel builds it.  The host shares the products:
    lane l + 2^k (l < 2^k) is J_k applied to lane l (the J_k commute), a
    mat-vec a lane; float32 products of 0/1 matrices are exact (sums of at
    most 256 ones)."""
    S = np.empty((256, lanes), np.float32)
    S[:, 0] = _state_bits(state)
    shifts = np.arange(64, dtype=np.uint64)
    for k, cols in enumerate(jumps):
        J = ((cols[:, :, None] >> shifts) & np.uint64(1)).reshape(256, 256)
        lo, hi = 1 << k, min(2 << k, lanes)
        S[:, lo:hi] = (J.T.astype(np.float32) @ S[:, :hi - lo]) % 2
    return [_bits_to_u64(S[64 * w:64 * w + 64]) for w in range(4)]


def draw_lanes(state, jumps: np.ndarray, count: int, m: int, reduce,
               dtype) -> tuple:
    """(values, state after): the stream's `count` values from `state`,
    each through `reduce` (uint64 array -> `dtype`), drawn by ceil(count /
    m) NumPy generators side by side, lane l from its `lane_starts` state
    drawing the values l m .. l m + m - 1; the state after them is the one
    the last value's lane holds after it."""
    lanes = -(-count // m)
    g = lane_starts(state, jumps, lanes)
    out = np.empty((m, lanes), dtype)
    last, tail = divmod(count, m)          # the stream ends in lane
    if tail == 0:                          # `last` after `tail` draws
        last, tail = last - 1, m
    for k in range(m):
        if k == tail:
            after = [int(s[last]) for s in g]
        out[k] = reduce(_next_np(g))
    if tail == m:
        after = [int(s[last]) for s in g]
    return np.ascontiguousarray(out.T).reshape(-1)[:count], after
