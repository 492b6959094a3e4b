"""Exact GF(p) arithmetic for the narrow field, on int64 tensor math.

Residues are stored as int32 tensors with 0 <= r < p < 2^30.  A product of
two residues is below 2^60, so every operation here widens to int64, forms
the exact product and reduces it with `%` — the reference's own "multiply
in u64, reduce % p" idiom.  The JAX package's 15-bit limb splits and
16-bit-limb Montgomery multiply exist only because the TPU has no 64-bit
integer datapath; they are not reproduced.  Only the canonical residues
have to match, and they do bit for bit.

The prime is capped at 2^30 - 35 like the reference (larger primes take
the wide field, ops/gfp_wide.py); p = 2 is a valid narrow field (the GF(2)
bitsliced path, models/lanczos_gf2.py, needs n % 32 == 0).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

PRIME_CAP = 0x3FFFFFDD  # 2^30 - 35, same cap as the reference
LAZY_FOLD = 8  # csrc/modp.cuh: raw products summed between two reductions


def _invmod_int(a: int, m: int) -> int:
    """Host modular inverse (extended Euclid) over Python ints."""
    t, nt, r, nr = 0, 1, m, a % m
    while nr != 0:
        q = r // nr
        t, nt = nt, t - q * nt
        r, nr = nr, r - q * nr
    if r != 1:
        raise ValueError(f"{a} is not invertible mod {m}")
    return t % m


@dataclasses.dataclass(frozen=True)
class GFp:
    """The narrow field GF(p), 2 <= p <= 2^30 - 35."""

    p: int

    @staticmethod
    def make(p: int) -> "GFp":
        p = int(p)
        if p < 2:
            raise ValueError("p must be >= 2")
        if p > PRIME_CAP:
            raise ValueError(f"p is capped at 2**30 - 35 (got {p})")
        if p % 2 == 0 and p != 2:
            raise ValueError("p must be prime; the only even prime is 2")
        return GFp(p=p)

    def invmod(self, a: int) -> int:
        return _invmod_int(int(a), self.p)


@functools.lru_cache(maxsize=None)
def barrett_mu(p: int) -> int:
    """floor(2^64 / p): the constant that csrc/modp.cuh::barrett_reduce
    takes with p, computed once per prime."""
    p = int(p)
    if not 2 <= p < 1 << 63:
        raise ValueError(f"Barrett reduction needs 2 <= p < 2^63 (got {p})")
    return (1 << 64) // p


# ---------------------------------------------------------------------------
# Elementwise field ops on tensors of residues (any integer dtype in, the
# wider of int64 out).  Inputs must already lie in [0, p).
# ---------------------------------------------------------------------------

def _i64(a) -> torch.Tensor:
    return torch.as_tensor(a).to(torch.int64)


def modadd(f: GFp, a, b) -> torch.Tensor:
    return (_i64(a) + _i64(b)) % f.p


def modsub(f: GFp, a, b) -> torch.Tensor:
    return (_i64(a) - _i64(b)) % f.p


def modneg(f: GFp, a) -> torch.Tensor:
    return (-_i64(a)) % f.p


def modmul(f: GFp, a, b) -> torch.Tensor:
    return (_i64(a) * _i64(b)) % f.p


def modpow(f: GFp, a, e: int) -> torch.Tensor:
    """a^e mod p elementwise, e a Python int >= 0 (square-and-multiply)."""
    base = _i64(a) % f.p
    acc = torch.ones_like(base)
    for bit in bin(int(e))[2:]:
        acc = acc * acc % f.p
        if bit == "1":
            acc = acc * base % f.p
    return acc


def modinv(f: GFp, a) -> torch.Tensor:
    """a^-1 mod p via Fermat (a^(p-2)); 0 maps to 0 for p > 2 and to 1 for
    p = 2, matching the JAX package's contract to only invert pivots that
    were tested nonzero."""
    return modpow(f, a, f.p - 2)


# ---------------------------------------------------------------------------
# NumPy oracle (host, exact via uint64) — used by the checker and tests
# ---------------------------------------------------------------------------

def np_matmul_mod(p: int, A, B):
    """Exact (A @ B) mod p on host for residue inputs; reduces per k-step."""
    A = A.astype(np.uint64)
    B = B.astype(np.uint64)
    K = A.shape[-1]
    C = np.zeros(A.shape[:-1] + B.shape[1:], np.uint64)
    for k in range(K):  # products < 2^60; one addition then reduce: exact
        C = (C + A[..., k:k + 1] * B[k]) % np.uint64(p)
    return C.astype(np.uint32)


# ---------------------------------------------------------------------------
# Mirrors of the kernels' arithmetic (csrc/modp.cuh), step for step, so the
# CPU tests can hold it against `%` and `pow`.
# ---------------------------------------------------------------------------

_M32 = np.uint64(0xFFFFFFFF)
_S32 = np.uint64(32)


def umul64hi_np(a, b) -> np.ndarray:
    """The high word of the 128-bit product of uint64 arrays (CUDA's
    __umul64hi), from 32-bit halves; no intermediate exceeds 2^64."""
    a, b = np.asarray(a, np.uint64), np.asarray(b, np.uint64)
    a_lo, a_hi, b_lo, b_hi = a & _M32, a >> _S32, b & _M32, b >> _S32
    lh, hl = a_lo * b_hi, a_hi * b_lo
    mid = ((a_lo * b_lo) >> _S32) + (lh & _M32) + (hl & _M32)  # < 3 * 2^32
    return a_hi * b_hi + (lh >> _S32) + (hl >> _S32) + (mid >> _S32)


def barrett_reduce_np(x, p: int) -> np.ndarray:
    """x mod p for uint64 x, as csrc/modp.cuh::barrett_reduce computes it:
    q = hi(x * mu), r = x - q * p in [0, 2p), one conditional subtract."""
    x = np.asarray(x, np.uint64)
    P = np.uint64(p)
    q = umul64hi_np(x, np.uint64(barrett_mu(p)))
    r = x - q * P
    assert (r < 2 * P).all(), "Barrett remainder out of [0, 2p)"
    return r - P * (r >= P)


def barrett_reduce32_np(x, p: int) -> np.ndarray:
    """x mod p for uint32 x, as csrc/modp.cuh::barrett_reduce32 computes it
    (psum_mod's fold of int32 sums): m = mu >> 32, q = hi32(x * m),
    r = x - q * p in [0, 2p), one conditional subtract."""
    x = np.asarray(x, np.uint64)
    assert (x < np.uint64(1 << 32)).all(), "x >= 2^32"
    P = np.uint64(p)
    q = (x * np.uint64(barrett_mu(p) >> 32)) >> np.uint64(32)
    r = (x - q * P) & np.uint64(0xFFFFFFFF)     # the u32 arithmetic
    assert (r < 2 * P).all(), "32-bit Barrett remainder out of [0, 2p)"
    return (r - P * (r >= P)).astype(np.uint32)


def short_barrett(p: int) -> tuple[int, int]:
    """(k, mu_k): the bit length of p and floor(2^(2k) / p), as
    csrc/modp.cuh::short_barrett derives them from mu on the device."""
    k = int(p).bit_length()
    return k, barrett_mu(p) >> (64 - 2 * k)


def reduce_short_np(x, p: int) -> np.ndarray:
    """x mod p for uint64 x < 2^(2k+1), as csrc/modp.cuh::reduce_short
    computes it: 32x32-bit multiplies, r = x - q * p in [0, 4p), two
    conditional subtracts."""
    x = np.asarray(x, np.uint64)
    k, mu_k = short_barrett(p)
    assert (x < np.uint64(1 << (2 * k + 1))).all(), "x >= 2^(2k+1)"
    P = np.uint64(p)
    q1 = x >> np.uint64(k - 1)
    assert (q1 < np.uint64(1 << 32)).all()
    q = (q1 * np.uint64(mu_k)) >> np.uint64(k + 1)
    r = x - q * P
    assert (r < 4 * P).all(), "short Barrett remainder out of [0, 4p)"
    r = r - 2 * P * (r >= 2 * P)
    return r - P * (r >= P)


def inv_fermat_np(a, p: int) -> np.ndarray:
    """a^(p-2) mod p for residues 0 < a < p, as csrc/modp.cuh::inv_fermat
    computes it: right-to-left square-and-multiply on short-Barrett products
    (p = 2: the exponent is 0 and the result 1)."""
    base = np.asarray(a, np.uint64).copy()
    r = np.ones_like(base)
    e = p - 2
    while e:
        if e & 1:
            r = reduce_short_np(r * base, p)
        base = reduce_short_np(base * base, p)
        e >>= 1
    return r


def lazy_dot_int(p: int, a, b, base: int = 0) -> int:
    """(base + sum a[k] * b[k]) mod p over residues, as the kernels sum it:
    raw products added to a u64 accumulator that starts at the reduced
    base and is reduced once every LAZY_FOLD products and at the end.
    Python ints; asserts that the accumulator never leaves u64."""
    assert 0 <= base < p
    acc = base
    for k, (x, y) in enumerate(zip(a, b)):
        acc += int(x) * int(y)
        assert acc < 1 << 64, "lazy sum left u64"
        if k % LAZY_FOLD == LAZY_FOLD - 1:
            acc = int(barrett_reduce_np(acc, p))
    return int(barrett_reduce_np(acc, p))


# ---------------------------------------------------------------------------
# The tensor-core paths (csrc/mma_u8.cuh): u8 limbs, s32 shift classes
# ---------------------------------------------------------------------------

MMA_FOLD_ROWS = 8192  # csrc/mma_u8.cuh: rows between two recombinations
LIMB_CLASSES = 7      # shift classes s = i + j of four u8 limbs each
_LIMB_MAX = 255


def limb_weights_np(p: int) -> list:
    """2^(8s) mod p for s = 0..6, as csrc/mma_u8.cuh::limb_weights forms
    them: c0 = 1 mod p, then c_s = (c_{s-1} << 8) mod p by Barrett."""
    c = [int(barrett_reduce_np(1, p))]
    for _ in range(1, LIMB_CLASSES):
        c.append(int(barrett_reduce_np(c[-1] << 8, p)))
    return c


def limb_classes_np(A, B) -> np.ndarray:
    """The tensor cores' s32 sums of A @ B over u8 limbs: S[s] = sum over
    i + j = s of A_i @ B_j, A_i the i-th byte of A's residues.  Returns
    (7, M, N) int64 and asserts that every class fits s32, as the bound of
    csrc/mma_u8.cuh (4 K 255^2 < 2^31, K <= 8256) guarantees."""
    A, B = np.asarray(A, np.int64), np.asarray(B, np.int64)
    assert ((A >= 0) & (A < 1 << 30)).all() and \
        ((B >= 0) & (B < 1 << 30)).all(), "residues must be below 2^30"
    K = A.shape[1]
    assert 4 * K * _LIMB_MAX ** 2 < 1 << 31, "contraction too long for s32"
    la = [(A >> (8 * i)) & 0xFF for i in range(4)]
    lb = [(B >> (8 * j)) & 0xFF for j in range(4)]
    S = np.zeros((LIMB_CLASSES, A.shape[0], B.shape[1]), np.int64)
    for i in range(4):
        for j in range(4):
            S[i + j] += la[i] @ lb[j]
    assert ((S >= 0) & (S < 1 << 31)).all(), "an s32 class overflowed"
    return S


def limb_recombine_np(S, p: int, base=None) -> np.ndarray:
    """(base + sum_s S[s] * (2^(8s) mod p)) mod p, as
    csrc/mma_u8.cuh::limb_recombine forms it: one u64 sum (asserted below
    2^64 on Python ints), then one barrett_reduce."""
    c = limb_weights_np(p)
    x = np.zeros(S.shape[1:], object) if base is None \
        else np.asarray(base, np.uint64).astype(object)
    assert all(0 <= int(v) < p for v in x.flat), "base must be reduced"
    for s in range(LIMB_CLASSES):
        x = x + S[s].astype(object) * c[s]
    assert all(int(v) < 1 << 64 for v in x.flat), "the u64 sum wrapped"
    return barrett_reduce_np(x.astype(np.uint64), p)


def limb_matmul_np(A, B, p: int, base=None) -> np.ndarray:
    """(base + A @ B) mod p through the tensor-core arithmetic: one
    contraction of K <= 8256 (orthogonalize: K = 2n)."""
    return limb_recombine_np(limb_classes_np(A, B), p, base)


def mma_gram_np(X, W, p: int, fold_rows: int = MMA_FOLD_ROWS) -> np.ndarray:
    """X^T W mod p as the tensor-core Gram sums it over rows: shift-class
    sums over at most fold_rows rows, recombined into a running residue."""
    X, W = np.asarray(X), np.asarray(W)
    acc = np.zeros((X.shape[1], W.shape[1]), np.uint64)
    for r0 in range(0, X.shape[0], fold_rows):
        S = limb_classes_np(X[r0:r0 + fold_rows].T, W[r0:r0 + fold_rows])
        acc = limb_recombine_np(S, p, acc)
    return acc


def warp_reduce_scatter_np(vals, p: int) -> np.ndarray:
    """The gram_mod row path's warp reduction, step for step.  vals[lane,
    o] holds 16 values below p per lane (lane L's block is L & 1: the even
    lanes hold V1^T W, the odd ones V2^T W).  Four shuffle steps over lanes
    of one parity (offsets 16, 8, 4, 2) each halve the values a lane holds,
    adding mod p with one conditional subtract (u32: both addends < p <
    2^30); lane L ends with output L >> 1 of its block, summed over the 16
    lanes of its parity."""
    val = np.array(vals, np.int64)
    assert val.shape == (32, 16) and ((val >= 0) & (val < p)).all()
    lanes = np.arange(32)
    off = 16
    while off >= 2:
        upper = (lanes & off) != 0
        half = off >> 1
        new = val.copy()
        for i in range(half):
            send = np.where(upper, val[:, i], val[:, i + half])
            keep = np.where(upper, val[:, i + half], val[:, i])
            s = keep + send[lanes ^ off]
            assert (s < 1 << 32).all()
            new[:, i] = np.where(s >= p, s - p, s)
        val = new
        off >>= 1
    return val[:, 0]
