"""Exact GF(p) arithmetic for the wide field, 2^30 - 35 < p < 2^62.

Residues are held in int64 tensors: every residue is below p < 2^62, so it
is non-negative there, and the wide kernels (csrc/*_wide.cu) read the same
storage as `unsigned long long`.  The JAX package's (..., 2) uint32 pairs,
its 15-bit limb sums and its pair Montgomery multiply (ops/gfp_wide.py
there) exist only because the TPU has no 64-bit integer datapath; they are
not reproduced.  Only the canonical residues in [0, p) have to match, and
they do bit for bit.

Three layers:
  * `GFpWide`: p and the constants the kernels take with it (mu for the
    Barrett fold, -p^-1 mod 2^64 and 2^128 mod p for the Montgomery
    reduction, csrc/modp64.cuh), and a host inverse;
  * the plain PyTorch versions of the field's operations on int64 tensors.
    A product of two residues can reach 2^124, which int64 cannot hold, so
    `mulmod` splits both factors into 31-bit halves (every partial product
    is below 2^62) and recombines them mod p by Horner, shifting a residue
    left by as many bits as keep it below 2^63 (2 at p = 2^61 - 1, 1 at the
    largest 62-bit prime) and reducing with `%` after each shift.  Sums
    never hold more than two residues (< 2^63) unless `sum_mod` first splits
    them into 31-bit halves;
  * NumPy mirrors of the kernels' reduction steps (the 64 x 64 -> 128-bit
    product, the lazy 128-bit sums and their Barrett fold of the high word,
    REDC, the exact 128-bit reduction, Kaliski's binary inverse), of
    gram_wide's and orthogonalize_wide's u8-limb tensor-core sums, of
    orthogonalize_wide's Montgomery row path, of spmv_wide's narrow slab and
    of semi_inverse_wide's row-scaled elimination, step for step, with the
    bounds that the CUDA sources prove asserted, so that the CPU tests hold
    them against Python ints and the JAX package.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from block_lanczos_tpu_torch.ops.gfp import (_invmod_int, barrett_mu,
                                             barrett_reduce_np, umul64hi_np)

WIDE_PRIME_CAP = (1 << 62) - 1
WIDE_FOLD = 8  # csrc/modp64.cuh: raw products summed between two folds
_R = 1 << 64
_M31 = (1 << 31) - 1


@dataclasses.dataclass(frozen=True)
class GFpWide:
    """The field GF(p) for an odd prime 3 <= p < 2^62, with the constants
    of the kernels' reductions (csrc/modp64.cuh)."""

    p: int
    mu: int     # floor(2^64 / p): Barrett fold of a 128-bit sum's high word
    pinv: int   # -p^-1 mod 2^64: Montgomery REDC with R = 2^64
    r2: int     # 2^128 mod p: R^2, to leave the Montgomery scale

    @staticmethod
    def make(p: int) -> "GFpWide":
        p = int(p)
        if p < 3 or p % 2 == 0:
            raise ValueError("GFpWide requires an odd prime p >= 3")
        if p > WIDE_PRIME_CAP:
            raise ValueError(f"wide p is capped at 2**62 - 1 (got {p})")
        return GFpWide(p=p, mu=barrett_mu(p), pinv=(-_invmod_int(p, _R)) % _R,
                       r2=(_R * _R) % p)

    @property
    def kernel_args(self) -> tuple:
        """(p, mu, pinv, r2), in the order the wide kernels take them."""
        return self.p, self.mu, self.pinv, self.r2

    def invmod(self, a: int) -> int:
        return _invmod_int(int(a), self.p)


# ---------------------------------------------------------------------------
# Plain PyTorch field operations on int64 tensors of residues in [0, p)
# ---------------------------------------------------------------------------

def _i64(a) -> torch.Tensor:
    return torch.as_tensor(a).to(torch.int64)


def modadd(p: int, a, b) -> torch.Tensor:
    s = _i64(a) + _i64(b)                # < 2p < 2^63
    return torch.where(s >= p, s - p, s)


def modsub(p: int, a, b) -> torch.Tensor:
    d = _i64(a) - _i64(b)
    return torch.where(d < 0, d + p, d)


def modneg(p: int, a) -> torch.Tensor:
    a = _i64(a)
    return torch.where(a == 0, a, p - a)


def _shift_step(p: int) -> int:
    """The most bits a residue below p can be shifted left by and stay
    below 2^63."""
    return 63 - int(p).bit_length()


def shl_mod(p: int, x: torch.Tensor, bits: int) -> torch.Tensor:
    """x * 2^bits mod p for residues x, in steps that stay below 2^63."""
    step = _shift_step(p)
    while bits > 0:
        k = min(step, bits)
        x = (x << k) % p
        bits -= k
    return x


def mulmod(p: int, a, b) -> torch.Tensor:
    """a * b mod p elementwise (broadcasting), exact in int64: with
    a = a1 2^31 + a0 and b = b1 2^31 + b0, every partial product is below
    2^62 and a1 b0 + a0 b1 below 2^63; Horner in 2^31 recombines them."""
    a, b = _i64(a), _i64(b)
    a1, a0, b1, b0 = a >> 31, a & _M31, b >> 31, b & _M31
    x = shl_mod(p, (a1 * b1) % p, 31)
    x = modadd(p, x, (a1 * b0 + a0 * b1) % p)
    x = shl_mod(p, x, 31)
    return modadd(p, x, (a0 * b0) % p)


def modpow(p: int, a, e: int) -> torch.Tensor:
    """a^e mod p elementwise, e a Python int >= 0 (square-and-multiply)."""
    base = _i64(a)
    acc = torch.ones_like(base)
    for bit in bin(int(e))[2:]:
        acc = mulmod(p, acc, acc)
        if bit == "1":
            acc = mulmod(p, acc, base)
    return acc


def modinv(p: int, a) -> torch.Tensor:
    """a^-1 mod p by Fermat (a^(p-2)); 0 maps to 0."""
    return modpow(p, a, p - 2)


def sum_mod(p: int, x: torch.Tensor, dim: int = 0) -> torch.Tensor:
    """Exact sum of residues along `dim`, mod p: the residues are split
    into 31-bit halves, whose int64 sums are exact for up to 2^32 terms,
    then recombined."""
    if x.shape[dim] >= 1 << 32:
        raise ValueError("sum_mod sums at most 2^32 - 1 terms")
    hi = (x >> 31).sum(dim) % p
    lo = (x & _M31).sum(dim) % p
    return modadd(p, shl_mod(p, hi, 31), lo)


def index_add_mod(p: int, out_rows: int, index: torch.Tensor,
                  x: torch.Tensor) -> torch.Tensor:
    """(out_rows, ...) sums mod p of the rows of x by index (a scatter of
    residues), through the 31-bit halves as in `sum_mod`."""
    shape = (out_rows,) + tuple(x.shape[1:])
    hi = torch.zeros(shape, dtype=torch.int64, device=x.device)
    lo = torch.zeros(shape, dtype=torch.int64, device=x.device)
    hi.index_add_(0, index, x >> 31)
    lo.index_add_(0, index, x & _M31)
    return modadd(p, shl_mod(p, hi % p, 31), lo % p)


def matmul_mod(p: int, X: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """(..., k) @ (k, m) mod p with small k: one reduced product and one
    reduced addition per step."""
    X, B = _i64(X), _i64(B)
    acc = torch.zeros(X.shape[:-1] + B.shape[1:], dtype=torch.int64,
                      device=X.device)
    for k in range(X.shape[-1]):
        acc = modadd(p, acc, mulmod(p, X[..., k:k + 1], B[k]))
    return acc


# ---------------------------------------------------------------------------
# Mirrors of the kernels' arithmetic (csrc/modp64.cuh), step for step
# ---------------------------------------------------------------------------

_U64 = np.uint64


def mul128_np(a, b):
    """(lo, hi) of the exact 128-bit product of uint64 arrays: a * b and
    __umul64hi(a, b), as mac128 forms them."""
    a, b = np.asarray(a, _U64), np.asarray(b, _U64)
    with np.errstate(over="ignore"):
        return a * b, umul64hi_np(a, b)


def redc_np(f: GFpWide, hi, lo) -> np.ndarray:
    """T * 2^-64 mod p for T = hi 2^64 + lo < p 2^64, as redc computes it:
    m = lo * pinv mod 2^64, r = hi + hi(m p) + (lo != 0) < 2p, one
    conditional subtract."""
    hi, lo = np.asarray(hi, _U64), np.asarray(lo, _U64)
    t = [(int(h) << 64) + int(l) for h, l in zip(hi.flat, lo.flat)]
    assert all(v < f.p << 64 for v in t), "REDC input >= p 2^64"
    with np.errstate(over="ignore"):
        m = lo * _U64(f.pinv)
        r = hi + umul64hi_np(m, _U64(f.p)) + (lo != 0).astype(_U64)
        assert (r < _U64(2 * f.p)).all(), "REDC result out of [0, 2p)"
        return np.where(r >= _U64(f.p), r - _U64(f.p), r)


def mont_mul_np(f: GFpWide, a, b) -> np.ndarray:
    """a * b * 2^-64 mod p for residues a, b (the product's high word is
    below p, so REDC takes it as it is)."""
    lo, hi = mul128_np(a, b)
    return redc_np(f, hi, lo)


def fold_np(f: GFpWide, hi) -> np.ndarray:
    """The fold of a 128-bit sum: its high word reduced mod p by Barrett
    (csrc/modp.cuh::barrett_reduce, exact for every u64)."""
    return barrett_reduce_np(np.asarray(hi, _U64), f.p)


def reduce128_np(f: GFpWide, hi, lo) -> np.ndarray:
    """T mod p for any 128-bit T = hi 2^64 + lo, as reduce128 computes it:
    fold the high word below p, REDC (T 2^-64 mod p), then a Montgomery
    product with 2^128 mod p (back to T mod p)."""
    t = redc_np(f, fold_np(f, hi), lo)
    return mont_mul_np(f, t, np.full_like(t, f.r2))


def lazy_dot_wide(f: GFpWide, a, b, base: int = 0) -> int:
    """(base + sum a[k] b[k]) mod p over residues as the kernels sum it: a
    128-bit accumulator that starts at the base, takes raw products and
    is folded once every WIDE_FOLD of them; then reduce128.  Python ints;
    asserts that the accumulator stays below 2^128."""
    assert 0 <= base < f.p
    acc = base
    for k, (x, y) in enumerate(zip(a, b)):
        acc += int(x) * int(y)
        assert acc < 1 << 128, "lazy sum left 128 bits"
        if k % WIDE_FOLD == WIDE_FOLD - 1:
            hi = int(fold_np(f, np.uint64(acc >> 64)))
            acc = (hi << 64) | (acc & (_R - 1))
    return int(reduce128_np(f, np.uint64(acc >> 64),
                            np.uint64(acc & (_R - 1))))


def to_mont_np(f: GFpWide, a) -> np.ndarray:
    """a 2^64 mod p: a Montgomery product with 2^128 mod p."""
    a = np.asarray(a, _U64)
    return mont_mul_np(f, a, np.full_like(a, f.r2))


def reduce_mont_np(f: GFpWide, hi, lo) -> np.ndarray:
    """T 2^-64 mod p for any 128-bit T = hi 2^64 + lo, as reduce_mont
    computes it: fold the high word below p, then REDC."""
    return redc_np(f, fold_np(f, hi), lo)


def almost_inverse_np(p: int, a: int) -> tuple:
    """(a^-1 2^k mod p, k, steps) for 0 < a < p, as
    modp64.cuh::almost_inverse computes it: Kaliski's bit steps from u = p,
    v = a, r = 0, s = 1 until v = 0, one bit of u or v each (k of them);
    `steps` counts the kernel's steps, one a subtraction (with the halvings
    after it).  Asserts u s + v r = p, r and s below 2^63 (at most p while
    v > 0, 2p after the last bit step) and m <= k <= 2m for m =
    bitlen(p)."""
    assert 0 < a < p and p % 2
    u, v, r, s, k, steps = p, a, 0, 1, 0, 0
    while v:
        if u % 2 == 0:
            u, s = u >> 1, s << 1
        elif v % 2 == 0:
            v, r = v >> 1, r << 1
        elif u > v:
            u, r, s, steps = (u - v) >> 1, r + s, s << 1, steps + 1
        else:
            v, s, r, steps = (v - u) >> 1, s + r, r << 1, steps + 1
        k += 1
        assert u * s + v * r == p and max(r, s) <= (2 * p if v == 0 else p)
    assert u == 1 and r < 1 << 63
    m = p.bit_length()
    assert m <= k <= 2 * m
    return p - (r - p if r >= p else r), k, steps


def mont_inverse_np(f: GFpWide, am: int) -> tuple:
    """(the Montgomery form of a^-1, steps) from that of a != 0, as
    modp64.cuh::mont_inverse computes it: a = REDC(a~), the almost inverse
    x = a^-1 2^k, then x 2^(64 - k): one Barrett reduction of x << (64 - k)
    for k <= 64, else a REDC by 2^(k - 64)."""
    a = int(redc_np(f, np.uint64(0), np.uint64(am)))
    x, k, steps = almost_inverse_np(f.p, a)
    if k <= 64:
        assert x << (64 - k) < _R
        return int(barrett_reduce_np(np.uint64(x << (64 - k)), f.p)), steps
    t = k - 64
    c = (x * f.pinv) & ((1 << t) - 1)
    T = x + c * f.p
    assert T % (1 << t) == 0 and T < 1 << 128
    y = T >> t
    assert y < 2 * f.p
    return (y - f.p if y >= f.p else y), steps


def semi_inverse_mont_np(p: int, U) -> tuple:
    """semi_inverse_wide's elimination with the modp64.cuh mirrors on
    Python ints: M and W in Montgomery form, logical rows through perm, no
    row normalised (R_q <- a R_q - M[q, j] R_P as one REDC of a two-product
    128-bit sum), the pivots' product pref, one mont_inverse, the row scales
    undone at the end.  Returns (winv, d, npiv, steps): steps is the
    inverse's count of almost-inverse steps (subtractions), the length of
    its dependent chain."""
    f = GFpWide.make(p)
    n = U.shape[0]
    mont = lambda x: int(to_mont_np(f, np.uint64(x)))  # noqa: E731
    mm = lambda a, b: int(mont_mul_np(f, np.uint64(a),  # noqa: E731
                                      np.uint64(b)))

    def redc2(a, m, nb, mp):
        t = a * m + nb * mp
        assert t < p << 64
        return int(redc_np(f, np.uint64(t >> 64), np.uint64(t & (_R - 1))))

    def eliminate(M, W):
        perm, d, pref = list(range(n)), [0] * n, [mont(1)]
        for j in range(n):
            piv = next((i for i in range(j, n) if M[perm[i]][j]), None)
            if piv is None:
                d[j] = 0
                pref.append(pref[-1])
                continue
            d[j] = 1
            P = perm[piv]
            a = M[P][j]
            perm[j], perm[piv] = P, perm[j]
            for r in range(n):
                if r == P:
                    continue
                nb = p - M[r][j]
                for c in range(j + 1, n):
                    M[r][c] = redc2(a, M[r][c], nb, M[P][c])
                if W is not None:
                    for c in range(n):
                        W[r][c] = redc2(a, W[r][c], nb, W[P][c])
            pref.append(mm(pref[-1], a))
        return perm, d, pref

    M = [[mont(x) for x in row] for row in U]
    _, d1, _ = eliminate(M, None)
    M = [[mont(U[i, c]) if d1[i] and d1[c] else 0 for c in range(n)]
         for i in range(n)]
    W = [[mont(1) if i == c and d1[c] else 0 for c in range(n)]
         for i in range(n)]
    perm, d, pref = eliminate(M, W)
    # pref[j] is the product of the pivots before step j (non-pivot steps
    # repeat it), pref[n] all of them
    inv_a, steps = mont_inverse_np(f, pref[n])
    sig = [mm(pref[i], inv_a) if d[i] else inv_a for i in range(n)]
    winv = np.array([[int(redc_np(f, np.uint64(0), np.uint64(
        mm(W[perm[i]][c], sig[i])))) for c in range(n)] for i in range(n)],
        dtype=object)
    return winv, np.array(d, np.uint32), sum(d), steps


# ---------------------------------------------------------------------------
# Mirrors of gram_wide's tensor-core sums (csrc/gram_wide.cu)
# ---------------------------------------------------------------------------

GW_LIMBS = 8                  # u8 limbs of a residue below 2^62
GW_CLASSES = 2 * GW_LIMBS - 1  # shift classes s + t
GW_FOLDED_MAX_N = 4           # n up to which the limbs fold into M and N
GW_FOLDED_FOLD_ROWS = 32768   # rows between recombinations, folded limbs
GW_CLASS_FOLD_ROWS = 4096     # and shift classes
GW_MAX_CTAS = 1024            # CTAs along the rows at most
GW_MAX_CTA_WARPS = 16         # warp residues a CTA adds as halves at most
_S32 = 1 << 31


def limbs_np(a) -> np.ndarray:
    """(..., 8) int64 u8 limbs of residues below 2^62 (limb s is byte s),
    as the kernel's __byte_perm transpose takes them apart."""
    a = np.asarray(a, _U64)
    limbs = np.stack([(a >> _U64(8 * s)) & _U64(0xFF)
                      for s in range(GW_LIMBS)], -1).astype(np.int64)
    assert (limbs[..., GW_LIMBS - 1] < 64).all(), "top limb >= 2^6"
    return limbs


def limb_weights_np(f: GFpWide) -> list:
    """2^(8k) mod p for k < GW_CLASSES, as reduce128 forms them from the
    128-bit power of two."""
    return [int(reduce128_np(f, np.uint64((1 << 8 * k) >> 64),
                             np.uint64((1 << 8 * k) & (_R - 1))))
            for k in range(GW_CLASSES)]


def gram_limb_sums_np(v, av, folded: bool) -> np.ndarray:
    """The kernel's s32 sums over a block of rows of [v | Av]^T Av's limb
    products: folded, (2n, 8, n, 8) with [i, s, j, t] = sum_r x_s y_t (one
    limb pair an entry, A's rows (i, s), B's columns (j, t)); else the
    shift classes, (15, 2n, n) with [s + t, i, j] summing every pair of
    the class.  Asserts that each fits the s32 accumulator."""
    X = limbs_np(np.concatenate([np.asarray(v), np.asarray(av)], 1))
    Y = limbs_np(av)
    S = np.einsum("ris,rjt->isjt", X, Y)
    if not folded:
        C = np.zeros((GW_CLASSES,) + S.shape[::2], np.int64)
        for s in range(GW_LIMBS):
            for t in range(GW_LIMBS):
                C[s + t] += S[:, s, :, t]
        S = C
    assert (S >= 0).all() and (S < _S32).all(), "an s32 limb sum overflows"
    return S


def gram_wide_tc_np(f: GFpWide, v, av, folded: bool | None = None,
                    ctas: int = 3, warps: int = 2) -> np.ndarray:
    """[v | Av]^T Av mod p (2n, n) as gram_wide sums it, with Python ints
    and every bound asserted: `ctas` row ranges (CTAs) of `warps` row
    ranges (warps) each; in each warp's, s32 limb sums over blocks of the
    fold rows (folded limbs up to n = GW_FOLDED_MAX_N, one limb pair a sum,
    added by shift class at the flush; shift classes above), recombined
    with the weights 2^(8(s+t)) mod p into a 128-bit running sum folded
    after each block, reduced once (reduce128); every warp's residue added
    as two 31-bit halves (the CTA's sum in shared memory, then the
    scratch's u64 atomics), recombined hi 2^31 + lo and reduced by the
    last CTA."""
    v, av = np.asarray(v, _U64), np.asarray(av, _U64)
    N, n = v.shape
    folded = n <= GW_FOLDED_MAX_N if folded is None else folded
    fold_rows = GW_FOLDED_FOLD_ROWS if folded else GW_CLASS_FOLD_ROWS
    assert 1 <= ctas <= GW_MAX_CTAS and 1 <= warps <= GW_MAX_CTA_WARPS
    w = limb_weights_np(f)
    lo = np.zeros((2 * n, n), object)
    hi = np.zeros((2 * n, n), object)
    per = -(-N // (ctas * warps)) if N else 0
    for c in range(ctas * warps):
        rows = slice(c * per, min(N, (c + 1) * per))
        acc = np.zeros((2 * n, n), object)
        for r0 in range(rows.start, max(rows.start, rows.stop), fold_rows):
            blk = slice(r0, min(rows.stop, r0 + fold_rows))
            S = gram_limb_sums_np(v[blk], av[blk], folded).astype(object)
            if folded:   # the flush adds an entry's 64 sums by shift class
                S = np.stack([sum(S[:, s, :, k - s]
                                  for s in range(max(0, k - 7), min(k, 7) + 1))
                              for k in range(GW_CLASSES)])
                assert (S < 8 * _S32).all(), "a class sum past 2^34"
            part = sum(S[k] * w[k] for k in range(GW_CLASSES))
            acc = acc + part
            assert (acc < 1 << 128).all(), "a running sum left 128 bits"
            acc = (np.vectorize(lambda a: int(fold_np(
                f, np.uint64(a >> 64))))(acc).astype(object) << 64) \
                + (acc & (_R - 1))
        r = np.vectorize(lambda a: int(reduce128_np(
            f, np.uint64(a >> 64), np.uint64(a & (_R - 1)))))(acc)
        r = r.astype(object)
        lo, hi = lo + (r & _M31), hi + (r >> 31)
    assert (lo < 1 << 45).all() and (hi < 1 << 45).all(), "a half past 2^45"
    t = (hi << 31) + lo
    out = np.vectorize(lambda a: int(reduce128_np(
        f, np.uint64(a >> 64), np.uint64(a & (_R - 1)))))(t)
    return np.asarray(out, np.int64).reshape(2 * n, n)


# ---------------------------------------------------------------------------
# Mirrors of orthogonalize_wide's two paths (csrc/orthogonalize_wide.cu)
# ---------------------------------------------------------------------------

OW_LIMBS = 8                     # u8 limbs of a residue
OW_CLASSES = 2 * OW_LIMBS - 1    # shift classes s + t
OW_ROW_MAX_N = 8                 # n up to which the row path can run
OW_MMA_MIN_N = 5                 # n from which the tensor cores run
OW_MAX_N = 64


def _ortho_bases(v, pb, av, d) -> np.ndarray:
    """(N, 2n) bases where(d, Av, v) | where(d, 0, p), Python ints."""
    dm = np.asarray(d).astype(bool)[None, :]
    v, pb, av = (np.asarray(a).astype(object) for a in (v, pb, av))
    return np.concatenate([np.where(dm, av, v), np.where(dm, 0, pb)], 1)


def ortho_row_np(f: GFpWide, v, pb, av, rhs, d) -> tuple:
    """(v', p') as the row path computes them, with Python ints: rhs~ =
    rhs 2^64 mod p; each output a 128-bit sum that starts at base 2^64 and
    takes raw products x[k] rhs~[k, c] (the zero block skipped), folded
    after every WIDE_FOLD of them but the last, then reduce_mont.  Asserts
    that the sum stays below 2^128."""
    v, pb, av = (np.asarray(a, _U64) for a in (v, pb, av))
    N, n = v.shape
    X = np.concatenate([v, pb], 1).astype(object)
    R = to_mont_np(f, np.asarray(rhs, _U64)).astype(object)
    base = _ortho_bases(v, pb, av, d)
    out = np.zeros((N, 2 * n), object)
    for r in range(N):
        for c in range(2 * n):
            acc = int(base[r, c]) << 64
            for k in range(2 * n):
                if c < n or k < n:
                    acc += int(X[r, k]) * int(R[k, c])
                assert acc < 1 << 128, "a row-path sum left 128 bits"
                if k % WIDE_FOLD == WIDE_FOLD - 1 and k + 1 < 2 * n:
                    acc = (int(fold_np(f, np.uint64(acc >> 64))) << 64) \
                        | (acc & (_R - 1))
            out[r, c] = int(reduce_mont_np(f, np.uint64(acc >> 64),
                                           np.uint64(acc & (_R - 1))))
    out = out.astype(np.int64)
    return out[:, :n], out[:, n:]


def ortho_class_sums_np(v, pb, rhs) -> np.ndarray:
    """(15, N, 2n) s32 sums of the tensor-core path: [q, r, c] = sum over k
    and the limb pairs (s, t) with s + t = q of x_s[r, k] rhs_t[k, c],
    rhs's zero block (rows and columns >= n) zero.  Asserts the bounds of
    the kernel's header: each below 2^31, the 15 together below 2^29."""
    v, pb = np.asarray(v, _U64), np.asarray(pb, _U64)
    n = v.shape[1]
    rhs = np.array(rhs, _U64)
    rhs[n:, n:] = 0
    X = limbs_np(np.concatenate([v, pb], 1))       # (N, 2n, 8)
    B = limbs_np(rhs)                              # (2n, 2n, 8)
    P = np.einsum("rks,kct->strc", X, B)           # (8, 8, N, 2n)
    S = np.zeros((OW_CLASSES,) + P.shape[2:], np.int64)
    for s_ in range(OW_LIMBS):
        for t in range(OW_LIMBS):
            S[s_ + t] += P[s_, t]
    assert (S >= 0).all() and (S < _S32).all(), "a class sum overflows s32"
    assert (S.sum(0) < 1 << 29).all(), "the classes' total past 2^29"
    return S


def ortho_weights_np(f: GFpWide) -> list:
    """w_q = 2^(8q) 2^64 mod p, as the kernel forms them: reduce128 of
    2^(8q + 64) for q < 8, times 2^64 once more (a Montgomery product with
    2^128 mod p) above."""
    w = []
    for q in range(OW_CLASSES):
        s_ = q if q < OW_LIMBS else q - OW_LIMBS
        x = int(reduce128_np(f, np.uint64(1 << 8 * s_), np.uint64(0)))
        w.append(x if q < OW_LIMBS else int(mont_mul_np(
            f, np.uint64(x), np.uint64(f.r2))))
    return w


def ortho_wide_tc_np(f: GFpWide, v, pb, av, rhs, d) -> tuple:
    """(v', p') as the tensor-core path computes them, with Python ints:
    the class sums S_q, L = sum S_q lo32(w_q) < 2^61 and H = sum S_q
    hi32(w_q) < 2^59 (u64 sums), T = base 2^64 + H 2^32 + L < 2^127, one
    reduce_mont.  Every bound asserted."""
    n = np.asarray(v).shape[1]
    S = ortho_class_sums_np(v, pb, rhs).astype(object)
    w = ortho_weights_np(f)
    L = sum(S[q] * (w[q] & 0xFFFFFFFF) for q in range(OW_CLASSES))
    H = sum(S[q] * (w[q] >> 32) for q in range(OW_CLASSES))
    assert (L < 1 << 61).all() and (H < 1 << 59).all()
    T = (_ortho_bases(v, pb, av, d) << 64) + (H << 32) + L
    assert (T < 1 << 127).all()
    out = np.vectorize(lambda t: int(reduce_mont_np(
        f, np.uint64(t >> 64), np.uint64(t & (_R - 1)))))(T)
    out = np.asarray(out, np.int64).reshape(T.shape)
    return out[:, :n], out[:, n:]


# ---------------------------------------------------------------------------
# Mirror of spmv_wide's narrow slab (csrc/spmv_wide.cu, Sum<true>)
# ---------------------------------------------------------------------------

NARROW_LIMB_BITS = 21     # x < 2^62 in three limbs
NARROW_FOLD = 512         # entries between two reductions of the sums


def smod_np(f: GFpWide, s: int) -> int:
    """s mod p for a signed sum |s| < 2^63, as smod takes it: Barrett of
    |s|, negated for s < 0."""
    assert -(1 << 63) < s < 1 << 63, "a signed limb sum left int64"
    r = int(barrett_reduce_np(np.uint64(abs(s)), f.p))
    return f.p - r if s < 0 and r else r


def narrow_dot_np(f: GFpWide, cs, xs) -> int:
    """sum c[k] x[k] mod p over signed coefficients |c| <= 2^31 - 1 and
    residues x, as the narrow slab's kernel sums it: x cut into three
    21-bit limbs, one signed 64-bit sum a limb (asserted to stay in int64)
    reduced into [0, p) every NARROW_FOLD entries, then s_0 + s_1 2^21 +
    s_2 2^42 in 128 bits, reduce128."""
    m = (1 << NARROW_LIMB_BITS) - 1
    s = [0, 0, 0]
    for k, (c, x) in enumerate(zip(cs, xs)):
        c, x = int(c), int(x)
        assert abs(c) < _S32 and 0 <= x < f.p
        for i in range(3):
            s[i] += ((x >> NARROW_LIMB_BITS * i) & m) * c
            assert -(1 << 63) < s[i] < 1 << 63, "a limb sum left int64"
        if k % NARROW_FOLD == NARROW_FOLD - 1:
            s = [smod_np(f, a) for a in s]
    r = [smod_np(f, a) for a in s]
    t = r[0] + (r[1] << NARROW_LIMB_BITS) + (r[2] << 2 * NARROW_LIMB_BITS)
    assert t < 1 << 105
    return int(reduce128_np(f, np.uint64(t >> 64), np.uint64(t & (_R - 1))))
