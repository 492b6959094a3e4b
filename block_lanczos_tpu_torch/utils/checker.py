"""Independent kernel-block checker, 2 <= p < 2^62 (library + CLI).

Validates a computed kernel block against the ORIGINAL matrix file,
sharing nothing with the solver but the MatrixMarket parser — the oracle
role of the reference's standalone checker
(reference: sequential/checker_modp.c:34-207):

  1. every entry of the block is < p, and the block is not all-zero,
  2. y = x^T * M (or M * x with --right) is exactly zero mod p,

with the matrix streamed from disk in chunks.  Exact host NumPy, one
argsort + contiguous segment sums per chunk: u64 products of residues
below 2^30; for a wide prime (2^30 - 35 < p < 2^62) a vectorized two-limb
Montgomery multiply of its own (`_WideField`, the JAX package's checker's,
sharing no arithmetic with the solver); at p = 2 a bit-packed XOR path (32
kernel columns per word, 4 bytes per 32 bits instead of 8 per bit).  Prints
"OK" and exits 0 on success, like the reference.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from block_lanczos_tpu_torch.ops.gfp import PRIME_CAP
from block_lanczos_tpu_torch.ops.gfp_wide import WIDE_PRIME_CAP
from block_lanczos_tpu_torch.utils import mmio


WIDE_LIMIT = WIDE_PRIME_CAP + 1  # 2^62


class CheckFailure(Exception):
    pass


# ---------------------------------------------------------------------------
# Exact wide-prime (p < 2^62) host arithmetic: two-limb u64, Montgomery R=2^64
# ---------------------------------------------------------------------------
# An independent NumPy derivation of the Montgomery recipe (the JAX
# package's checker's); NumPy uint64 ops wrap mod 2^64, which is exactly
# the ring Montgomery reduction needs.

_M32 = np.uint64(0xFFFFFFFF)


def _mul64_128(a, b):
    """u64 x u64 -> (lo, hi) exact 128-bit product, vectorized."""
    a0, a1 = a & _M32, a >> np.uint64(32)
    b0, b1 = b & _M32, b >> np.uint64(32)
    ll, lh, hl = a0 * b0, a0 * b1, a1 * b0
    t = (ll >> np.uint64(32)) + (lh & _M32) + (hl & _M32)
    lo = (ll & _M32) | ((t & _M32) << np.uint64(32))
    hi = a1 * b1 + (lh >> np.uint64(32)) + (hl >> np.uint64(32)) \
        + (t >> np.uint64(32))
    return lo, hi


class _WideField:
    """Montgomery constants + vectorized mod-p products for odd p < 2^62."""

    def __init__(self, p: int):
        assert 2 < p < (1 << 62) and p % 2 == 1
        self.p = np.uint64(p)
        self.p_int = int(p)
        R = 1 << 64
        self.pprime = np.uint64((-pow(p, -1, R)) % R)  # -p^-1 mod 2^64
        self.r2 = np.uint64((R * R) % p)               # to-Montgomery factor

    def mont_mul(self, a, b):
        """a*b*R^-1 mod p (inputs < p, output < p), vectorized u64."""
        t_lo, t_hi = _mul64_128(a, b)
        m = t_lo * self.pprime                 # wraps: m = t_lo * p' mod 2^64
        u_lo, u_hi = _mul64_128(m, self.p)
        # t + u has zero low word by construction; carry is 1 unless lo == 0
        r = t_hi + u_hi + (t_lo != 0)
        return np.where(r >= self.p, r - self.p, r)


def _check_wide(matrix_path: str, x: np.ndarray, prime: int, ncols: int,
                right: bool) -> np.ndarray:
    """y = x^T M mod p for a wide prime: products through a two-limb
    Montgomery multiply; each chunk's contributions are accumulated as
    split 32-bit halves (lo sums < 2^52, hi < 2^50 at the 2^20 chunk size,
    exact in u64) and folded mod p per chunk."""
    f = _WideField(int(prime))
    n = x.shape[1]
    x64 = x.astype(np.uint64)
    with np.errstate(over="ignore"):
        xm = f.mont_mul(x64, f.r2)  # x in Montgomery form, once
        y = np.zeros((ncols, n), np.uint64)
        c32m = np.uint64(((1 << 32) << 64) % f.p_int)  # to_mont(2^32)
        p64 = f.p
        sub = 1 << 16  # small working set: the temporaries stay in cache
        for bi, bj, bx in mmio.iter_mtx_triplets(matrix_path):
            if right:
                bi, bj = bj, bi
            acc_lo = np.zeros((ncols, n), np.uint64)
            acc_hi = np.zeros((ncols, n), np.uint64)
            order = np.argsort(bj, kind="stable")
            bi, bj, bx = bi[order], bj[order], bx[order]
            for s in range(0, len(bx), sub):
                je = bj[s:s + sub]
                vv = (bx[s:s + sub] % np.int64(prime)).astype(np.uint64)
                contrib = f.mont_mul(vv[:, None], xm[bi[s:s + sub]])
                starts = np.flatnonzero(np.r_[True, je[1:] != je[:-1]])
                idx = je[starts]   # unique within the sub-chunk
                acc_lo[idx] += np.add.reduceat(contrib & _M32, starts,
                                               axis=0)
                acc_hi[idx] += np.add.reduceat(contrib >> np.uint64(32),
                                               starts, axis=0)
            for t in (f.mont_mul(acc_hi % p64, c32m), acc_lo % p64):
                y = y + t
                y = np.where(y >= p64, y - p64, y)
    return y


def check_kernel_block(matrix_path: str, x: np.ndarray, prime: int,
                       right: bool = False, verbose: bool = False) -> bool:
    """Verify x (nrows_eff x n) is a kernel block of the matrix file.

    Raises CheckFailure with a reason on failure; returns True on success.
    """
    if not 2 <= prime < WIDE_LIMIT:
        raise ValueError(f"this checker covers 2 <= p < 2**62 (got {prime})")
    nrows, ncols, _ = mmio.read_mtx_header(matrix_path)
    if right:
        nrows, ncols = ncols, nrows  # implicit transpose
    x = np.asarray(x)
    if x.ndim == 1:
        x = x[:, None]
    if x.shape[0] != nrows:
        raise CheckFailure(
            f"dimension mismatch: kernel has {x.shape[0]} rows, "
            f"matrix needs {nrows}")
    if (x >= prime).any():
        raise CheckFailure("kernel entries out of bound (>= p)")
    if not (x != 0).any():
        raise CheckFailure("KO: kernel vectors are all zero")

    if prime == 2:
        _check_gf2(matrix_path, x, nrows, ncols, right)
        if verbose:
            print("OK")
        return True
    y = (_check_wide if prime > PRIME_CAP else _check_narrow)(
        matrix_path, x, prime, ncols, right)
    if (y != 0).any():
        i, j = np.argwhere(y != 0)[0]
        raise CheckFailure(f"KO: y[{i}, {j}] == {y[i, j]} != 0")
    if verbose:
        print("OK")
    return True


def _check_narrow(matrix_path: str, x: np.ndarray, prime: int, ncols: int,
                  right: bool) -> np.ndarray:
    """y = x^T M mod p for p <= 2^30 - 35: u64 products of residues."""
    x64 = x.astype(np.uint64)
    y = np.zeros((ncols, x.shape[1]), np.uint64)
    p64 = np.uint64(prime)
    for bi, bj, bx in mmio.iter_mtx_triplets(matrix_path):
        if right:
            bi, bj = bj, bi
        # group by output row: one sort + contiguous segment sums
        order = np.argsort(bj, kind="stable")
        bi, bj = bi[order], bj[order]
        vv = bx[order].astype(np.uint32).astype(np.uint64) % p64
        contrib = (vv[:, None] * x64[bi]) % p64  # products < 2^60, exact
        starts = np.flatnonzero(np.r_[True, bj[1:] != bj[:-1]])
        segs = np.add.reduceat(contrib, starts, axis=0)
        # segment sums < 2^20 (chunk cap) * p < 2^50 — exact in u64
        idx = bj[starts]  # unique within the chunk: fancy-add is safe
        y[idx] = (y[idx] + segs) % p64
    return y


def _check_gf2(matrix_path: str, x: np.ndarray, nrows: int, ncols: int,
               right: bool) -> None:
    """x^T M == 0 over GF(2): bit-pack the kernel columns (32 a word) and
    XOR-accumulate the gathered rows per chunk.  Even entries vanish mod 2
    and are dropped; duplicates XOR out exactly like the mod-p sum."""
    W = (x.shape[1] + 31) // 32
    shifts = np.arange(32, dtype=np.uint32)
    # one 32-column slice at a time: no zero-padded copy of the kernel
    xw = np.empty((nrows, W), np.uint32)
    for w in range(W):
        sl = (x[:, w * 32:(w + 1) * 32] & 1).astype(np.uint32)
        xw[:, w] = (sl << shifts[:sl.shape[1]]).sum(axis=1, dtype=np.uint32)
    yw = np.zeros((ncols, W), np.uint32)
    for bi, bj, bx in mmio.iter_mtx_triplets(matrix_path):
        if right:
            bi, bj = bj, bi
        odd = (bx & 1) == 1
        bi, bj = bi[odd], bj[odd]
        if not len(bi):
            continue
        order = np.argsort(bj, kind="stable")
        bj = bj[order]
        g = xw[bi[order]]
        starts = np.flatnonzero(np.r_[True, bj[1:] != bj[:-1]])
        yw[bj[starts]] ^= np.bitwise_xor.reduceat(g, starts, axis=0)
    if yw.any():
        r = int(np.argwhere(yw.any(axis=1))[0][0])
        bits = (yw[r][:, None] >> shifts) & 1
        c = int(np.argwhere(bits.reshape(-1))[0][0])
        raise CheckFailure(f"KO: y[{r}, {c}] == 1 != 0")


def check_kernel_file(matrix_path: str, kernel_path: str, prime: int,
                      right: bool = False, verbose: bool = False) -> bool:
    nk, n, data = mmio.read_array_mtx(kernel_path)
    if verbose:
        print(f"Reading kernel from {kernel_path}: {nk} x {n}")
    if (data < 0).any() or (data >= prime).any():
        raise CheckFailure("kernel entries out of bound")
    dtype = np.uint64 if prime > PRIME_CAP else np.uint32
    return check_kernel_block(matrix_path, data.astype(dtype), prime,
                              right=right, verbose=verbose)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="checker-modp-torch",
        description="verify a block of kernel vectors against a sparse "
                    "matrix mod p, 2 <= p < 2^62")
    ap.add_argument("--matrix", required=True, help="sparse matrix file")
    ap.add_argument("--kernel", required=True,
                    help="dense block of kernel vectors")
    ap.add_argument("--prime", required=True, type=int, help="prime modulus")
    ap.add_argument("--right", action="store_true",
                    help="verify right kernel vectors")
    ap.add_argument("--left", action="store_true",
                    help="verify left kernel vectors [default]")
    args = ap.parse_args(argv)
    try:
        check_kernel_file(args.matrix, args.kernel, args.prime,
                          right=args.right and not args.left, verbose=True)
    except (CheckFailure, ValueError) as e:
        print(str(e), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
