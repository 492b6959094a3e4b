"""Independent kernel-block checker for the narrow field (library + CLI).

Validates a computed kernel block against the ORIGINAL matrix file,
sharing nothing with the solver but the MatrixMarket parser — the oracle
role of the reference's standalone checker
(reference: sequential/checker_modp.c:34-207):

  1. every entry of the block is < p, and the block is not all-zero,
  2. y = x^T * M (or M * x with --right) is exactly zero mod p,

with the matrix streamed from disk in chunks.  Exact host NumPy: u64
products of residues below 2^30, one argsort + contiguous segment sums per
chunk; at p = 2 a bit-packed XOR path (32 kernel columns per word, 4 bytes
per 32 bits instead of 8 per bit).  Prints "OK" and exits 0 on success,
like the reference.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from block_lanczos_tpu_torch.ops.gfp import PRIME_CAP
from block_lanczos_tpu_torch.utils import mmio


class CheckFailure(Exception):
    pass


def check_kernel_block(matrix_path: str, x: np.ndarray, prime: int,
                       right: bool = False, verbose: bool = False) -> bool:
    """Verify x (nrows_eff x n) is a kernel block of the matrix file.

    Raises CheckFailure with a reason on failure; returns True on success.
    """
    if not 2 <= prime <= PRIME_CAP:
        raise ValueError(f"this checker covers 2 <= p <= 2**30 - 35 "
                         f"(got {prime})")
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
    if (y != 0).any():
        i, j = np.argwhere(y != 0)[0]
        raise CheckFailure(f"KO: y[{i}, {j}] == {y[i, j]} != 0")
    if verbose:
        print("OK")
    return True


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
    return check_kernel_block(matrix_path, data.astype(np.uint32), prime,
                              right=right, verbose=verbose)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="checker-modp-torch",
        description="verify a block of kernel vectors against a sparse "
                    "matrix (narrow field, p <= 2^30 - 35)")
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
