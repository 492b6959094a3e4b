"""The plain reference check of a left kernel block: x^T M == 0 and no
column of x zero.

Plain NumPy and PyTorch, independent of the program: it takes the
benchmark's COO (the entries as generated, before anything the program
derives from them) and the block x (nrows x n) the program returned, and
works the product x^T M out itself, every column of it:

  * GF(2): the XOR over the odd entries of the rows of x, packed 64 bits a
    word (NumPy);
  * p < 2^31: int64 products reduced mod p and summed exactly per column
    (PyTorch, on the device the entries were prepared on);
  * 2^31 <= p < 2^62: both sides in 21-bit limbs, each limb product summed
    exactly, the sums combined mod p by shift-and-add (PyTorch likewise).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

LIMB = 21
CHUNK_ELEMENTS = 1 << 27    # the most int64 products one pass holds


@dataclasses.dataclass(frozen=True)
class Entries:
    """The entries nonzero mod p (over GF(2): the odd ones).  Over GF(2)
    they are grouped by column for a segmented XOR (`lines`, `starts`);
    over a prime they are tensors on the reference's device."""
    nrows: int
    ncols: int
    prime: int
    src: object             # row of each entry (ndarray or tensor)
    dst: object             # column of each entry (tensor; None over GF(2))
    vals: object            # value mod p (tensor; None over GF(2))
    lines: object = None    # GF(2): the columns that have entries
    starts: object = None   # GF(2): where each column's run begins
    max_run: int = 0        # the most entries of one column


def prepare(nrows: int, ncols: int, i, j, x, prime: int,
            device="cpu") -> Entries:
    """The entries of M once, zeros mod p dropped."""
    p = int(prime)
    i = np.asarray(i, np.int64)
    j = np.asarray(j, np.int64)
    vals = np.asarray(x).astype(np.uint64) % np.uint64(p)
    keep = vals != 0
    i, j, vals = i[keep], j[keep], vals[keep]
    runs = np.bincount(j, minlength=ncols)
    max_run = int(runs.max()) if len(runs) else 0
    if p == 2:
        order = np.argsort(j, kind="stable")
        i, j = i[order], j[order]
        starts = np.flatnonzero(np.r_[True, j[1:] != j[:-1]]) if len(j) \
            else np.zeros(0, np.int64)
        return Entries(nrows, ncols, p, src=i, dst=None, vals=None,
                       lines=j[starts], starts=starts, max_run=max_run)
    dev = torch.device(device)
    return Entries(nrows, ncols, p, src=torch.from_numpy(i).to(dev),
                   dst=torch.from_numpy(j).to(dev),
                   vals=torch.from_numpy(vals.astype(np.int64)).to(dev),
                   max_run=max_run)


def _mulmod(a: torch.Tensor, b: int, p: int) -> torch.Tensor:
    """a * b mod p elementwise for 0 <= a < p < 2^62 and a scalar b < p,
    by shift-and-add over b's bits (every partial stays below 2^63)."""
    r = torch.zeros_like(a)
    for bit in reversed(range(max(int(b).bit_length(), 1))):
        r = r + r
        r = torch.where(r >= p, r - p, r)
        if (int(b) >> bit) & 1:
            r = r + a
            r = torch.where(r >= p, r - p, r)
    return r


def _column_sums(e: Entries, xs: torch.Tensor,
                 vals: torch.Tensor) -> torch.Tensor:
    """sum over each column's entries of xs[row] * vals, exact in int64
    (the caller keeps every sum below 2^63): (ncols, xs.shape[1])."""
    out = torch.zeros((e.ncols, xs.shape[1]), dtype=torch.int64,
                      device=xs.device)
    return out.index_add_(0, e.dst, xs[e.src] * vals[:, None])


def product_modp(e: Entries, kernel) -> np.ndarray:
    """x^T M mod p, (ncols, n) int64."""
    p = int(e.prime)
    if p >= 1 << 62:
        raise ValueError("the reference takes p < 2^62")
    dev = e.vals.device
    x = torch.from_numpy((np.asarray(kernel).astype(np.uint64)
                          % np.uint64(p)).astype(np.int64)).to(dev)
    n = x.shape[1]
    step = max(1, min(n, CHUNK_ELEMENTS // max(len(e.vals), 1)))
    parts = []
    if p < 1 << 31:
        for c in range(0, n, step):
            # products below 2^62, reduced; a column's sum of fewer than
            # 2^32 of them stays below 2^63
            xs = x[:, c:c + step]
            out = torch.zeros((e.ncols, xs.shape[1]), dtype=torch.int64,
                              device=dev)
            out.index_add_(0, e.dst, xs[e.src] * e.vals[:, None] % p)
            parts.append(out % p)
        return torch.cat(parts, 1).cpu().numpy()
    if e.max_run >= 1 << LIMB:
        raise ValueError("a column of 2^21 entries or more overflows the sums")
    mask = (1 << LIMB) - 1
    vl = [(e.vals >> (LIMB * a)) & mask for a in range(3)]
    for c in range(0, n, step):
        xl = [(x[:, c:c + step] >> (LIMB * a)) & mask for a in range(3)]
        acc = torch.zeros((e.ncols, xl[0].shape[1]), dtype=torch.int64,
                          device=dev)
        for a in range(3):
            for b in range(3):
                # limb products below 2^42: sums of under 2^21 entries fit
                part = _column_sums(e, xl[a], vl[b]) % p
                acc = (acc + _mulmod(part, pow(2, LIMB * (a + b), p), p)) % p
        parts.append(acc)
    return torch.cat(parts, 1).cpu().numpy()


def product_gf2(e: Entries, kernel) -> np.ndarray:
    """x^T M over GF(2): (ncols, words) uint64, bit b of word w = column
    64 w + b of the block."""
    bits = np.asarray(kernel) != 0
    n = bits.shape[1]
    words = -(-n // 64)
    packed = np.packbits(bits, axis=1, bitorder="little")
    padded = np.zeros((bits.shape[0], words * 8), np.uint8)
    padded[:, :packed.shape[1]] = packed
    xw = padded.view(np.uint64)                        # (rows, words)
    out = np.zeros((e.ncols, words), np.uint64)
    if len(e.starts):
        out[e.lines] = np.bitwise_xor.reduceat(xw[e.src], e.starts, axis=0)
    return out


def judge(e: Entries, kernel) -> dict:
    """The numbers compared for one kernel block: `shape_bad` (1 unless it
    has nrows rows and at least one column), `zero_columns` (its columns
    that are zero) and `xM_nonzero` (the nonzero entries of x^T M)."""
    kernel = np.asarray(kernel)
    if kernel.ndim != 2 or kernel.shape[0] != e.nrows or kernel.shape[1] < 1:
        return {"shape_bad": 1, "zero_columns": 0, "xM_nonzero": 0}
    if e.prime == 2:
        x = kernel & 1
        prod = product_gf2(e, x)
        nonzero = sum(int(np.unpackbits(part.view(np.uint8)).sum())
                      for part in np.array_split(prod, 64) if part.size)
    else:
        x = kernel.astype(np.uint64) % np.uint64(e.prime)
        nonzero = int(np.count_nonzero(product_modp(e, kernel)))
    zero_columns = int(np.count_nonzero(~x.any(axis=0)))
    return {"shape_bad": 0, "zero_columns": zero_columns,
            "xM_nonzero": nonzero}
