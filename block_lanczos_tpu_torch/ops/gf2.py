"""Bitsliced GF(2): 32 field elements per 32-bit word.

The port's counterpart of the JAX package's ops/gf2.py.  p = 2 is the
integer-factorization case: a block of n vectors (n a multiple of 32) packs
into W = n/32 words per row, addition is XOR and multiplication is AND.
Column c of a block lives in word c // 32, bit c % 32 (little-endian), as in
the JAX package, so packed words are equal bit for bit.

Words are held in int32 tensors as 32-bit patterns (torch's uint32 supports
few operations); NumPy callers convert with `.view(np.int32)` /
`.view(np.uint32)`.  `>>` on int32 is arithmetic, so every bit extraction
masks with `& 1` after the shift.

Two hand-written CUDA kernels live here, each with its plain PyTorch
version, which the wrapper takes for CPU tensors only:
  * `gram_gf2` (csrc/gram_gf2.cu): [v | Av]^T Av over GF(2);
  * `semi_inverse_gf2` (csrc/semi_inverse_gf2.cu): the two-phase bit
    Gauss-Jordan, with the invariant checks and the orthogonalize
    right-hand side, and the solver state's stop / inv_ok latch.
The plain versions of the n x n products (`matmul_gf2`, `transpose_bits`)
count bits in float64 matrix products (exact: every sum is an integer below
2^53) and keep the parity.  `dedup_lines` is a verbatim copy of the JAX
package's, hash seed included, so both packages drop the same lines.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from block_lanczos_tpu_torch import kernels
from block_lanczos_tpu_torch.ops.semi_inverse import FROZEN

WORD = 32
# The widest block the GF(2) kernels take (csrc/gf2.cuh GF2_MAXN:
# semi_inverse_gf2 runs one thread per row of the n x n Gram in one CTA).
MAX_N = 512


def words(n: int) -> int:
    if n % WORD != 0:
        raise ValueError("bitsliced GF(2) requires n % 32 == 0")
    return n // WORD


def check_width(n: int) -> int:
    """W = n / 32 for a block width the GF(2) kernels take; raises on any
    other n."""
    W = words(n)
    if not WORD <= n <= MAX_N:
        raise ValueError(f"the GF(2) kernels support 32 <= n <= {MAX_N} "
                         f"with n % 32 == 0 (got n = {n})")
    return W


# ---------------------------------------------------------------------------
# Packing (host NumPy, as in the JAX package, and torch)
# ---------------------------------------------------------------------------

def pack_bits_np(block01: np.ndarray) -> np.ndarray:
    """(N, n) 0/1 array -> (N, n/32) uint32 words (bit b = column b)."""
    N, n = block01.shape
    W = words(n)
    w = block01.astype(np.uint32).reshape(N, W, WORD)
    shifts = np.arange(WORD, dtype=np.uint32)
    return (w << shifts).sum(axis=2, dtype=np.uint32)


def unpack_bits_np(wordsarr: np.ndarray, n: int) -> np.ndarray:
    """(N, n/32) words (uint32 or int32) -> (N, n) 0/1 uint32."""
    wordsarr = np.asarray(wordsarr)
    if wordsarr.dtype == np.int32:
        wordsarr = wordsarr.view(np.uint32)
    N, W = wordsarr.shape
    shifts = np.arange(WORD, dtype=np.uint32)
    bits = (wordsarr[:, :, None] >> shifts) & 1
    return bits.reshape(N, W * WORD).astype(np.uint32)[:, :n]


def pack_bits(bits01: torch.Tensor) -> torch.Tensor:
    """(..., n) 0/1 tensor -> (..., n/32) int32 word patterns."""
    n = bits01.shape[-1]
    W = words(n)
    b = bits01.to(torch.int64).reshape(*bits01.shape[:-1], W, WORD)
    shifts = torch.arange(WORD, dtype=torch.int64, device=bits01.device)
    w = (b << shifts).sum(-1)                       # < 2^32, exact in int64
    return (w - ((w >> 31) << 32)).to(torch.int32)  # as a 32-bit pattern


def unpack_bits(wordsarr: torch.Tensor, n: int | None = None) -> torch.Tensor:
    """(..., W) int32 words -> (..., n) int32 0/1 (n defaults to 32 W)."""
    shifts = torch.arange(WORD, dtype=torch.int32, device=wordsarr.device)
    bits = (wordsarr[..., None] >> shifts) & 1
    bits = bits.reshape(*wordsarr.shape[:-1], wordsarr.shape[-1] * WORD)
    return bits if n is None else bits[..., :n]


def bit_of(wordsarr: torch.Tensor, k: int) -> torch.Tensor:
    """Bit-column k as a full mask (0 or all ones, i.e. -1), shape (...,)."""
    w, b = k // WORD, k % WORD
    return -((wordsarr[..., w] >> b) & 1)


def colmask(d: torch.Tensor) -> torch.Tensor:
    """(n,) 0/1 -> (W,) int32 words with bit c set iff d[c]."""
    return pack_bits(d.reshape(1, -1))[0]


def diag_words(d: torch.Tensor) -> torch.Tensor:
    """(n,) 0/1 -> the (n, W) words of diag(d): bit r of row r iff d[r]."""
    n = d.shape[0]
    return pack_bits(torch.eye(n, dtype=torch.int32, device=d.device)
                     * d[:, None])


def _parity_product(A01: torch.Tensor, B01: torch.Tensor) -> torch.Tensor:
    """(A01 @ B01) mod 2 for 0/1 matrices: exact float64 counts, as every
    sum is an integer below 2^53 (no integer matmul runs on CUDA)."""
    counts = A01.to(torch.float64) @ B01.to(torch.float64)
    return counts.to(torch.int64) & 1


def matmul_gf2(X_words: torch.Tensor, B_words: torch.Tensor,
               n_in: int) -> torch.Tensor:
    """(N, Win) bit block @ (n_in, Wout) bit matrix over GF(2) -> (N, Wout):
    y[r] = XOR over k of (bit k of X row r) * B[k]."""
    X = unpack_bits(X_words, n_in)
    B = unpack_bits(B_words)
    return pack_bits(_parity_product(X, B))


def transpose_bits(M_words: torch.Tensor, n: int) -> torch.Tensor:
    """(n, W) bit matrix -> its transpose as (n, W) words."""
    return pack_bits(unpack_bits(M_words, n).T.contiguous())


# ---------------------------------------------------------------------------
# The Gram kernel and its plain version
# ---------------------------------------------------------------------------

# int32 words of the gram_gf2 kernel's scratch per device: the largest
# (2n, W) accumulator, then its ticket (csrc/gram_gf2.cu)
_GRAM_SCRATCH = 2 * MAX_N * (MAX_N // WORD) + 1
_scratch: dict = {}


def gram_gf2_plain(v: torch.Tensor, av: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the gram_gf2 kernel: [v | Av]^T Av over
    GF(2) as (2n, W) words, n = 32 W."""
    X = unpack_bits(torch.cat([v, av], dim=1))
    return pack_bits(_parity_product(X.T, unpack_bits(av)))


def gram_gf2(v: torch.Tensor, av: torch.Tensor,
             out: torch.Tensor | None = None) -> torch.Tensor:
    """[v | Av]^T Av over GF(2) for (N, W) word blocks -> (2n, W) words:
    row a is the XOR over rows of (bit a of [v | Av]) & Av.  CUDA tensors
    launch the gram_gf2 kernel; CPU tensors take gram_gf2_plain.  `out`
    (CUDA only) is an optional (2n, W) buffer."""
    if v.dim() != 2 or v.shape != av.shape:
        raise ValueError("gram_gf2 needs two (N, W) blocks of one shape")
    N, W = v.shape
    if v.device.type == "cpu":
        return gram_gf2_plain(v, av)
    check_width(W * WORD)
    if out is None:
        out = torch.empty((2 * W * WORD, W), dtype=torch.int32,
                          device=v.device)
    elif out.shape != (2 * W * WORD, W):
        raise ValueError(f"out must be ({2 * W * WORD}, {W})")
    kernels.check_operands("gram_gf2", v, av, out)
    scratch = _scratch.get(v.device)
    if scratch is None:
        scratch = _scratch[v.device] = torch.zeros(
            _GRAM_SCRATCH, dtype=torch.int32, device=v.device)
    kernels.launch("gram_gf2", v.data_ptr(), av.data_ptr(), N, W,
                   scratch.data_ptr(), out.data_ptr())
    gram_gf2.launches += 1
    return out


gram_gf2.launches = 0


# ---------------------------------------------------------------------------
# The semi-inverse kernel and its plain version
# ---------------------------------------------------------------------------

class SemiInverseGF2(NamedTuple):
    winv: torch.Tensor  # (n, W) int32 words
    d: torch.Tensor     # (n,) int32, 0/1
    npiv: torch.Tensor  # (1,) int32
    rhs: torch.Tensor   # (2n, 2W) words: [[winv*spliced, winv], [vtAv&cm, 0]]


def _eliminate_plain(M: torch.Tensor, Wv: torch.Tensor):
    """One masked Gauss-Jordan sweep over the n columns of the (n, W) word
    matrix M, tracking Wv; returns (M, Wv, d, npiv) with d int32 0/1."""
    n = M.shape[0]
    rows = torch.arange(n, device=M.device)
    d = torch.zeros(n, dtype=torch.int32, device=M.device)
    npiv = torch.zeros((), dtype=torch.int32, device=M.device)
    for j in range(n):
        w, b = j // WORD, j % WORD
        cand = (((M[:, w] >> b) & 1) == 1) & (rows >= j)
        found = cand.any()
        pivot = torch.argmax(cand.to(torch.int32))      # the first True
        perm = torch.where(rows == j, pivot,
                           torch.where(rows == pivot, j, rows))
        M2, W2 = M[perm], Wv[perm]
        elim = ((((M2[:, w] >> b) & 1) == 1) & (rows != j))[:, None]
        M3 = torch.where(elim, M2 ^ M2[j][None, :], M2)
        W3 = torch.where(elim, W2 ^ W2[j][None, :], W2)
        M = torch.where(found, M3, M)
        Wv = torch.where(found, W3, Wv)
        d[j] = found.to(torch.int32)
        npiv = npiv + found.to(torch.int32)
    return M, Wv, d, npiv


def semi_inverse_gf2_core(U: torch.Tensor, n: int):
    """(winv, d, npiv) of the (n, W) word matrix U over GF(2); the two-phase
    semantics of the narrow field (phase 1 finds the pivotable columns d1,
    phase 2 re-eliminates U masked by d1 from eye * d1, tracking winv)."""
    _, _, d1, _ = _eliminate_plain(U, torch.zeros_like(U))
    cm = colmask(d1)
    M2 = torch.where((d1 == 1)[:, None], U & cm[None, :],
                     torch.zeros_like(U))
    _, winv, d, npiv = _eliminate_plain(M2, diag_words(d1))
    return winv, d, npiv


def invariants_ok_gf2(vtAv, vtAAv, winv, d, n: int) -> torch.Tensor:
    """0-dim bool: the per-iteration checks over GF(2) (symmetry of vtAv,
    vtAAv, winv; winv's support within d; winv * (vtAv & cm) == diag(d))."""
    ok = (vtAv == transpose_bits(vtAv, n)).all()
    ok &= (vtAAv == transpose_bits(vtAAv, n)).all()
    ok &= (winv == transpose_bits(winv, n)).all()
    cm = colmask(d)[None, :]
    db = d.to(torch.bool)
    ok &= (db[:, None] | ((winv & ~cm) == 0)).all()
    ok &= (matmul_gf2(winv, vtAv & cm, n) == diag_words(d)).all()
    return ok


def orthogonalize_rhs_gf2(vtAv, vtAAv, winv, d, n: int) -> torch.Tensor:
    """[[winv * spliced, winv], [vtAv & cm, 0]] as (2n, 2W) words, with
    spliced = (vtAAv & cm) | (vtAv & ~cm) and cm the column mask of d."""
    cm = colmask(d)[None, :]
    spliced = (vtAAv & cm) | (vtAv & ~cm)
    c = matmul_gf2(winv, spliced, n)
    top = torch.cat([c, winv], dim=1)
    bottom = torch.cat([vtAv & cm, torch.zeros_like(vtAv)], dim=1)
    return torch.cat([top, bottom])


def semi_inverse_gf2_plain(grams: torch.Tensor, state: torch.Tensor,
                           check: bool = True) -> SemiInverseGF2:
    """Plain PyTorch version of the semi_inverse_gf2 kernel (same outputs
    and the same state update: stop = npiv == 0 and inv_ok, unless the
    state is frozen)."""
    W = grams.shape[1]
    n = W * WORD
    vtAv, vtAAv = grams[:n], grams[n:]
    winv, d, npiv = semi_inverse_gf2_core(vtAv, n)
    ok = invariants_ok_gf2(vtAv, vtAAv, winv, d, n) if check else \
        torch.ones((), dtype=torch.bool, device=grams.device)
    rhs = orthogonalize_rhs_gf2(vtAv, vtAAv, winv, d, n)
    frozen = state[FROZEN] != 0
    new = torch.stack([(npiv == 0).to(torch.int32), ok.to(torch.int32)])
    state[:2] = torch.where(frozen, state[:2], new)
    return SemiInverseGF2(winv, d, npiv.reshape(1), rhs)


def empty_outputs(n: int, device) -> SemiInverseGF2:
    """Output buffers for `semi_inverse_gf2(..., out=)`."""
    W = words(n)
    return SemiInverseGF2(
        torch.empty((n, W), dtype=torch.int32, device=device),
        torch.empty(n, dtype=torch.int32, device=device),
        torch.empty(1, dtype=torch.int32, device=device),
        torch.empty((2 * n, 2 * W), dtype=torch.int32, device=device))


def semi_inverse_gf2(grams: torch.Tensor, state: torch.Tensor,
                     check: bool = True,
                     out: SemiInverseGF2 | None = None) -> SemiInverseGF2:
    """(winv, d, npiv, rhs) of grams = [vtAv ; vtAAv] ((2n, W) words),
    updating the solver state in place.  CUDA tensors launch the
    semi_inverse_gf2 kernel; CPU tensors take semi_inverse_gf2_plain.
    `out` (CUDA only) is an optional preallocated result (`empty_outputs`)."""
    W = grams.shape[1]
    n = W * WORD
    if grams.dim() != 2 or grams.shape[0] != 2 * n or state.shape != (4,):
        raise ValueError("semi_inverse_gf2 needs (2n, n/32) grams and a "
                         "4-state")
    if out is not None and [tuple(t.shape) for t in out] != \
            [(n, W), (n,), (1,), (2 * n, 2 * W)]:
        raise ValueError(f"out must be semi_inverse_gf2 outputs for n = {n}")
    if grams.device.type == "cpu":
        return semi_inverse_gf2_plain(grams, state, check)
    check_width(n)
    if out is None:
        out = empty_outputs(n, grams.device)
    kernels.check_operands("semi_inverse_gf2", grams, state, *out)
    kernels.launch("semi_inverse_gf2", grams.data_ptr(), n,
                   int(bool(check)), out.winv.data_ptr(), out.d.data_ptr(),
                   out.npiv.data_ptr(), out.rhs.data_ptr(), state.data_ptr())
    semi_inverse_gf2.launches += 1
    return out


semi_inverse_gf2.launches = 0


# ---------------------------------------------------------------------------
# Structured-instance preprocessing: m_eff-side dedup (the JAX package's
# ops/gf2.py::dedup_lines, verbatim)
# ---------------------------------------------------------------------------

def dedup_lines(i: np.ndarray, j: np.ndarray, nrows: int, ncols: int,
                right: bool):
    """Drop empty and duplicate m_eff-side lines from the GF(2) operator
    (columns for the left-kernel solve, rows for the right).

    Over GF(2) the Lanczos operator is A = sum_c c c^T over the m_eff-side
    lines c: a line appearing an EVEN number of times cancels out of A
    entirely, so duplicate-heavy structured instances silently shrink
    rank(A) below rank(M) and strand the terminal candidates in the large
    ker(M) /\\ im(M^T) obstruction space.  Keeping exactly ONE
    representative per distinct nonzero line is exact for the kernel
    (x^T M == 0 iff x is orthogonal to every distinct line) and restores
    rank(A) ~= rank(M); salvage (utils/salvage.py) then recovers the
    residual few columns.  The mod-p fields keep duplicates.

    Lines are grouped by two independent 64-bit hash signatures plus the
    line weight; a false merge needs a 128-bit collision, and any such
    failure is caught downstream by the final check / independent checker.
    Deterministic (fixed hash seed 0xB10C, as in the JAX package).

    Contract: compaction happens ONLY when duplicate lines exist.  On
    duplicate-free instances, including those whose only degeneracy is
    empty lines and the all-empty operator, dedup is an exact passthrough
    (same arrays, reports (0, 0)) and the iterate stream stays
    bit-identical to the reference.  When duplicates ARE dropped, empty
    lines are compacted away in the same pass.

    Returns (i, j, nrows_eff, ncols_eff, n_dup, n_empty) with the deduped
    side compacted in ascending original order.
    """
    lines = j if not right else i          # the m_eff side
    other = i if not right else j
    dim = ncols if not right else nrows
    odim = nrows if not right else ncols
    if len(lines) == 0:
        # all-empty operator: nothing cancels, exact passthrough
        return i, j, nrows, ncols, 0, 0
    rng = np.random.default_rng(0xB10C)
    h1 = rng.integers(1, 1 << 63, size=odim, dtype=np.int64).astype(np.uint64)
    h2 = rng.integers(1, 1 << 63, size=odim, dtype=np.int64).astype(np.uint64)
    order = np.argsort(lines, kind="stable")
    ls = lines[order]
    starts = np.flatnonzero(np.r_[True, ls[1:] != ls[:-1]])
    xor_sig = np.bitwise_xor.reduceat(h1[other[order]], starts)
    add_sig = np.add.reduceat(h2[other[order]], starts)   # u64 wrap is fine
    cnt = np.diff(np.r_[starts, len(ls)]).astype(np.uint64)
    line_ids = ls[starts]
    sig = np.stack([xor_sig, add_sig, cnt], axis=1)
    _, first = np.unique(sig, axis=0, return_index=True)
    keep_ids = np.sort(line_ids[first])
    n_empty = dim - len(line_ids)
    n_dup = len(line_ids) - len(keep_ids)
    if n_dup == 0:                         # duplicate-free: exact passthrough
        return i, j, nrows, ncols, 0, 0
    lut = np.full(dim, -1, np.int64)
    lut[keep_ids] = np.arange(len(keep_ids))
    m = lut[lines] >= 0
    new_lines = lut[lines[m]].astype(lines.dtype)
    new_other = other[m]
    dim_eff = len(keep_ids)
    if right:
        return new_lines, new_other, dim_eff, ncols, n_dup, n_empty
    return new_other, new_lines, nrows, dim_eff, n_dup, n_empty
