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

Three hand-written CUDA kernels have their wrappers here.  Two have a
plain PyTorch version, which the wrapper takes for CPU tensors only:
  * `gram_gf2` (csrc/gram_gf2.cu): [v | Av]^T Av over GF(2), as the parity
    of a binary tensor-core product; `gram_gf2_tiles_np` mirrors its
    tiles, transposes and fragment layout in NumPy for the CPU tests;
  * `semi_inverse_gf2` (csrc/semi_inverse_gf2.cu): the two-phase bit
    Gauss-Jordan, with the invariant checks and the orthogonalize
    right-hand side, and the solver state's stop / inv_ok latch;
    `semi_inverse_gf2_warp_np` mirrors its one-warp elimination.
The third, `final_unpack` (csrc/gf2_final.cu), ends a solve on the card:
it unpacks v's bit block and sets the final check's two flags; its NumPy
mirror `final_unpack_np` follows the kernel's tiles and store order, and
the solver's CPU path keeps `unpack_bits_np` and `final_check`.
`orthogonalize_gf2_tiles_np` mirrors the tiles of the orthogonalize_gf2
kernel (models/lanczos_gf2.py) on the binary tensor cores.
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
# The Gram kernel's tiles on the binary tensor cores, mirrored in NumPy
# ---------------------------------------------------------------------------

GG_K = 256           # input rows per K-tile (csrc/gram_gf2.cu)
GG_REGION_A = 256    # output rows a of a CTA's region
GG_REGION_B = 128    # output columns b of a CTA's region
_TRANSPOSE_LO = (0x0000ffff, 0x00ff00ff, 0x0f0f0f0f, 0x33333333, 0x55555555)


def transpose32x2_np(x1: np.ndarray, x2: np.ndarray):
    """The kernel's warp transpose of two 32 x 32 bit matrices at once
    (transpose32x2), lane by lane: x1[..., l], x2[..., l] are lane l's
    uint32 words, row l of each; the results' lane l holds column l.  Each
    of the five stages sends the half of x1 and the half of x2 that a lane
    gives away in one shuffle-xor."""
    lane = np.arange(WORD)
    x1, x2 = np.asarray(x1, np.uint32), np.asarray(x2, np.uint32)
    for s, lo in enumerate(_TRANSPOSE_LO):
        j, lo = np.uint32(16 >> s), np.uint32(lo)
        up = (lane & int(j)) != 0
        give = np.where(up, (x1 & lo) | ((x2 & lo) << j),
                        (x1 & ~lo) | ((x2 & ~lo) >> j))
        o = give[..., lane ^ int(j)]
        x1, x2 = (np.where(up, (x1 & ~lo) | ((o & ~lo) >> j),
                           (x1 & lo) | ((o & lo) << j)),
                  np.where(up, (x2 & ~lo) | (o & lo), (x2 & lo) | (o & ~lo)))
    return x1, x2


def _popcount32(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0f0f0f0f
    return ((x * 0x01010101) & 0xffffffff) >> 24


def mma_b1_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc on the
    fragments of one warp, as the kernel lays them out (PTX ISA, lane =
    4 g + t): a (..., 32, 4) holds A row g (a0, a2) and row g + 8 (a1, a3),
    k-words t (a0, a1) and 4 + t (a2, a3); b (..., 32, 2) holds B column g,
    k-words t (b0) and 4 + t (b1).  Returns the (..., 32, 4) s32 counts:
    c0, c1 row g, columns 2t, 2t + 1; c2, c3 row g + 8."""
    lane = np.arange(WORD)
    g, t = lane >> 2, lane & 3
    lead = a.shape[:-2]
    A = np.zeros(lead + (16, 8), np.uint32)
    B = np.zeros(lead + (8, 8), np.uint32)
    A[..., g, t], A[..., g + 8, t] = a[..., 0], a[..., 1]
    A[..., g, 4 + t], A[..., g + 8, 4 + t] = a[..., 2], a[..., 3]
    B[..., g, t], B[..., g, 4 + t] = b[..., 0], b[..., 1]
    C = _popcount32(A[..., :, None, :] & B[..., None, :, :]).sum(-1).astype(
        np.int64)
    return np.stack([C[..., g, 2 * t], C[..., g, 2 * t + 1],
                     C[..., g + 8, 2 * t], C[..., g + 8, 2 * t + 1]], -1)


def gram_gf2_tiles_np(v: np.ndarray, av: np.ndarray) -> np.ndarray:
    """The gram_gf2 kernel's computation, step for step, in NumPy.  Per
    region of GG_REGION_A a-rows by GG_REGION_B b-columns and K-tile of GG_K
    rows: warp w (slot w % 8, half w // 8) stages row 32 (w % 8) + l of the
    K-tile's X words 4 half .. + 3 of the region (and, for half 0 where the
    b-columns are not among the a-columns, its 4 Y words), transposes them
    in pairs (transpose32x2_np) into T[slot][32 j + l] (Y's at 256 + ...);
    warp w then takes the fragments of its 2 x 8 tiles (a-rows
    32 (w % 8) .., b-columns 64 (w // 8) ..) from T, accumulates s32 counts
    with mma_b1_np, and packs their parities into G's words (8 bits a lane,
    ORed over the 4 lanes of a group).  v, av: (N, W) uint32 words; returns
    G (2n, W) uint32, equal to gram_gf2_plain."""
    v = np.asarray(v).view(np.uint32)
    av = np.asarray(av).view(np.uint32)
    N, W = v.shape
    n = W * WORD
    X = np.concatenate([v, av, np.zeros((N, 8), np.uint32)], axis=1)
    lane = np.arange(WORD)
    g, t = lane >> 2, lane & 3
    G = np.zeros((2 * n, W), np.uint32)
    tiles = max(1, -(-N // GG_K))
    for ra in range(-(-2 * n // GG_REGION_A)):
        for rb in range(-(-n // GG_REGION_B)):
            xa0, yb0 = ra * GG_REGION_A // WORD, rb * GG_REGION_B // WORD
            b_width = min(GG_REGION_B, n - GG_REGION_B * rb)
            b_in_a = n + GG_REGION_B * rb - GG_REGION_A * ra
            b_apart = b_in_a < 0 or b_in_a + b_width > GG_REGION_A
            b_off = GG_REGION_A if b_apart else b_in_a
            acc = np.zeros((16, 2, 8, WORD, 4), np.int64)  # warp, i, j, lane
            for k in range(tiles):
                rows = np.zeros((GG_K, X.shape[1]), np.uint32)
                r = np.arange(k * GG_K, min((k + 1) * GG_K, N))
                rows[r - k * GG_K] = X[r]           # zero past N, 2W words
                T = np.zeros((8, GG_REGION_A + GG_REGION_B), np.uint32)
                jobs = [(xa0 + 4 * h, 4 * h * WORD) for h in range(2)]
                if b_apart:
                    jobs.append((W + yb0, GG_REGION_A))
                for w0, at in jobs:
                    if w0 >= 2 * W:
                        continue
                    cols = [min(w0 + j, 2 * W) for j in range(4)]
                    # (slot, lane) -> the row's 4 words, transposed in pairs
                    q = rows[:, cols].reshape(8, WORD, 4)
                    x0, x1 = transpose32x2_np(q[..., 0], q[..., 1])
                    x2, x3 = transpose32x2_np(q[..., 2], q[..., 3])
                    for j, xj in enumerate((x0, x1, x2, x3)):
                        T[:, at + WORD * j: at + WORD * (j + 1)] = xj
                s0, s1 = T[2 * t], T[2 * t + 1]        # (lane, 384) each
                for warp in range(16):
                    a_base, b_base = (warp & 7) * 32, (warp >> 3) * 64
                    for i in range(2):
                        ar = a_base + 16 * i + g
                        af = np.stack([s0[lane, ar], s0[lane, ar + 8],
                                       s1[lane, ar], s1[lane, ar + 8]], -1)
                        for j in range(8):
                            col = b_off + b_base + 8 * j + g
                            bf = np.stack([s0[lane, col], s1[lane, col]], -1)
                            acc[warp, i, j] += mma_b1_np(af, bf)
            for warp in range(16):
                a_base, b_base = (warp & 7) * 32, (warp >> 3) * 64
                for i, h, q in np.ndindex(2, 2, 2):
                    word = np.zeros(WORD, np.uint32)
                    for jj in range(4):
                        c = acc[warp, i, 4 * q + jj]
                        word |= ((c[:, 2 * h] & 1) << (8 * jj + 2 * t)
                                 ).astype(np.uint32)
                        word |= ((c[:, 2 * h + 1] & 1) << (8 * jj + 2 * t + 1)
                                 ).astype(np.uint32)
                    word = np.bitwise_or.reduce(word.reshape(8, 4), axis=1)
                    a = (ra * GG_REGION_A + a_base + 16 * i + 8 * h
                         + np.arange(8))
                    wb = yb0 + (b_base >> 5) + q
                    if a[0] < 2 * n and wb < W:
                        G[a, wb] ^= word
    return G


# ---------------------------------------------------------------------------
# The orthogonalize_gf2 kernel's tiles on the binary tensor cores, mirrored
# in NumPy
# ---------------------------------------------------------------------------

OG_ROWS = 32         # rows a warp tile (csrc/orthogonalize_gf2.cu)


def _low_bytes_np(c0, c1, c2, c3) -> np.ndarray:
    """The kernel's low_bytes: the low byte of count j as byte j."""
    return ((c0 & 0xff) | ((c1 & 0xff) << 8) | ((c2 & 0xff) << 16)
            | ((c3 & 0xff) << 24)).astype(np.uint32)


def orthogonalize_gf2_tiles_np(v, p, av, rhs, d):
    """The orthogonalize_gf2 kernel's update, step for step, in NumPy (the
    halt aside): rhs transposed by 32 x 32 blocks (transpose32x2_np) into
    fragment order Bf[n8 tile, K-step, lane] = (b0, b1); per warp tile of
    OG_ROWS rows, lane 4 g + t holds words 4 i + t of rows 8 h + g of
    [v | p] (zero past 2W words and past N) and of Av; for every output word
    q, the two m16 tiles' counts over the K-steps of 8 k-words (those
    holding a v word only, for q >= W) by mma_b1_np, their parities packed
    with low bytes, a mask and a shift, reduced and scattered over the four
    lanes of a group (shuffle-xor 2, then 1), and the masked selects on d.
    v, p, av: (N, W) words; rhs (2n, 2W) words with a zero bottom-right
    block; d (n,) 0/1.  Returns (v_next, p_next) as uint32, equal to
    orthogonalize_gf2_plain's for a running state."""
    v, p, av, rhs = (np.asarray(a).view(np.uint32) for a in (v, p, av, rhs))
    N, W = v.shape
    n = W * WORD
    KW = 2 * W
    KS, KSV = -(-KW // 8), -(-W // 8)
    XI, AI, QG = 2 * KS, -(-W // 4), -(-KW // 4)
    lane = np.arange(WORD)
    g, t = lane >> 2, lane & 3
    # the CTA's prologue: block (k-word w, column words 2 c2, 2 c2 + 1)
    Bf = np.zeros((2 * n // 8, KS, WORD, 2), np.uint32)
    for w in range(8 * KS):
        for c2 in range(W):
            x1 = x2 = np.zeros(WORD, np.uint32)
            if w < KW:
                x1, x2 = rhs[32 * w + lane, 2 * c2], rhs[32 * w + lane,
                                                         2 * c2 + 1]
            y = transpose32x2_np(x1, x2)
            s, j = w >> 3, w & 7
            for h in range(2):
                c = 64 * c2 + 32 * h + lane
                Bf[c >> 3, s, 4 * (c & 7) + (j & 3), j >> 2] = y[h]
    cm = pack_bits_np(np.asarray(d, np.uint32).reshape(1, n))[0]
    tiles = max(1, -(-N // OG_ROWS))
    rows = (OG_ROWS * np.arange(tiles)[:, None, None]
            + 8 * np.arange(4)[None, :, None] + g)        # (tile, h, lane)
    live = rows < N
    pad = np.zeros((tiles * OG_ROWS - N, W), np.uint32)
    X = np.concatenate([np.concatenate([v, p], 1),
                        np.zeros((N, 4 * XI - KW), np.uint32)], 1)
    X = np.concatenate([X, np.zeros((len(pad), X.shape[1]), np.uint32)])
    A = np.concatenate([av, np.zeros((N, 4 * AI - W), np.uint32)], 1)
    A = np.concatenate([A, np.zeros((len(pad), A.shape[1]), np.uint32)])
    x = np.stack([X[rows, 4 * i + t] for i in range(XI)], -1)
    a = np.stack([A[rows, 4 * i + t] for i in range(AI)], -1)
    v_next, p_next = v.copy(), p.copy()
    t2, t1 = (t & 2) != 0, (t & 1) != 0
    for qg in range(QG):
        part = np.zeros((tiles, 4, WORD, 4), np.uint32)
        for qq in range(4):
            q = 4 * qg + qq
            if q >= KW:
                continue
            acc = np.zeros((tiles, 2, 4, WORD, 4), np.int64)
            for s in range(KS if q < W else KSV):
                for m in range(2):
                    af = np.stack([x[:, 2 * m, :, 2 * s],
                                   x[:, 2 * m + 1, :, 2 * s],
                                   x[:, 2 * m, :, 2 * s + 1],
                                   x[:, 2 * m + 1, :, 2 * s + 1]], -1)
                    for jj in range(4):
                        bf = np.broadcast_to(Bf[4 * q + jj, s],
                                             (tiles, WORD, 2))
                        acc[:, m, jj] += mma_b1_np(af, bf)
            for h in range(4):
                c, e0 = acc[:, h >> 1], 2 * (h & 1)
                p0 = _low_bytes_np(*(c[:, jj, :, e0] for jj in range(4)))
                p1 = _low_bytes_np(*(c[:, jj, :, e0 + 1] for jj in range(4)))
                part[:, h, :, qq] = (((p0 & 0x01010101)
                                      | ((p1 << 1) & 0x02020202))
                                     << (2 * t).astype(np.uint32))
        qw = 4 * qg + t                          # lane t's output word
        for h in range(4):
            P = part[:, h]
            k0 = np.where(t2, P[..., 2], P[..., 0]) | np.where(
                t2, P[..., 0], P[..., 2])[:, lane ^ 2]
            k1 = np.where(t2, P[..., 3], P[..., 1]) | np.where(
                t2, P[..., 1], P[..., 3])[:, lane ^ 2]
            upd = np.where(t1, k1, k0) | np.where(t1, k0, k1)[:, lane ^ 1]
            xw = x[:, h, :, qg]
            for tile, ln in zip(*np.nonzero(live[:, h] & (qw < KW))):
                r, q, u = rows[tile, h, ln], qw[ln], upd[tile, ln]
                if q < W:
                    aw = a[tile, h, ln, qg] if qg < AI else 0
                    v_next[r, q] = ((aw & cm[q]) | (xw[tile, ln] & ~cm[q])) ^ u
                else:
                    p_next[r, q - W] = (xw[tile, ln] & ~cm[q - W]) ^ u
    return v_next, p_next


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


SI2_WARP_MAXW = 2    # csrc/semi_inverse_gf2.cu: W up to it, one warp
_NO_PIVOT = 0x7fffffff


def semi_inverse_gf2_warp_np(U) -> tuple:
    """The semi_inverse_gf2 kernel's one-warp elimination (which it runs for
    W <= SI2_WARP_MAXW, and its sweeps up to W = 8), step for step, in
    NumPy: lane l holds physical rows
    l + 32 q and their keys pk = pos << 10 | row; each step takes the
    candidates' keys (bit j set, pk >= j << 10), the least over the lane's
    rows and then over the warp, the pivot row's words from its slot and
    lane, the masked XOR into every other row with bit j (M's words from
    word j // 32 on only), and the swap of logical rows piv and j as an XOR
    of (piv ^ j) << 10 into both keys.  Phase 2 re-eliminates U masked by
    d1 from eye * d1.  U: (n, W) words.  Returns (winv (n, W) uint32 in
    logical order, d (n,) uint32, npiv)."""
    U = np.asarray(U).view(np.uint32)
    n, W = U.shape
    lane = np.arange(WORD)
    row = lane[None, :] + WORD * np.arange(W)[:, None]    # (slot, lane)

    def eliminate(m, w, with_w):
        """m, w (slot, lane, word); returns (d, npiv, pos)."""
        pk = row * 1025
        d = np.zeros(n, np.uint32)
        for j in range(n):
            jw, b = divmod(j, WORD)
            bit = ((m[:, :, jw] >> np.uint32(b)) & 1) == 1
            key = np.where(bit & (pk >= j << 10), pk, _NO_PIVOT)
            k = int(key.min(axis=0).min())        # the lane's, the warp's
            if k == _NO_PIVOT:
                continue
            d[j] = 1
            P = k & 1023
            pm, pw = m[P >> 5, P & 31].copy(), w[P >> 5, P & 31].copy()
            elim = (bit & (pk != k))[..., None]
            m[:, :, jw:] ^= np.where(elim, pm[jw:], np.uint32(0))
            if with_w:
                w ^= np.where(elim, pw, np.uint32(0))
            pos = pk >> 10
            pk = np.where((pos == k >> 10) | (pos == j),
                          pk ^ (((k >> 10) ^ j) << 10), pk)
        return d, int(d.sum()), pk >> 10

    rows_u = U[row]                                       # (slot, lane, W)
    d1, _, _ = eliminate(rows_u.copy(), np.zeros_like(rows_u), False)
    cm1 = pack_bits_np(d1.reshape(1, n))[0]
    keep = (d1[row] == 1)[..., None]
    m = np.where(keep, rows_u & cm1, np.uint32(0))
    w = np.zeros_like(m)
    for q in range(W):
        w[q, :, q] = np.where(d1[row[q]] == 1, np.uint32(1) << lane.astype(
            np.uint32), np.uint32(0))
    d, npiv, pos = eliminate(m, w, True)
    winv = np.zeros((n, W), np.uint32)
    winv[pos] = w
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
# The final step on the card: v unpacked, v != 0 and v^T M == 0 as flags
# ---------------------------------------------------------------------------

FU_TILE = 128        # words of v a warp unpacks at a time (csrc/gf2_final.cu)


def final_unpack(v: torch.Tensor, tmp: torch.Tensor | None, n_eff: int,
                 m_eff: int, n: int, out: torch.Tensor,
                 flags: torch.Tensor) -> None:
    """Launch the final_unpack kernel (CUDA tensors only): out[:n_eff] <- the
    bits of v's first n_eff rows ((n_eff, n) 0/1 int32, column c bit c % 32
    of word c // 32: unpack_bits_np's block); flags[0] <- 1 if any word of
    those rows is nonzero, flags[1] <- 1 if any word of tmp's first m_eff
    rows is, else 0.  tmp None unpacks v alone (flags[1] stays 0).  v, tmp
    and out must start on 16-byte boundaries (whole allocations do)."""
    W = check_width(n)
    if v.dim() != 2 or v.shape[1] != W or v.shape[0] < n_eff:
        raise ValueError(f"final_unpack: v must be (>= {n_eff}, {W}) words")
    if tmp is not None and (tmp.dim() != 2 or tmp.shape[1] != W
                            or tmp.shape[0] < m_eff):
        raise ValueError(f"final_unpack: tmp must be (>= {m_eff}, {W}) "
                         "words")
    if out.dim() != 2 or out.shape[0] < n_eff or out.shape[1] != n \
            or flags.shape != (2,):
        raise ValueError(f"final_unpack: out must be (>= {n_eff}, {n}) and "
                         "flags (2,)")
    kernels.check_operands("final_unpack", v, out, flags,
                           *(() if tmp is None else (tmp,)))
    kernels.launch("final_unpack", v.data_ptr(),
                   None if tmp is None else tmp.data_ptr(), int(n_eff),
                   0 if tmp is None else int(m_eff), W, out.data_ptr(),
                   flags.data_ptr())
    final_unpack.launches += 1


final_unpack.launches = 0


def final_unpack_np(v: np.ndarray, tmp: np.ndarray | None, n_eff: int,
                    m_eff: int, n: int):
    """csrc/gf2_final.cu in NumPy: (bits, flags), bits the (n_eff, n) uint32
    block the kernel writes and flags its two int32 flags.  As the kernel:
    v's first n_eff rows as flat words, a tile of FU_TILE words a warp,
    lane l loading words 4l .. 4l + 3 (zero past the end) and, at store step
    k, writing uint4 32 k + l of the tile's output: bits 4 (l % 8) ..
    4 (l % 8) + 3 of the tile's word 4 k + l // 8."""
    W = words(n)
    v = np.ascontiguousarray(v).view(np.uint32)
    nv = n_eff * W
    flat = v[:n_eff].reshape(-1)
    tiles = -(-nv // FU_TILE)
    loaded = np.zeros(tiles * FU_TILE, np.uint32)
    loaded[:nv] = flat
    t, k, lane = np.meshgrid(np.arange(tiles), np.arange(FU_TILE // 4),
                             np.arange(32), indexing="ij")
    word = t * FU_TILE + 4 * k + (lane >> 3)
    keep = word < nv
    x = loaded[word[keep]] >> (4 * (lane[keep] & 7)).astype(np.uint32)
    out = np.empty((nv * 8, 4), np.uint32)
    store = (t * 8 * FU_TILE + 32 * k + lane)[keep]
    out[store] = (x[:, None] >> np.arange(4, dtype=np.uint32)) & 1
    flags = np.zeros(2, np.int32)
    flags[0] = int(loaded.any())
    if tmp is not None:
        flags[1] = int(np.ascontiguousarray(tmp).view(np.uint32)[:m_eff]
                       .any())
    return out.reshape(n_eff, n), flags


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
