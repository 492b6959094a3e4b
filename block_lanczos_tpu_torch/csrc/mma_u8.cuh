// Exact mod-p products on the integer tensor cores: u8 limbs, s32 sums.
//
// A residue x < p < 2^30 is four u8 limbs, x = sum_i x_i 2^(8i).  A product
// of two residues is then sum_{i,j} x_i y_j 2^(8(i+j)): 16 limb products in
// 7 shift classes s = i + j (0..6).  A contraction sum_k A[., k] B[k, .]
// runs as 16 `mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32` (A limb i
// times B limb j, added into class i + j's s32 accumulator S_s), and the
// result is recombined as sum_s S_s * (2^(8s) mod p), then reduced once with
// barrett_reduce (modp.cuh).  For p < 2^8 the upper limbs are zero and
// the same sums are exact; for p = 2, 2^(8s) mod p is 0 for s > 0.
//
// Bounds.  Each limb is at most 255, so each limb product is at most
// 255^2 = 65025.  An s32 accumulator of class s collects at most 4 limb
// pairs (s = 3 has (0,3), (1,2), (2,1), (3,0)) per contraction term, so
// after K terms S_s <= 4 * K * 65025, which is below 2^31 (the s32 range:
// the products are never negative) for every K <= 8256.  Callers:
//   * orthogonalize contracts over K = 2n <= 128 columns;
//   * gram_mod contracts over rows and recombines at least once every
//     MMA_FOLD_ROWS = 8192 rows, so K <= 8192 between two recombinations.
// Recombination: over all classes there are 16 limb pairs, so
// sum_s S_s <= 16 * K * 65025, and with 2^(8s) mod p <= p - 1 < 2^30 and a
// reduced addend base < p,
//   base + sum_s S_s * (2^(8s) mod p) < 2^30 + 2^30 * 16 * 8192 * 65025
//                                     < 2^30 + 2^30 * 2^4 * 2^13 * 2^16
//                                     = 2^30 + 2^63 < 2^64,
// so the u64 sum never wraps and one barrett_reduce (exact for any u64)
// gives the canonical residue.  ops/gfp.py mirrors this step for step
// (limb_classes_np, limb_recombine_np) and asserts each bound.
#pragma once

#include "modp.cuh"

#define MMA_FOLD_ROWS 8192
#define MMA_CLASSES 7

// The 4x4 byte transpose: w[q] are four residues (consecutive along the
// contraction); limb[l] gets byte l of w[0..3] in its bytes 0..3, which is
// how a fragment register of an m16n8k32 u8 operand holds 4 consecutive k.
__device__ __forceinline__ void to_limbs(const u32 (&w)[4], u32 (&limb)[4]) {
  const u32 t0 = __byte_perm(w[0], w[1], 0x5140);  // w0.b0 w1.b0 w0.b1 w1.b1
  const u32 t1 = __byte_perm(w[0], w[1], 0x7362);  // w0.b2 w1.b2 w0.b3 w1.b3
  const u32 t2 = __byte_perm(w[2], w[3], 0x5140);
  const u32 t3 = __byte_perm(w[2], w[3], 0x7362);
  limb[0] = __byte_perm(t0, t2, 0x5410);
  limb[1] = __byte_perm(t0, t2, 0x7632);
  limb[2] = __byte_perm(t1, t3, 0x5410);
  limb[3] = __byte_perm(t1, t3, 0x7632);
}

// c += a * b on one 16x8x32 tile.  Fragments (PTX ISA, m16n8k32 .u8), with
// g = lane / 4 and t = lane % 4:
//   a[0] row g,   k 4t..4t+3;  a[1] row g+8, k 4t..4t+3;
//   a[2] row g,   k 16+4t..;   a[3] row g+8, k 16+4t..;
//   b[0] k 4t..4t+3, col g;    b[1] k 16+4t.., col g;
//   c[0], c[1] row g, cols 2t, 2t+1;  c[2], c[3] row g+8, cols 2t, 2t+1.
__device__ __forceinline__ void mma_u8(int (&c)[4], const u32 (&a)[4],
                                       const u32 (&b)[2]) {
  asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// The 16 limb products of one k-step: S[i + j] += A_i * B_j.
__device__ __forceinline__ void mma_limb_classes(int (&S)[MMA_CLASSES][4],
                                                 const u32 (&a)[4][4],
                                                 const u32 (&b)[4][2]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) mma_u8(S[i + j], a[i], b[j]);
}

// c[s] = 2^(8s) mod p, s = 0..6 (below p < 2^30: 32-bit words, so each
// term of the recombination is one 32 x 32 -> 64-bit multiply-add).
__device__ __forceinline__ void limb_weights(u64 p, u64 mu,
                                             u32 (&c)[MMA_CLASSES]) {
  c[0] = static_cast<u32>(barrett_reduce(1, p, mu));
#pragma unroll
  for (int s = 1; s < MMA_CLASSES; ++s)
    c[s] = static_cast<u32>(barrett_reduce(static_cast<u64>(c[s - 1]) << 8, p, mu));
}

// (base + sum_s S[s][e] * c[s]) mod p for accumulator element e; the bound
// is proved above.
__device__ __forceinline__ u64 limb_recombine(const int (&S)[MMA_CLASSES][4],
                                              int e, u64 base,
                                              const u32 (&c)[MMA_CLASSES],
                                              u64 p, u64 mu) {
  u64 x = base;
#pragma unroll
  for (int s = 0; s < MMA_CLASSES; ++s)
    x += static_cast<u64>(static_cast<u32>(S[s][e])) * c[s];
  return barrett_reduce(x, p, mu);
}
