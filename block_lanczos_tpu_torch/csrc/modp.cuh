// Shared mod-p arithmetic for the narrow-field kernels (p <= 2^30 - 35).
//
// Residues live in int32 tensors with 0 <= r < p < 2^30.  A product of two
// residues is below 2^60 and is formed exactly in u64.  Integer sums are
// associative, so results are bit-exact whatever the summation order,
// thread split or block order.
//
// No kernel reduces with `%`: a runtime 64-bit `%` is a long software
// sequence on the GPU (there is no integer divider).  Three reductions, all
// driven by the constant mu = floor(2^64 / p) that the host computes once
// per prime (ops/gfp.py::barrett_mu) and passes with p:
//   * `barrett_reduce`: one 64x64 high multiply, one multiply, one subtract
//     and one conditional subtract, exact for EVERY u64 input.  It lets a
//     kernel sum raw products lazily and reduce once per LAZY_FOLD of them
//     (spmv_ell, gram_mod and orthogonalize on the CUDA cores), or reduce a
//     recombined sum of tensor-core limb products once (mma_u8.cuh);
//   * `barrett_reduce32`, the same step on u32 inputs with m = mu >> 32
//     (psum_mod's fold of int32 sums);
//   * `reduce_short`, for a product of two residues or a sum of two such
//     products: 32x32-bit multiplies only, constants derived from mu
//     (semi_inverse's dependent chains).
// Each has a NumPy mirror in ops/gfp.py that the CPU tests hold against %.
// The GF(2) kernels include this file too (gf2.cuh), for the types, the
// solver state's halt bookkeeping and the error text only.
#pragma once

#include <cuda_runtime.h>

typedef unsigned long long u64;
typedef unsigned int u32;

// x mod p for any u64 x, given mu = floor(2^64 / p) and 2 <= p < 2^63.
//
// Proof.  2^64/p - 1 < mu <= 2^64/p.  Let q = floor(x * mu / 2^64), the high
// word of the exact 128-bit product (__umul64hi).
//   * q <= x * mu / 2^64 <= x / p, so q <= floor(x / p), q * p <= x < 2^64
//     (the u64 product q * p does not wrap) and r = x - q * p >= 0.
//   * q > x * mu / 2^64 - 1 > x * (2^64/p - 1) / 2^64 - 1
//       = x / p - x / 2^64 - 1 > x / p - 2    (as x < 2^64),
//     so r = x - q * p < 2p.
// Hence 0 <= r < 2p and one conditional subtract gives the canonical residue
// in [0, p).  For p = 2, mu = 2^63 exactly, q = x >> 1 and r = x & 1 (the
// subtract never fires); for p = 3, mu = 0x5555555555555555 and the bound
// above holds as for any p.  With p < 2^30, 2p < 2^31.
__device__ __forceinline__ u64 barrett_reduce(u64 x, u64 p, u64 mu) {
  const u64 q = __umul64hi(x, mu);
  const u64 r = x - q * p;
  return r >= p ? r - p : r;
}

// x mod p for any u32 x, given m = floor(2^32 / p) and 2 <= p < 2^31: the
// 32-bit Barrett step of psum_mod's fold (collectives.cu), whose int32 sums
// fit 32 bits.  m = mu >> 32 (floor(floor(2^64 / p) / 2^32) =
// floor(2^32 / p)), so it comes from the host constant mu too.
//
// Proof.  2^32/p - 1 < m <= 2^32/p.  Let q = floor(x * m / 2^32), the high
// word of the exact 64-bit product (__umulhi).
//   * q <= x * m / 2^32 <= x / p, so q * p <= x < 2^32 (the u32 product
//     q * p does not wrap) and r = x - q * p >= 0.
//   * q > x * m / 2^32 - 1 > x * (2^32/p - 1) / 2^32 - 1
//       = x / p - x / 2^32 - 1 > x / p - 2    (as x < 2^32),
//     so r = x - q * p < 2p < 2^32.
// Hence 0 <= r < 2p and one conditional subtract gives the canonical residue
// in [0, p).  For p = 2, m = 2^31 exactly and q = x >> 1; for p = 3,
// m = 0x55555555 and the bound holds as for any p.
__device__ __forceinline__ u32 barrett_reduce32(u32 x, u32 p, u32 m) {
  const u32 q = __umulhi(x, m);
  const u32 r = x - q * p;
  return r >= p ? r - p : r;
}

// A shorter Barrett reduction for the latency-bound chains (pivot steps,
// inverses), where x is a product of two residues or the sum of two: it
// needs x < 2^(2k+1), with k the bit length of p (2^(k-1) <= p < 2^k,
// k <= 30), and then uses 32x32-bit multiplies only.  Its constant
// mu_k = floor(2^(2k) / p) equals mu >> (64 - 2k) (floor(floor(a/b)/c) =
// floor(a/(bc))), so it comes from the same host constant mu.
//
// Proof.  Let q1 = floor(x / 2^(k-1)) < 2^(k+2) <= 2^32 and
// q = floor(q1 * mu_k / 2^(k+1)), where mu_k <= 2^(2k) / 2^(k-1) = 2^(k+1),
// so q1 * mu_k < 2^63 and q fits 32 bits.
//   * q <= (x / 2^(k-1)) * (2^(2k) / p) / 2^(k+1) = x / p, so r = x - q p >= 0.
//   * If q1 = 0 then q = 0 and r = x < 2^(k-1) <= p.  Otherwise, with
//     q1 > x / 2^(k-1) - 1 and mu_k > 2^(2k) / p - 1,
//     q > x / p - x / 2^(2k) - 2^(k-1) / p - 1 > x / p - 2 - 1 - 1,
//     as x < 2^(2k+1) and p >= 2^(k-1).  So r = x - q p < 4p <= 2^32.
// Hence r is exact in 32-bit arithmetic (x - q p mod 2^32) and two
// conditional subtracts (of 2p, then of p) make it canonical in [0, p).
// For p = 2 (k = 2, mu_k = 8) and p = 3 (k = 2, mu_k = 5) the same bounds
// hold.
struct ShortBarrett {
  u32 p, mu_k, k;
};

__device__ __forceinline__ ShortBarrett short_barrett(u64 p, u64 mu) {
  const u32 k = 32 - __clz(static_cast<u32>(p));
  return {static_cast<u32>(p), static_cast<u32>(mu >> (64 - 2 * k)), k};
}

__device__ __forceinline__ u32 reduce_short(u64 x, const ShortBarrett& b) {
  const u32 q1 = static_cast<u32>(x >> (b.k - 1));
  const u32 q = static_cast<u32>((static_cast<u64>(q1) * b.mu_k) >> (b.k + 1));
  u32 r = static_cast<u32>(x) - q * b.p;
  if (r >= 2 * b.p) r -= 2 * b.p;
  if (r >= b.p) r -= b.p;
  return r;
}

// a * b mod p for residues a, b < p < 2^30: the product is < p^2 < 2^(2k).
__device__ __forceinline__ u32 mulmod_b(u32 a, u32 b, const ShortBarrett& s) {
  return reduce_short(static_cast<u64>(a) * b, s);
}

// Lazy sums.  A reduced accumulator (< p) plus LAZY_FOLD raw products, each
// at most (p - 1)^2 < 2^60, stays below p + 8 * 2^60 < 2^30 + 2^63 < 2^64,
// so a u64 accumulator folded with barrett_reduce at least once every
// LAZY_FOLD products never wraps, for sums of any length.  (At p = 2^30 - 35
// the largest safe count is 16, with no margin: 16 * (p - 1)^2 is already
// 0.99999993 * 2^64; 8 leaves half the range free, and was the fastest of
// 4, 8 and 16 in spmv_ell (utils/kernel_sweeps.py, which builds with
// -DLAZY_FOLD=k; PERF.md).)  The kernels mask by it: a power of two.
#ifndef LAZY_FOLD
#define LAZY_FOLD 8
#endif
#if LAZY_FOLD < 1 || LAZY_FOLD > 16 || (LAZY_FOLD & (LAZY_FOLD - 1))
#error "LAZY_FOLD must be a power of two of at most 16"
#endif

// a^(p - 2) mod p for a residue 0 < a < p: the inverse by Fermat, with
// right-to-left square-and-multiply, so the chain of squares and the chain
// of products run side by side (about 30 dependent short-Barrett products
// for a 30-bit p).  p = 2 gives the exponent 0 and hence 1, the inverse of 1.
__device__ __forceinline__ u32 inv_fermat(u32 a, const ShortBarrett& s) {
  u32 r = 1, base = a;
  for (u32 e = s.p - 2; e; e >>= 1) {
    if (e & 1) r = mulmod_b(r, base, s);
    base = mulmod_b(base, base, s);
  }
  return r;
}

// The halt check and the k_done / frozen bookkeeping of the solver state
// [stop, inv_ok, k_done, frozen], as one thread of the grid does it (the
// narrow and the GF(2) orthogonalize kernels): thread 0 of block 0 counts
// the iteration while the state is not frozen and freezes it on a halt;
// true when the launch must leave v and p as they are.
__device__ __forceinline__ bool ortho_halt(int* state) {
  const bool halt = state[0] != 0 || state[1] == 0;
  if (blockIdx.x == 0 && threadIdx.x == 0 && state[3] == 0) {
    state[2] += 1;
    if (halt) state[3] = 1;
  }
  return halt;  // uniform over the grid: nobody writes stop/inv_ok here
}

// Error text for the codes the C entry points return (cudaGetLastError()).
extern "C" const char* bl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
