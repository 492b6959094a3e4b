// Shared u64 arithmetic for the wide-field kernels (2^30 - 35 < p < 2^62,
// p odd): spmv_wide, gram_wide, semi_inverse_wide, orthogonalize_wide.
//
// Residues live in int64 tensors with 0 <= r < p < 2^62 and are read here as
// u64.  The TPU held them as uint32 pairs with 15-bit limb sums
// (ops/gfp_wide.py in the JAX package); Hopper multiplies 64 x 64 -> 128
// bits itself (a * b and __umul64hi, several IMADs each), so a product is
// formed exactly in two u64 words and sums are kept in 128 bits.  Integer
// sums are associative: every result is bit-exact whatever the order.
//
// No kernel reduces with `%`.  Four constants, computed on the host once per
// prime (ops/gfp_wide.py::GFpWide) and passed with p:
//   mu   = floor(2^64 / p)    Barrett: modp.cuh::barrett_reduce, exact for
//                             every u64 and p < 2^63;
//   pinv = -p^-1 mod 2^64     Montgomery with R = 2^64 (p odd);
//   r2   = 2^128 mod p        R^2, to leave the Montgomery scale.
// Each step has a NumPy mirror in ops/gfp_wide.py that the CPU tests hold
// against Python ints (mul128_np, fold_np, redc_np, reduce128_np,
// lazy_dot_wide, inv_mont_np).
#pragma once

#include "modp.cuh"

struct WideField {
  u64 p, mu, pinv, r2;
};

// A 128-bit sum: value = hi * 2^64 + lo.
struct U128 {
  u64 lo, hi;
};

// acc += a * b, the exact 128-bit product (no bound needed here; the callers
// keep acc below 2^128, see the lazy-sum budget below).
__device__ __forceinline__ void mac128(U128& acc, u64 a, u64 b) {
  const u64 lo = a * b;
  const u64 hi = __umul64hi(a, b);
  acc.lo += lo;
  acc.hi += hi + (acc.lo < lo);
}

__device__ __forceinline__ void add128(U128& acc, u64 a) {
  acc.lo += a;
  acc.hi += acc.lo < a;
}

// The fold: the high word reduced mod p by Barrett.  The value changes by a
// multiple of p * 2^64, so it stays the same mod p, and afterwards
// acc < p * 2^64.
__device__ __forceinline__ void fold128(U128& acc, const WideField& f) {
  acc.hi = barrett_reduce(acc.hi, f.p, f.mu);
}

// Montgomery reduction with R = 2^64: for T = hi * 2^64 + lo < p * 2^64,
// returns T * 2^-64 mod p in [0, p).
//
// Proof.  m = lo * pinv mod 2^64 makes lo + (m p mod 2^64) = 0 mod 2^64, so
// T + m p is a multiple of 2^64, and (T + m p) / 2^64 = hi + hi(m p) + c,
// where the carry c of lo + lo(m p) is 1 exactly when lo != 0 (two words
// that sum to 0 mod 2^64 carry unless both are 0).  It is congruent to
// T * 2^-64 mod p, and below (p 2^64 + 2^64 p) / 2^64 = 2p < 2^63, so one
// conditional subtract makes it canonical.
__device__ __forceinline__ u64 redc(u64 hi, u64 lo, const WideField& f) {
  const u64 m = lo * f.pinv;
  const u64 r = hi + __umul64hi(m, f.p) + (lo != 0);
  return r >= f.p ? r - f.p : r;
}

// a * b * 2^-64 mod p for a, b < p: a b < p^2, so its high word is below
// p^2 / 2^64 < p and REDC takes it as it is.  For the Montgomery forms
// a~ = a 2^64, b~ = b 2^64 mod p it gives (a b)~.
__device__ __forceinline__ u64 mont_mul(u64 a, u64 b, const WideField& f) {
  return redc(__umul64hi(a, b), a * b, f);
}

// T * 2^-64 mod p for any 128-bit T: fold, then REDC.  With one factor of
// every product in Montgomery form (semi_inverse_wide's winv), this is the
// exact sum itself.
__device__ __forceinline__ u64 reduce_mont(U128 acc, const WideField& f) {
  fold128(acc, f);
  return redc(acc.hi, acc.lo, f);
}

// T mod p for any 128-bit T: fold (T' = T mod p * 2^64 < p 2^64), REDC
// (T 2^-64 mod p), then a Montgomery product with r2 = 2^128 mod p:
// T 2^-64 * 2^128 * 2^-64 = T mod p.
__device__ __forceinline__ u64 reduce128(U128 acc, const WideField& f) {
  return mont_mul(reduce_mont(acc, f), f.r2, f);
}

// Lazy sums.  After a fold acc < p 2^64 < 2^126; each raw product of two
// residues is at most (p - 1)^2 < 2^124, and the orthogonalize base adds one
// residue below p < 2^62.  So p 2^64 + WIDE_FOLD (p - 1)^2 + p < 2^126 +
// 8 * 2^124 + 2^62 = 3 * 2^126 + 2^62 < 2^128: a 128-bit accumulator folded
// at least once every WIDE_FOLD products never wraps, for sums of any length
// (slab, spill, Gram rows, the 2n terms of the update).  The largest safe
// count is 11; 8 is the power of two below it, which the kernels mask by.
// (REDC alone, with no fold, would take only k with k (p - 1)^2 < p 2^64,
// k <= 4 near 2^62: the Barrett fold of the high word is what lets the sums
// run longer.)  ops/gfp_wide.py::lazy_dot_wide mirrors it with Python ints.
#define WIDE_FOLD 8

// a + b mod p for residues (a + b < 2p < 2^63).
__device__ __forceinline__ u64 addmod64(u64 a, u64 b, u64 p) {
  const u64 s = a + b;
  return s >= p ? s - p : s;
}

// The Montgomery form of a^-1 from that of a (a != 0): a~^(p - 2) by
// right-to-left square-and-multiply on Montgomery products (a Montgomery
// product of forms is the form of the product), from one~ = 2^64 mod p.
// About 62 squarings and as many products for a 62-bit p, two chains side
// by side.
__device__ __forceinline__ u64 inv_mont(u64 am, const WideField& f) {
  u64 r = mont_mul(1, f.r2, f);  // 2^64 mod p
  u64 base = am;
  for (u64 e = f.p - 2; e; e >>= 1) {
    if (e & 1) r = mont_mul(r, base, f);
    base = mont_mul(base, base, f);
  }
  return r;
}
