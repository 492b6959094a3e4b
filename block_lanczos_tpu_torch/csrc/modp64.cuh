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
// lazy_dot_wide, almost_inverse_np, mont_inverse_np).
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

// The inverse: Kaliski's almost inverse, a binary extended GCD ("The
// Montgomery inverse and its applications", IEEE Trans. Computers 44(8),
// 1995, phase I).  From u = p, v = a (0 < a < p, p odd) and r = 0, s = 1
// each of its bit steps removes one bit from u or v:
//   u even:           u = u / 2,        s = 2 s
//   v even:           v = v / 2,        r = 2 r
//   both odd, u > v:  u = (u - v) / 2,  r = r + s,  s = 2 s
//   both odd, u <= v: v = (v - u) / 2,  s = s + r,  r = 2 r
// keeping p = u s + v r, until v = 0 (then u = gcd = 1); with k bit steps,
// p - (r mod p) = a^-1 2^k mod p and m <= k <= 2m for m = bitlen(p).
// Here one step takes a subtraction and every halving after it at once:
// with u and v odd, d = |u - v| is even, and t = ctz(d) halvings of it
// (t = 1 for d = 0, the last step) are the t bit steps "both odd", then
// t - 1 times "u even" (or "v even"): the larger of u, v becomes d / 2^t,
// r (or s) takes r + s and s (or r) is shifted by t, and k grows by t.  So
// a step is one dependent subtract, count-trailing-zeros and shift (~44 of
// them for a 61-bit p: a halving run is 2 bits long on average), where the
// bit steps take ~88.  Bounds: while v > 0, u s + v r = p with u, v >= 1
// keeps r, s <= p at every bit step; the last one (u = v = 1) leaves
// r <= 2p < 2^63, so u64 holds them.  Branch-free but for the loop.
// ops/gfp_wide.py::almost_inverse_np mirrors it bit step by bit step and
// counts both.
__device__ __forceinline__ u64 almost_inverse(u64 a, u64 p, int& k,
                                              int& steps) {
  int t = __ffsll(static_cast<long long>(a)) - 1;  // a's halvings: r = 0
  u64 u = p, v = a >> t, r = 0, s = 1;
  k = t;
  steps = 0;
  do {
    const bool gt = u > v;
    const u64 d = gt ? u - v : v - u;
    t = d ? __ffsll(static_cast<long long>(d)) - 1 : 1;
    const u64 h = d >> t, rs = r + s;
    r = gt ? rs : r << t;
    s = gt ? s << t : rs;
    u = gt ? h : u;
    v = gt ? v : h;
    k += t;
    ++steps;
  } while (v != 0);
  if (r >= p) r -= p;
  return p - r;
}

// The Montgomery form of a^-1 from that of a (a != 0): a = REDC(a~), then
// x = a^-1 2^k (almost_inverse, m <= k <= 2m), then x 2^(64 - k):
//   * k <= 64: x 2^(64 - k) < 2^m 2^(64 - m) fits a word; one Barrett
//     reduction;
//   * k > 64: x 2^-t with t = k - 64 <= 60, a REDC by 2^t: c = x pinv mod
//     2^t makes x + c p a multiple of 2^t, and (x + c p) / 2^t < p / 2^t +
//     p < 2p takes one conditional subtract.
// The dependent chain is the steps (~44 on average for a 61-bit p);
// `steps` returns their count.  ops/gfp_wide.py::mont_inverse_np mirrors
// it.
__device__ __forceinline__ u64 mont_inverse(u64 am, const WideField& f,
                                            int& steps) {
  int k;
  const u64 x = almost_inverse(redc(0, am, f), f.p, k, steps);
  if (k <= 64) return barrett_reduce(x << (64 - k), f.p, f.mu);
  const int t = k - 64;
  U128 T = {x, 0};
  mac128(T, (x * f.pinv) & ((1ull << t) - 1), f.p);
  const u64 y = (T.lo >> t) | (T.hi << (64 - t));
  return y >= f.p ? y - f.p : y;
}
