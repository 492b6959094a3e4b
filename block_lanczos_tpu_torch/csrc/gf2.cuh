// Shared pieces of the bitsliced GF(2) kernels (spmv_gf2, gram_gf2,
// semi_inverse_gf2, orthogonalize_gf2).
//
// A block of n vectors (n % 32 == 0, 32 <= n <= GF2_MAXN) is stored as
// W = n / 32 words per row, row-major, in int32 tensors: column c of the block
// is bit c % 32 of word c / 32 (ops/gf2.py).  Addition is XOR and
// multiplication AND, so every result is exact whatever the order of the
// XORs, the thread split or the block order: no kernel has a tolerance.
#pragma once

#include "modp.cuh"  // u32, ortho_halt, bl_error_string

#define GF2_MAXN 512
#define GF2_MAXW (GF2_MAXN / 32)
#define GF2_FULL_MASK 0xffffffffu

// All ones when bit b of x is set, else 0: the bit moved to the sign and
// spread by an arithmetic shift (two instructions, no branch).
__device__ __forceinline__ u32 bit_mask(u32 x, int b) {
  return static_cast<u32>(static_cast<int>(x << (31 - b)) >> 31);
}

// o[0 .. C) = row[0 .. C) from shared memory, as 16- or 8-byte loads where
// C allows; the caller keeps rows of C words 16-byte aligned when C % 4 == 0
// and 8-byte aligned when C % 2 == 0.
template <int C>
__device__ __forceinline__ void load_row(const u32* row, u32 (&o)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      const uint4 q = *reinterpret_cast<const uint4*>(row + c);
      o[c] = q.x, o[c + 1] = q.y, o[c + 2] = q.z, o[c + 3] = q.w;
    }
  } else if constexpr (C % 2 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 2) {
      const uint2 q = *reinterpret_cast<const uint2*>(row + c);
      o[c] = q.x, o[c + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) o[c] = row[c];
  }
}

// row[0 .. C) = a[0 .. C) in shared memory, as load_row reads it.
template <int C>
__device__ __forceinline__ void store_row(u32* row, const u32 (&a)[C]) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 4)
      *reinterpret_cast<uint4*>(row + c) =
          make_uint4(a[c], a[c + 1], a[c + 2], a[c + 3]);
  } else if constexpr (C % 2 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 2)
      *reinterpret_cast<uint2*>(row + c) = make_uint2(a[c], a[c + 1]);
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) row[c] = a[c];
  }
}

// The launchers instantiate a kernel template for every W = n / 32 the
// kernels take (1 .. GF2_MAXW) and switch on the runtime W.
#define GF2_SWITCH_W(W, CALL)                                              \
  switch (W) {                                                             \
    case 1: CALL(1); case 2: CALL(2); case 3: CALL(3); case 4: CALL(4);    \
    case 5: CALL(5); case 6: CALL(6); case 7: CALL(7); case 8: CALL(8);    \
    case 9: CALL(9); case 10: CALL(10); case 11: CALL(11);                 \
    case 12: CALL(12); case 13: CALL(13); case 14: CALL(14);               \
    case 15: CALL(15); case 16: CALL(16);                                  \
    default: return cudaErrorInvalidValue;                                 \
  }

static int gf2_sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}
