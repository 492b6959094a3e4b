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

// The 32 x 32 bit transpose across a warp, of two matrices at once: lane l
// holds row l of each (bit c is element (l, c)) and gets column l (bit c is
// element (c, l)).  Stage j swaps the j x j blocks off the diagonal of every
// 2j x 2j block: a lane keeps the bits of mask K (lo below, ~lo above the
// j boundary of lanes) and gives away the others of x1 and of x2, the latter
// rotated into the free half, in one shuffle (a rotation never wraps here).
__device__ __forceinline__ void transpose32x2(u32& x1, u32& x2, int lane) {
#pragma unroll
  for (int s = 0; s < 5; ++s) {
    const int j = 16 >> s;
    const u32 lo = s == 0 ? 0x0000ffffu : s == 1 ? 0x00ff00ffu
                 : s == 2 ? 0x0f0f0f0fu : s == 3 ? 0x33333333u : 0x55555555u;
    const bool up = lane & j;
    const u32 K = up ? ~lo : lo;
    const int r = up ? j : 32 - j;
    const u32 give = (x1 & ~K) | __funnelshift_l(x2 & ~K, x2 & ~K, r);
    const u32 o = __shfl_xor_sync(GF2_FULL_MASK, give, j);
    x1 = (x1 & K) | __funnelshift_l(o & K, o & K, 32 - r);
    x2 = (x2 & K) | (o & ~K);
  }
}

// c += popc(A & B) on one 16 x 8 x 256 tile of bits.
__device__ __forceinline__ void mma_b1(int (&c)[4], const u32 (&a)[4],
                                       const u32 (&b)[2]) {
  asm("mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// o[0 .. C) = row[0 .. C) from shared memory, as 16- or 8-byte loads where
// C allows; the caller keeps rows of C words 16-byte aligned when C % 4 == 0
// and 8-byte aligned when C % 2 == 0.  Loads that hold only words below
// `from` are skipped (those of o are left as they are).
template <int C>
__device__ __forceinline__ void load_row(const u32* row, u32 (&o)[C],
                                         int from = 0) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      if (c + 4 <= from) continue;
      const uint4 q = *reinterpret_cast<const uint4*>(row + c);
      o[c] = q.x, o[c + 1] = q.y, o[c + 2] = q.z, o[c + 3] = q.w;
    }
  } else if constexpr (C % 2 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 2) {
      if (c + 2 <= from) continue;
      const uint2 q = *reinterpret_cast<const uint2*>(row + c);
      o[c] = q.x, o[c + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int c = from; c < C; ++c) o[c] = row[c];
  }
}

// row[0 .. C) = a[0 .. C) in shared memory, as load_row reads it (stores
// that hold only words below `from` skipped).
template <int C>
__device__ __forceinline__ void store_row(u32* row, const u32 (&a)[C],
                                          int from = 0) {
  if constexpr (C % 4 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 4) {
      if (c + 4 <= from) continue;
      *reinterpret_cast<uint4*>(row + c) =
          make_uint4(a[c], a[c + 1], a[c + 2], a[c + 3]);
    }
  } else if constexpr (C % 2 == 0) {
#pragma unroll
    for (int c = 0; c < C; c += 2) {
      if (c + 2 <= from) continue;
      *reinterpret_cast<uint2*>(row + c) = make_uint2(a[c], a[c + 1]);
    }
  } else {
#pragma unroll
    for (int c = from; c < C; ++c) row[c] = a[c];
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
