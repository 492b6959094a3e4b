// xoshiro_fill — the solvers' initial block v0, drawn on the card.
//
// Replaces, on a CUDA device, the host draw of utils/rng.py::
// Xoshiro256Plus.fill_mod / fill_mod64 and, over GF(2), the packing of its
// bits (ops/gf2.py::pack_bits_np): the same xoshiro256+ stream, value for
// value, so every iterate of a solve is the one the host draw gives.  The
// wrapper is ops/xoshiro.py::xoshiro_fill (LaneDraw builds its arguments).
//
// Lanes.  The stream's first `count` values are split into L = ceil(count /
// m) lanes, contiguous in stream order: lane l draws values l m .. l m + m - 1
// (the last lane fewer).  The generator's step is linear over GF(2), so the
// state l m draws ahead is J^l s, with J = T^m and T the 256 x 256 bit
// matrix of one step.  The host uploads J_k = J^(2^k) for k < levels =
// bit_length(L - 1) once a solver (utils/rng.py::jump_columns, each matrix
// as its 256 columns of four u64 words, column c the image of state bit c =
// bit c % 64 of word c / 64), and passes the current state s by value a
// draw; each lane applies the J_k of the set bits of its index to s (at
// most `levels` mat-vecs, in any order: the J_k commute) and then runs its m
// steps.  m is a multiple of 32 (rng.lane_plan), so a GF(2) lane owns whole
// 32-bit words of the packed block.
//
// Epilogue by field (the one thing that varies):
//   XF_GF2     random64 & 1, packed LSB-first: value i is bit i % 32 of word
//              i / 32 of `out` (u32), which for n % 32 == 0 is the solver's
//              (rows, n / 32) word block, row-major;
//   XF_NARROW  random64 mod p as int32 (p < 2^30);
//   XF_WIDE    random64 mod p as int64 (p < 2^62);
// both reductions by modp.cuh::barrett_reduce (exact for every u64, mu =
// floor(2^64 / p) from the host).  Values past `count` (the block's padding
// rows) are not written: the caller zeroes the block.
//
// Cost.  Each lane's mat-vecs: 256 masked XORs of a column (two 16-byte
// loads the whole warp shares, from L1) a level; its draws: ~20 integer
// instructions a step.  Stores are strided by m across a warp (each lane
// its own run of the block); the block is a few MB and each sector is filled
// by one lane's consecutive stores before it leaves the L2.  On the H100 the
// mat-vecs' latency sets the time at every lane count swept (2^10 .. 2^18,
// PERF.md): 0.29 ms for the 64M draws of a 500,000 x 128 GF(2) block, 0.24
// ms for 400,000 narrow residues, against seconds of NumPy on the host.
#include <stdint.h>

#include "modp.cuh"

#define XF_THREADS 128

enum { XF_GF2 = 0, XF_NARROW = 1, XF_WIDE = 2 };

struct Xoshiro {
  u64 s0, s1, s2, s3;

  // utils/rng.py::Xoshiro256Plus.fill_u64, one step
  __device__ __forceinline__ u64 next() {
    const u64 x = s0 + s3;
    const u64 r = ((x << 23) | (x >> 41)) + s0;
    const u64 t = s1 << 17;
    s2 ^= s0;
    s3 ^= s1;
    s1 ^= s2;
    s0 ^= s3;
    s2 ^= t;
    s3 = (s3 << 45) | (s3 >> 19);
    return r;
  }
};

// g <- J g over GF(2): the XOR of the columns of J at the set bits of g.
__device__ __forceinline__ void jump(const u64* __restrict__ J, Xoshiro& g) {
  const u64 s[4] = {g.s0, g.s1, g.s2, g.s3};
  u64 r0 = 0, r1 = 0, r2 = 0, r3 = 0;
  const ulonglong2* col = reinterpret_cast<const ulonglong2*>(J);
#pragma unroll
  for (int w = 0; w < 4; ++w) {
#pragma unroll 8
    for (int b = 0; b < 64; ++b) {
      const u64 mask = 0ull - ((s[w] >> b) & 1ull);
      const ulonglong2 lo = __ldg(col + 2 * (64 * w + b));
      const ulonglong2 hi = __ldg(col + 2 * (64 * w + b) + 1);
      r0 ^= lo.x & mask;
      r1 ^= lo.y & mask;
      r2 ^= hi.x & mask;
      r3 ^= hi.y & mask;
    }
  }
  g = {r0, r1, r2, r3};
}

template <int FIELD>
__global__ void __launch_bounds__(XF_THREADS)
    xoshiro_fill_kernel(const u64* __restrict__ jumps, int levels, Xoshiro g,
                        long long count, long long m, u64 p, u64 mu,
                        void* __restrict__ out) {
  const long long lane =
      static_cast<long long>(blockIdx.x) * XF_THREADS + threadIdx.x;
  const long long start = lane * m;
  if (start >= count) return;
  for (int k = 0; k < levels; ++k)
    if ((lane >> k) & 1) jump(jumps + 1024ll * k, g);
  const long long len = min(m, count - start);
  if (FIELD == XF_GF2) {
    u32* o = static_cast<u32*>(out) + start / 32;
    for (long long i = 0; i < len; i += 32) {
      u32 word = 0;
      if (len - i >= 32) {
#pragma unroll
        for (int b = 0; b < 32; ++b)
          word |= static_cast<u32>(g.next() & 1ull) << b;
      } else {
        for (int b = 0; b < len - i; ++b)
          word |= static_cast<u32>(g.next() & 1ull) << b;
      }
      o[i / 32] = word;
    }
  } else if (FIELD == XF_NARROW) {
    int* o = static_cast<int*>(out) + start;
    for (long long i = 0; i < len; ++i)
      o[i] = static_cast<int>(barrett_reduce(g.next(), p, mu));
  } else {
    long long* o = static_cast<long long*>(out) + start;
    for (long long i = 0; i < len; ++i)
      o[i] = static_cast<long long>(barrett_reduce(g.next(), p, mu));
  }
}

// jumps: (levels, 256, 4) u64 on the device; s0..s3 the generator's state
// before the draw; m the lane length (a multiple of 32); field XF_*; p, mu
// the prime and floor(2^64 / p) (XF_GF2 ignores them).
extern "C" int xoshiro_fill(const void* jumps, int levels, u64 s0, u64 s1,
                            u64 s2, u64 s3, long long count, long long m,
                            int field, u64 p, u64 mu, void* out,
                            void* stream) {
  if (count < 0 || m < 32 || m % 32 != 0 || levels < 0 || levels > 62 ||
      field < XF_GF2 || field > XF_WIDE)
    return cudaErrorInvalidValue;
  const long long lanes = (count + m - 1) / m;
  if (lanes > 1 && ((lanes - 1) >> levels) != 0) return cudaErrorInvalidValue;
  if (count == 0) return static_cast<int>(cudaGetLastError());
  const auto s = static_cast<cudaStream_t>(stream);
  const auto grid =
      static_cast<unsigned>((lanes + XF_THREADS - 1) / XF_THREADS);
  const Xoshiro g{s0, s1, s2, s3};
  const auto J = static_cast<const u64*>(jumps);
  if (field == XF_GF2)
    xoshiro_fill_kernel<XF_GF2><<<grid, XF_THREADS, 0, s>>>(
        J, levels, g, count, m, p, mu, out);
  else if (field == XF_NARROW)
    xoshiro_fill_kernel<XF_NARROW><<<grid, XF_THREADS, 0, s>>>(
        J, levels, g, count, m, p, mu, out);
  else
    xoshiro_fill_kernel<XF_WIDE><<<grid, XF_THREADS, 0, s>>>(
        J, levels, g, count, m, p, mu, out);
  return static_cast<int>(cudaGetLastError());
}
