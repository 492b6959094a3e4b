// spmv_gf2 — the GF(2) sparse product y = op * x over bit-packed blocks.
//
// Replaces, in the JAX package, models/lanczos_gf2.py::spmv_gf2 (the ELL
// slab walk gated by the bit-packed `valid` mask and the XOR-prefix spill),
// which XLA compiled on the TPU.  Computes, for r < out_dim and each word w
// of the W = n / 32 words of a row,
//
//   y[r, w] (^)= XOR over k < ell with bit k % 32 of valid[k / 32, r] set
//                of x[cols[k, r], w]
//              ^ XOR over e in rowptr[r] .. rowptr[r+1] of x[sp_cols[e], w]
//
// with `=` for the first launch of a product and `^=` for the later column
// bands (`accumulate`), and y[r, :] = 0 for out_dim <= r < out_rows (zero
// padding must stay zero through every phase of the solver).  Every
// surviving entry is 1 mod 2, so the operator streams column indices only.
// Padding slots of the slab hold column 0, a real row of x: only `valid`
// excludes them.
//
// Design.  One thread owns one row and a group of VW words (VW = 4 when
// W % 4 == 0 and x, y are 16-byte aligned, else 2 or 1): it gathers
// x[col, VW*g .. VW*g + VW) as one vector load, so at n = 128 (W = 4) a
// thread is a row and a warp's slab loads cols[k, r..r+32) are one coalesced
// 128-byte request; at n = 256 two neighbouring threads share a row.  The
// slab (column-major, (ell, out_dim)) is walked by the set bits of each
// valid word (so padding slots cost no load), then the row's spill; both in
// chunks of SPMV_GF2_CHUNK entries whose column loads and gathers of x are
// issued together, for memory-level parallelism.
//   The L2 is told what not to keep, per instruction: the index streams
// (cols, valid, rowptr, sp_cols), each read once, load evict-first (ld.global.cs) and y is stored evict-first (st.global.cs), so
// the stream sweeps less of x out of the L2.  No access-policy window is set
// on the stream: a window would outlive the launch and change the other
// kernels' caching.  An L2 evict_last policy on the gathers of x
// (createpolicy + ld.global.L2::cache_hint) was measured no faster than
// these hints alone and is not used; the hints gain up to 9% over plain
// loads and stores past the L2 (PERF.md).
//   Where x is larger than the L2 can hold even so, the layout builder
// (models/lanczos_gf2.py::make_gf2_bands) splits the operator by column into
// bands whose slice of x fits, sized from the card's L2 at run time; the
// wrapper launches once per band on one stream, the first writing y and the
// rest XORing into it.  A single band is the unbanded layout.
//
// What bounds it on an H100: memory.  The byte floor (chip_smoke.py) is the
// column stream, 4 B per true nonzero, plus the valid words and rowptr read,
// x read once and y written once, at 3.35 TB/s.  But each nonzero also
// gathers a row of x (16 B at n = 128) at a random row, as a 32-byte
// sector: from the L2 while x (or its band) stays there, from HBM when it
// does not (x is 48 MB at 3M rows, n = 128, 96 MB at n = 256).
#include <cstdint>

#include "gf2.cuh"

#ifndef SPMV_GF2_THREADS
#define SPMV_GF2_THREADS 128
#endif
#ifndef SPMV_GF2_CHUNK
#define SPMV_GF2_CHUNK 8
#endif

// An index-stream load: read once, evict first.
__device__ __forceinline__ int ld_stream(const int* p) { return __ldcs(p); }

template <int VW>
struct Words;
template <>
struct Words<4> {
  static __device__ __forceinline__ void gather(const int* p, u32 (&o)[4]) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  }
  static __device__ __forceinline__ void load_y(const int* p, u32 (&o)[4]) {
    const int4 v = *reinterpret_cast<const int4*>(p);
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  }
  static __device__ __forceinline__ void store(int* p, const u32 (&a)[4]) {
    __stcs(reinterpret_cast<int4*>(p),
           make_int4(static_cast<int>(a[0]), static_cast<int>(a[1]),
                     static_cast<int>(a[2]), static_cast<int>(a[3])));
  }
};
template <>
struct Words<2> {
  static __device__ __forceinline__ void gather(const int* p, u32 (&o)[2]) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(p));
    o[0] = v.x, o[1] = v.y;
  }
  static __device__ __forceinline__ void load_y(const int* p, u32 (&o)[2]) {
    const int2 v = *reinterpret_cast<const int2*>(p);
    o[0] = v.x, o[1] = v.y;
  }
  static __device__ __forceinline__ void store(int* p, const u32 (&a)[2]) {
    __stcs(reinterpret_cast<int2*>(p),
           make_int2(static_cast<int>(a[0]), static_cast<int>(a[1])));
  }
};
template <>
struct Words<1> {
  static __device__ __forceinline__ void gather(const int* p, u32 (&o)[1]) {
    o[0] = static_cast<u32>(__ldg(p));
  }
  static __device__ __forceinline__ void load_y(const int* p, u32 (&o)[1]) {
    o[0] = static_cast<u32>(*p);
  }
  static __device__ __forceinline__ void store(int* p, const u32 (&a)[1]) {
    __stcs(p, static_cast<int>(a[0]));
  }
};

// acc ^= x[col[u], lane0 .. lane0 + VW) for every u with col[u] >= 0; the
// gathers are all issued before any is used.
template <int VW>
__device__ __forceinline__ void xor_rows(const int (&col)[SPMV_GF2_CHUNK],
                                         const int* __restrict__ x, int W,
                                         int lane0, u32 (&acc)[VW]) {
  u32 xv[SPMV_GF2_CHUNK][VW];
#pragma unroll
  for (int u = 0; u < SPMV_GF2_CHUNK; ++u) {
    if (col[u] >= 0) {
      Words<VW>::gather(x + static_cast<long long>(col[u]) * W + lane0,
                        xv[u]);
    } else {
#pragma unroll
      for (int l = 0; l < VW; ++l) xv[u][l] = 0;
    }
  }
#pragma unroll
  for (int u = 0; u < SPMV_GF2_CHUNK; ++u)
#pragma unroll
    for (int l = 0; l < VW; ++l) acc[l] ^= xv[u][l];
}

template <int VW>
__global__ void __launch_bounds__(SPMV_GF2_THREADS)
spmv_gf2_kernel(const int* __restrict__ cols, const int* __restrict__ valid,
                int ell, long long ld, const int* __restrict__ rowptr,
                const int* __restrict__ sp_cols, const int* __restrict__ x,
                int* __restrict__ y, long long out_dim, long long out_rows,
                int W, int groups, int accumulate) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= out_rows * groups) return;
  const long long r = t / groups;
  const int lane0 = static_cast<int>(t - r * groups) * VW;
  u32 acc[VW];
#pragma unroll
  for (int l = 0; l < VW; ++l) acc[l] = 0;
  if (r >= out_dim) {          // zero padding: no band writes anything else
    if (!accumulate) Words<VW>::store(y + r * W + lane0, acc);
    return;
  }
  int col[SPMV_GF2_CHUNK];
  for (int k0 = 0; k0 < ell; k0 += 32) {
    u32 bits = static_cast<u32>(ld_stream(valid + (k0 >> 5) * ld + r));
    if (ell - k0 < 32) bits &= (1u << (ell - k0)) - 1u;  // no slot >= ell
    while (bits) {
#pragma unroll
      for (int u = 0; u < SPMV_GF2_CHUNK; ++u) {
        col[u] = -1;
        if (bits) {
          const int k = k0 + __ffs(bits) - 1;
          bits &= bits - 1u;
          col[u] = ld_stream(cols + static_cast<long long>(k) * ld + r);
        }
      }
      xor_rows<VW>(col, x, W, lane0, acc);
    }
  }
  const int e1 = ld_stream(rowptr + r + 1);
  for (int e0 = ld_stream(rowptr + r); e0 < e1; e0 += SPMV_GF2_CHUNK) {
#pragma unroll
    for (int u = 0; u < SPMV_GF2_CHUNK; ++u)
      col[u] = e0 + u < e1 ? ld_stream(sp_cols + e0 + u) : -1;
    xor_rows<VW>(col, x, W, lane0, acc);
  }
  if (accumulate) {
    u32 prev[VW];
    Words<VW>::load_y(y + r * W + lane0, prev);
#pragma unroll
    for (int l = 0; l < VW; ++l) acc[l] ^= prev[l];
  }
  Words<VW>::store(y + r * W + lane0, acc);
}

template <int VW>
static void launch(const int* cols, const int* valid, int ell, long long ld,
                   const int* rowptr, const int* sp_cols, const int* x, int* y,
                   long long out_dim, long long out_rows, int W,
                   int accumulate, cudaStream_t stream) {
  const int threads = SPMV_GF2_THREADS;
  const int groups = W / VW;
  const long long total = out_rows * groups;
  if (total <= 0) return;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  spmv_gf2_kernel<VW><<<blocks, threads, 0, stream>>>(
      cols, valid, ell, ld, rowptr, sp_cols, x, y, out_dim, out_rows, W,
      groups, accumulate);
}

extern "C" int spmv_gf2(const int* cols, const int* valid, int ell,
                        long long ld, const int* rowptr, const int* sp_cols,
                        const int* x, int* y, long long out_dim,
                        long long out_rows, int W, int accumulate,
                        void* stream) {
  if (W < 1 || W > GF2_MAXW || ell < 0 || out_rows < out_dim)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  if (W % 4 == 0 && align % 16 == 0)
    launch<4>(cols, valid, ell, ld, rowptr, sp_cols, x, y, out_dim, out_rows,
              W, accumulate, s);
  else if (W % 2 == 0 && align % 8 == 0)
    launch<2>(cols, valid, ell, ld, rowptr, sp_cols, x, y, out_dim, out_rows,
              W, accumulate, s);
  else
    launch<1>(cols, valid, ell, ld, rowptr, sp_cols, x, y, out_dim, out_rows,
              W, accumulate, s);
  return static_cast<int>(cudaGetLastError());
}
