// spmv_gf2 — the GF(2) sparse product y = op * x over bit-packed blocks.
//
// Replaces, in the JAX package, models/lanczos_gf2.py::spmv_gf2 (the ELL
// slab walk gated by the bit-packed `valid` mask and the XOR-prefix spill),
// which XLA compiled on the TPU.  Computes, for r < out_dim and each word w
// of the W = n / 32 words of a row,
//
//   y[r, w] = XOR over k < ell with bit k % 32 of valid[k / 32, r] set
//             of x[cols[k, r], w]
//           ^ XOR over e in rowptr[r] .. rowptr[r+1] of x[sp_cols[e], w]
//
// and y[r, :] = 0 for out_dim <= r < out_rows (zero padding must stay zero
// through every phase of the solver).  Every surviving entry is 1 mod 2, so
// the operator streams column indices only.  Padding slots of the slab hold
// column 0, a real row of x: only `valid` excludes them.
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
//
// What bounds it on an H100: memory.  The byte floor (chip_smoke.py) is the
// column stream, 4 B per true nonzero, plus the valid words and rowptr read,
// x read once and y written once, at 3.35 TB/s.  But each nonzero also
// gathers a row of x (16 B at n = 128) at a random row, as a 32-byte L2
// sector: x (9.6 MB at the bench size, n = 128) stays in the 50 MB L2, and
// the gather moves twice the row through it, as in spmv_ell.
#include <cstdint>

#include "gf2.cuh"

#define SPMV_GF2_THREADS 128
#define SPMV_GF2_CHUNK 8

template <int VW>
struct Words;
template <>
struct Words<4> {
  static __device__ __forceinline__ void load(const int* p, u32 (&o)[4]) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  }
  static __device__ __forceinline__ void store(int* p, const u32 (&a)[4]) {
    *reinterpret_cast<int4*>(p) =
        make_int4(static_cast<int>(a[0]), static_cast<int>(a[1]),
                  static_cast<int>(a[2]), static_cast<int>(a[3]));
  }
};
template <>
struct Words<2> {
  static __device__ __forceinline__ void load(const int* p, u32 (&o)[2]) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(p));
    o[0] = v.x, o[1] = v.y;
  }
  static __device__ __forceinline__ void store(int* p, const u32 (&a)[2]) {
    *reinterpret_cast<int2*>(p) =
        make_int2(static_cast<int>(a[0]), static_cast<int>(a[1]));
  }
};
template <>
struct Words<1> {
  static __device__ __forceinline__ void load(const int* p, u32 (&o)[1]) {
    o[0] = static_cast<u32>(__ldg(p));
  }
  static __device__ __forceinline__ void store(int* p, const u32 (&a)[1]) {
    *p = static_cast<int>(a[0]);
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
      Words<VW>::load(x + static_cast<long long>(col[u]) * W + lane0, xv[u]);
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
__global__ void spmv_gf2_kernel(const int* __restrict__ cols,
                                const int* __restrict__ valid, int ell,
                                long long ld, const int* __restrict__ rowptr,
                                const int* __restrict__ sp_cols,
                                const int* __restrict__ x,
                                int* __restrict__ y, long long out_dim,
                                long long out_rows, int W, int groups) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= out_rows * groups) return;
  const long long r = t / groups;
  const int lane0 = static_cast<int>(t - r * groups) * VW;
  u32 acc[VW];
#pragma unroll
  for (int l = 0; l < VW; ++l) acc[l] = 0;
  if (r < out_dim) {
    int col[SPMV_GF2_CHUNK];
    for (int k0 = 0; k0 < ell; k0 += 32) {
      u32 bits = static_cast<u32>(__ldg(valid + (k0 >> 5) * ld + r));
      if (ell - k0 < 32) bits &= (1u << (ell - k0)) - 1u;  // no slot >= ell
      while (bits) {
#pragma unroll
        for (int u = 0; u < SPMV_GF2_CHUNK; ++u) {
          col[u] = -1;
          if (bits) {
            const int k = k0 + __ffs(bits) - 1;
            bits &= bits - 1u;
            col[u] = __ldg(cols + static_cast<long long>(k) * ld + r);
          }
        }
        xor_rows<VW>(col, x, W, lane0, acc);
      }
    }
    const int e1 = __ldg(rowptr + r + 1);
    for (int e0 = __ldg(rowptr + r); e0 < e1; e0 += SPMV_GF2_CHUNK) {
#pragma unroll
      for (int u = 0; u < SPMV_GF2_CHUNK; ++u)
        col[u] = e0 + u < e1 ? __ldg(sp_cols + e0 + u) : -1;
      xor_rows<VW>(col, x, W, lane0, acc);
    }
  }
  Words<VW>::store(y + r * W + lane0, acc);
}

template <int VW>
static void launch(const int* cols, const int* valid, int ell, long long ld,
                   const int* rowptr, const int* sp_cols, const int* x, int* y,
                   long long out_dim, long long out_rows, int W,
                   cudaStream_t stream) {
  const int threads = SPMV_GF2_THREADS;
  const int groups = W / VW;
  const long long total = out_rows * groups;
  if (total <= 0) return;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  spmv_gf2_kernel<VW><<<blocks, threads, 0, stream>>>(
      cols, valid, ell, ld, rowptr, sp_cols, x, y, out_dim, out_rows, W,
      groups);
}

extern "C" int spmv_gf2(const int* cols, const int* valid, int ell,
                        long long ld, const int* rowptr, const int* sp_cols,
                        const int* x, int* y, long long out_dim,
                        long long out_rows, int W, void* stream) {
  if (W < 1 || W > GF2_MAXW || ell < 0 || out_rows < out_dim)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  if (W % 4 == 0 && align % 16 == 0)
    launch<4>(cols, valid, ell, ld, rowptr, sp_cols, x, y, out_dim, out_rows,
              W, s);
  else if (W % 2 == 0 && align % 8 == 0)
    launch<2>(cols, valid, ell, ld, rowptr, sp_cols, x, y, out_dim, out_rows,
              W, s);
  else
    launch<1>(cols, valid, ell, ld, rowptr, sp_cols, x, y, out_dim, out_rows,
              W, s);
  return static_cast<int>(cudaGetLastError());
}
