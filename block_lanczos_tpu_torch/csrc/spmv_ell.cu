// spmv_ell — exact mod-p sparse product y = op * x over the hybrid layout.
//
// Replaces, in the JAX package, ops/spmm.py::spmv_hybrid (the ELL slab
// walk) together with ops/spmm.py::_spmv_prefix (the CSR spill's limb
// prefix-sum difference), which XLA compiled on the TPU.  Computes
//
//   y[r, j] = sum_k vals[k, r] * x[cols[k, r], j]
//           + sum_{e in rowptr[r] .. rowptr[r+1]} sp_vals[e] * x[sp_cols[e], j]
//
// mod p for r < out_dim, and y[r, :] = 0 for out_dim <= r < out_rows (zero
// padding must stay zero through every phase of the solver).
//
// Design.  One thread owns one row and a group of VW lanes (VW = 4 when
// n % 4 == 0 and x, y are 16-byte aligned, else 2 or 1): it gathers
// x[col, VW*g .. VW*g + VW) as one vector load, so at n = 4 a thread is a
// row and a warp's slab loads cols[k, r..r+32) / vals[k, r..r+32) are one
// coalesced 128-byte request per array, each word loaded once per row (not
// once per lane); at n = 32 eight neighbouring threads share a row and read
// neighbouring 16-byte pieces of it.  The slab (column-major, (L, out_dim))
// and then the row's spill are walked in chunks of LAZY_FOLD entries: a
// chunk's column/value loads and its gathers of x are issued together
// (LAZY_FOLD gathers in flight per thread, which is where the memory-level
// parallelism comes from at n = 4: only ~6 250 warps for the 200 000 rows of
// M^T).  Products are summed raw in u64 (one 32x32->64 multiply each) and
// the sum is reduced with barrett_reduce once per chunk: the bound in
// modp.cuh (LAZY_FOLD) holds for rows of any length, slab and spill alike.
// Empty slab slots (value 0) skip their gather.
//
// What bounds it on an H100.  The byte floor (chip_smoke.py) is the slab
// and spill stream, 8 B per true nonzero, plus x read once, y written once
// and rowptr, at 3.35 TB/s: 0.0134 ms per launch on average at the bench
// size, n = 4.  But every nonzero also gathers a row of x at a random row:
// x (4.8 MB at the bench size, n = 4) stays in the 50 MB L2 and is read in
// 32-byte sectors, of which a 16-byte row uses half, so each nonzero moves
// 32 B through L2 on top of its 8 B of slab: 144 MB of L2 sectors per
// launch at the bench size.  The measured time (PERF.md) is about 3.3x the
// HBM floor and puts those sectors through at about 3.3 TB/s: the L2
// gather, not HBM and not the integer arithmetic, is what bounds it now.
// Walking the spill in the same thread costs nothing measurable: M^T on its
// hybrid layout (ell 23 + spill) runs faster than on a slab-only layout
// (utils/kernel_sweeps.py; PERF.md), so the spill has no pass of its own.
#include <cstdint>

#include "modp.cuh"

// Threads per block: 128 was the fastest of 128, 256 and 512 at n = 4 and
// n = 32 (utils/kernel_sweeps.py, which builds with -DSPMV_THREADS=t;
// PERF.md).
#ifndef SPMV_THREADS
#define SPMV_THREADS 128
#endif

template <int VW>
struct Vec;
template <>
struct Vec<4> {
  static __device__ __forceinline__ void load(const int* p, u32 (&o)[4]) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  }
  static __device__ __forceinline__ void store(int* p, const u64 (&a)[4]) {
    *reinterpret_cast<int4*>(p) = make_int4(
        static_cast<int>(a[0]), static_cast<int>(a[1]),
        static_cast<int>(a[2]), static_cast<int>(a[3]));
  }
};
template <>
struct Vec<2> {
  static __device__ __forceinline__ void load(const int* p, u32 (&o)[2]) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(p));
    o[0] = v.x, o[1] = v.y;
  }
  static __device__ __forceinline__ void store(int* p, const u64 (&a)[2]) {
    *reinterpret_cast<int2*>(p) =
        make_int2(static_cast<int>(a[0]), static_cast<int>(a[1]));
  }
};
template <>
struct Vec<1> {
  static __device__ __forceinline__ void load(const int* p, u32 (&o)[1]) {
    o[0] = static_cast<u32>(__ldg(p));
  }
  static __device__ __forceinline__ void store(int* p, const u64 (&a)[1]) {
    *p = static_cast<int>(a[0]);
  }
};

// acc[l] (each < p on entry) += sum over one chunk of up to LAZY_FOLD
// entries (col, val) of val * x[col, lane0 + l], then reduced below p.
template <int VW>
__device__ __forceinline__ void chunk(const int (&col)[LAZY_FOLD],
                                      const u32 (&val)[LAZY_FOLD],
                                      const int* __restrict__ x, int n,
                                      int lane0, u64 p, u64 mu,
                                      u64 (&acc)[VW]) {
  u32 xv[LAZY_FOLD][VW];
#pragma unroll
  for (int u = 0; u < LAZY_FOLD; ++u) {
    if (val[u] != 0) {
      Vec<VW>::load(x + static_cast<long long>(col[u]) * n + lane0, xv[u]);
    } else {
#pragma unroll
      for (int l = 0; l < VW; ++l) xv[u][l] = 0;
    }
  }
#pragma unroll
  for (int u = 0; u < LAZY_FOLD; ++u)
#pragma unroll
    for (int l = 0; l < VW; ++l) acc[l] += static_cast<u64>(val[u]) * xv[u][l];
#pragma unroll
  for (int l = 0; l < VW; ++l) acc[l] = barrett_reduce(acc[l], p, mu);
}

template <int VW>
__global__ void spmv_ell_kernel(const int* __restrict__ cols,
                                const int* __restrict__ vals, int ell,
                                long long ld, const int* __restrict__ rowptr,
                                const int* __restrict__ sp_cols,
                                const int* __restrict__ sp_vals,
                                const int* __restrict__ x,
                                int* __restrict__ y, long long out_dim,
                                long long out_rows, int n, int groups, u64 p,
                                u64 mu) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= out_rows * groups) return;
  const long long r = t / groups;
  const int lane0 = static_cast<int>(t - r * groups) * VW;
  u64 acc[VW];
#pragma unroll
  for (int l = 0; l < VW; ++l) acc[l] = 0;
  if (r < out_dim) {
    int col[LAZY_FOLD];
    u32 val[LAZY_FOLD];
    for (int k0 = 0; k0 < ell; k0 += LAZY_FOLD) {
#pragma unroll
      for (int u = 0; u < LAZY_FOLD; ++u) {
        const bool in = k0 + u < ell;
        const long long s = static_cast<long long>(k0 + u) * ld + r;
        val[u] = in ? static_cast<u32>(__ldg(vals + s)) : 0u;
        col[u] = in ? __ldg(cols + s) : 0;
      }
      chunk<VW>(col, val, x, n, lane0, p, mu, acc);
    }
    const int e1 = __ldg(rowptr + r + 1);
    for (int e0 = __ldg(rowptr + r); e0 < e1; e0 += LAZY_FOLD) {
#pragma unroll
      for (int u = 0; u < LAZY_FOLD; ++u) {
        const bool in = e0 + u < e1;
        val[u] = in ? static_cast<u32>(__ldg(sp_vals + e0 + u)) : 0u;
        col[u] = in ? __ldg(sp_cols + e0 + u) : 0;
      }
      chunk<VW>(col, val, x, n, lane0, p, mu, acc);
    }
  }
  Vec<VW>::store(y + r * n + lane0, acc);
}

template <int VW>
static void launch(const int* cols, const int* vals, int ell, long long ld,
                   const int* rowptr, const int* sp_cols, const int* sp_vals,
                   const int* x, int* y, long long out_dim,
                   long long out_rows, int n, u64 p, u64 mu,
                   cudaStream_t stream) {
  const int threads = SPMV_THREADS;
  const int groups = n / VW;
  const long long total = out_rows * groups;
  if (total <= 0) return;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  spmv_ell_kernel<VW><<<blocks, threads, 0, stream>>>(
      cols, vals, ell, ld, rowptr, sp_cols, sp_vals, x, y, out_dim, out_rows,
      n, groups, p, mu);
}

extern "C" int spmv_ell(const int* cols, const int* vals, int ell,
                        long long ld, const int* rowptr, const int* sp_cols,
                        const int* sp_vals, const int* x, int* y,
                        long long out_dim, long long out_rows, int n,
                        unsigned long long p, unsigned long long mu,
                        void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  if (n % 4 == 0 && align % 16 == 0)
    launch<4>(cols, vals, ell, ld, rowptr, sp_cols, sp_vals, x, y, out_dim,
              out_rows, n, p, mu, s);
  else if (n % 2 == 0 && align % 8 == 0)
    launch<2>(cols, vals, ell, ld, rowptr, sp_cols, sp_vals, x, y, out_dim,
              out_rows, n, p, mu, s);
  else
    launch<1>(cols, vals, ell, ld, rowptr, sp_cols, sp_vals, x, y, out_dim,
              out_rows, n, p, mu, s);
  return static_cast<int>(cudaGetLastError());
}
