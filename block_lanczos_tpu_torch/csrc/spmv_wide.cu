// spmv_wide — exact y = op * x mod p for wide primes (p < 2^62) over the
// hybrid ELL + CSR-spill layout, on u64 residues.
//
// Replaces, in the JAX package, ops/wide_ops.py::spmv_wide (the ELL slab
// walk on Montgomery uint32 pairs with 15-bit limb sums) together with
// ops/wide_ops.py::_spmv_spill_prefix (the spill's limb prefix sums) and
// spmv_wide_banded (the sum over input bands), which XLA compiled on the
// TPU.  Computes
//
//   y[r, j] = sum_k vals[k, r] * x[cols[k, r], j]
//           + sum_{e in rowptr[r] .. rowptr[r+1]} sp_vals[e] * x[sp_cols[e], j]
//
// mod p for r < out_dim, and y[r, :] = 0 for out_dim <= r < out_rows.  The
// values are standard residues (not Montgomery forms); the layout is the
// narrow field's (ops/spmm.py: column-major (L, out_dim) slab of int32
// columns, here with int64 values).  The port's layout has no input bands:
// mod-p sums are associative, so one monolithic pass equals JAX's bands.
//
// Design.  One thread owns one row and a group of VW lanes (VW = 4 when
// n % 4 == 0 and x, y are 16-byte aligned, else 2 or 1): at n = 4 a
// thread is a row and gathers x[col, 0..4) as two 16-byte loads (a 32-byte
// sector).  The slab and then the row's spill are walked in chunks of
// SPMV_WIDE_CHUNK <= WIDE_FOLD entries: a chunk's column/value loads and its
// gathers are issued together, the products are summed raw in 128 bits
// (mac128), and the sum's high word is folded by Barrett once per chunk
// (modp64.cuh proves the budget); each output is reduced once, by
// reduce128, at the end.
// Empty slab slots (value 0) skip their gather.
//
// What bounds it on an H100 (PERF.md): at the bench size, n = 4, bytes and
// operations come close.  Bytes: 12 B of slab (int32 column + int64 value)
// per nonzero, x read once and y written once, rowptr: ~70 MB for M^T,
// 0.021 ms at 3.35 TB/s.  Operations: a 64 x 64 -> 128-bit multiply-add is
// about 8 integer instructions (a * b as 3 IMADs, __umul64hi as 4, the
// carry add), so 4.5 M nonzeros x 4 columns x 8 = 144 M instructions,
// 0.002 ms at 67 T/s; the gather of x from the L2 (32 B a nonzero at
// n = 4) comes on top, as in spmv_ell.
#include <cstdint>

#include "modp64.cuh"

// Threads a block, and entries a thread gathers at a time and folds after
// (at most WIDE_FOLD): 4 x 256 was the fastest of {2, 4, 8} x {64, 128,
// 256} in both directions at the bench size, n = 4, on an H100 80GB HBM3 at
// 700 W, 25-35% ahead of 8 x 128 (fewer registers at VW = 4, which holds 4
// u64 of x an entry, so more warps an SM; utils/kernel_sweeps.py builds
// with -DSPMV_WIDE_CHUNK=c and -DSPMV_WIDE_THREADS=t; PERF.md).
#ifndef SPMV_WIDE_THREADS
#define SPMV_WIDE_THREADS 256
#endif
#ifndef SPMV_WIDE_CHUNK
#define SPMV_WIDE_CHUNK 4
#endif
#if SPMV_WIDE_CHUNK < 1 || SPMV_WIDE_CHUNK > WIDE_FOLD
#error "SPMV_WIDE_CHUNK must be in [1, WIDE_FOLD]"
#endif

template <int VW>
__device__ __forceinline__ void load_x(const u64* p, u64 (&o)[VW]) {
  if constexpr (VW == 1) {
    o[0] = __ldg(p);
  } else {
#pragma unroll
    for (int h = 0; h < VW / 2; ++h) {
      const ulonglong2 v = __ldg(reinterpret_cast<const ulonglong2*>(p) + h);
      o[2 * h] = v.x, o[2 * h + 1] = v.y;
    }
  }
}

template <int VW>
__device__ __forceinline__ void store_y(u64* p, const u64 (&a)[VW]) {
  if constexpr (VW == 1) {
    *p = a[0];
  } else {
#pragma unroll
    for (int h = 0; h < VW / 2; ++h)
      reinterpret_cast<ulonglong2*>(p)[h] = make_ulonglong2(a[2 * h], a[2 * h + 1]);
  }
}

// acc[l] += sum over one chunk of up to SPMV_WIDE_CHUNK entries (col, val)
// of val * x[col, lane0 + l], then the fold.
template <int VW>
__device__ __forceinline__ void chunk(const int (&col)[SPMV_WIDE_CHUNK],
                                      const u64 (&val)[SPMV_WIDE_CHUNK],
                                      const u64* __restrict__ x, int n,
                                      int lane0, const WideField& f,
                                      U128 (&acc)[VW]) {
  u64 xv[SPMV_WIDE_CHUNK][VW];
#pragma unroll
  for (int u = 0; u < SPMV_WIDE_CHUNK; ++u) {
    if (val[u] != 0) {
      load_x<VW>(x + static_cast<long long>(col[u]) * n + lane0, xv[u]);
    } else {
#pragma unroll
      for (int l = 0; l < VW; ++l) xv[u][l] = 0;
    }
  }
#pragma unroll
  for (int u = 0; u < SPMV_WIDE_CHUNK; ++u)
#pragma unroll
    for (int l = 0; l < VW; ++l) mac128(acc[l], val[u], xv[u][l]);
#pragma unroll
  for (int l = 0; l < VW; ++l) fold128(acc[l], f);
}

template <int VW>
__global__ void __launch_bounds__(SPMV_WIDE_THREADS)
    spmv_wide_kernel(const int* __restrict__ cols, const u64* __restrict__ vals,
                     int ell, long long ld, const int* __restrict__ rowptr,
                     const int* __restrict__ sp_cols,
                     const u64* __restrict__ sp_vals,
                     const u64* __restrict__ x, u64* __restrict__ y,
                     long long out_dim, long long out_rows, int n, int groups,
                     WideField f) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= out_rows * groups) return;
  const long long r = t / groups;
  const int lane0 = static_cast<int>(t - r * groups) * VW;
  U128 acc[VW];
#pragma unroll
  for (int l = 0; l < VW; ++l) acc[l] = {0, 0};
  if (r < out_dim) {
    int col[SPMV_WIDE_CHUNK];
    u64 val[SPMV_WIDE_CHUNK];
    for (int k0 = 0; k0 < ell; k0 += SPMV_WIDE_CHUNK) {
#pragma unroll
      for (int u = 0; u < SPMV_WIDE_CHUNK; ++u) {
        const bool in = k0 + u < ell;
        const long long s = static_cast<long long>(k0 + u) * ld + r;
        val[u] = in ? __ldg(vals + s) : 0ull;
        col[u] = in ? __ldg(cols + s) : 0;
      }
      chunk<VW>(col, val, x, n, lane0, f, acc);
    }
    const int e1 = __ldg(rowptr + r + 1);
    for (int e0 = __ldg(rowptr + r); e0 < e1; e0 += SPMV_WIDE_CHUNK) {
#pragma unroll
      for (int u = 0; u < SPMV_WIDE_CHUNK; ++u) {
        const bool in = e0 + u < e1;
        val[u] = in ? __ldg(sp_vals + e0 + u) : 0ull;
        col[u] = in ? __ldg(sp_cols + e0 + u) : 0;
      }
      chunk<VW>(col, val, x, n, lane0, f, acc);
    }
  }
  u64 out[VW];
#pragma unroll
  for (int l = 0; l < VW; ++l) out[l] = r < out_dim ? reduce128(acc[l], f) : 0ull;
  store_y<VW>(y + r * n + lane0, out);
}

template <int VW>
static void launch(const int* cols, const u64* vals, int ell, long long ld,
                   const int* rowptr, const int* sp_cols, const u64* sp_vals,
                   const u64* x, u64* y, long long out_dim, long long out_rows,
                   int n, const WideField& f, cudaStream_t stream) {
  const int threads = SPMV_WIDE_THREADS;
  const int groups = n / VW;
  const long long total = out_rows * groups;
  if (total <= 0) return;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  spmv_wide_kernel<VW><<<blocks, threads, 0, stream>>>(
      cols, vals, ell, ld, rowptr, sp_cols, sp_vals, x, y, out_dim, out_rows,
      n, groups, f);
}

extern "C" int spmv_wide(const int* cols, const u64* vals, int ell,
                         long long ld, const int* rowptr, const int* sp_cols,
                         const u64* sp_vals, const u64* x, u64* y,
                         long long out_dim, long long out_rows, int n,
                         unsigned long long p, unsigned long long mu,
                         unsigned long long pinv, unsigned long long r2,
                         void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const WideField f{p, mu, pinv, r2};
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  if (n % 4 == 0 && align % 16 == 0)
    launch<4>(cols, vals, ell, ld, rowptr, sp_cols, sp_vals, x, y, out_dim,
              out_rows, n, f, s);
  else if (n % 2 == 0 && align % 16 == 0)
    launch<2>(cols, vals, ell, ld, rowptr, sp_cols, sp_vals, x, y, out_dim,
              out_rows, n, f, s);
  else
    launch<1>(cols, vals, ell, ld, rowptr, sp_cols, sp_vals, x, y, out_dim,
              out_rows, n, f, s);
  return static_cast<int>(cudaGetLastError());
}
