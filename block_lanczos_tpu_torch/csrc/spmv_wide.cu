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
// layout is the narrow field's (ops/spmm.py: column-major (L, out_dim) slab
// of int32 columns); the port's layout has no input bands: mod-p sums are
// associative, so one monolithic pass equals JAX's bands.  Two slabs
// (ops/wide_ops.py::make_wide_op picks one per operator):
//   * narrow coefficients (`narrow` != 0): every value is an int32 signed
//     coefficient c, the operator's entry's representative in (-p/2, p/2)
//     (the field's matrices carry small signed coefficients; the bench's
//     are below 2^20).  8 bytes a slab entry, as in spmv_ell.  x < 2^62 is
//     cut into three 21-bit limbs, and x_k * c (|x_k c| < 2^52) goes into a
//     signed 64-bit sum by one IMAD.WIDE: no sign rule, no 128-bit carry,
//     and each sum is reduced into [0, p) once every SPMV_WIDE_NARROW_FOLD
//     = 512 entries (2^62 + 1023 * 2^52 < 2^63, so up to 1023 would do);
//     y = s_0 + s_1 2^21 + s_2 2^42, reduced once (reduce128);
//   * u64 residues (any operator): 12 bytes a slab entry; the products are
//     summed raw in 128 bits (mac128) and folded by Barrett once a chunk
//     (modp64.cuh proves the budget), each output reduced once.
// ops/gfp_wide.py mirrors both step for step.
//
// Design.  A thread owns one row and a group of VW lanes of x (VW = 2 when
// n is even and x, y are 16-byte aligned, else 1; SPMV_WIDE_VW = 4 lets a
// thread take n % 4 == 0 rows whole): at n = 4 two neighbouring threads
// share a row, each gathering one 16-byte half of its 32-byte sector, so a
// warp's gather is 16 whole sectors.  The slab and then the row's spill are
// walked in chunks of SPMV_WIDE_CHUNK entries, whose gathers are issued
// together; the next chunk's (column, value) pairs are loaded before this
// chunk's gathers, so the slab's HBM latency overlaps the L2's, and they
// load evict-first, so the stream sweeps less of x out of the L2.  Empty
// slab slots (value 0) skip their gather.  A thread is held to 64
// registers (4 CTAs of 256 an SM).
//
// What bounds it on an H100 (PERF.md).  The bytes (8 B of narrow slab a
// nonzero, x read once and y written once, rowptr: ~52 MB for M^T, 0.016 ms
// at 3.35 TB/s) and, above them, the L2: every nonzero gathers one 32-byte
// sector of x at n = 4, the same 144 MB of sectors a launch as spmv_ell's
// 16-byte rows, and x is twice spmv_ell's (9.6 MB for M^T).  The parent
// design (u64 slab, one thread a row, 106 registers) ran 0.0695 / 0.0547 ms
// (M^T / M) and its loads alone (-DSPMV_WIDE_GATHER_ONLY: the products
// replaced by XORs, timing only) 0.0670 / 0.0483: the loads and the
// occupancy they left held it back, not the 64-bit products.  This design
// runs 0.0574 / 0.0521, its own loads alone 0.0527 / 0.0516, spmv_ell
// 0.0461 / 0.0417 (utils/kernel_sweeps.py; VW = 4 at 64 registers spills,
// VW = 1 is 20% slower).
#include <cstdint>

#include "modp64.cuh"

// Threads a block, entries a thread gathers at a time (at most WIDE_FOLD)
// and the widest vector of x a thread takes: chosen by
// utils/kernel_sweeps.py on an H100 80GB HBM3 at 700 W (PERF.md).
#ifndef SPMV_WIDE_THREADS
#define SPMV_WIDE_THREADS 256
#endif
#ifndef SPMV_WIDE_CHUNK
#define SPMV_WIDE_CHUNK 4
#endif
#ifndef SPMV_WIDE_VW
#define SPMV_WIDE_VW 2
#endif
// CTAs an SM must hold (__launch_bounds__): 4 caps a thread at 64
// registers (66 uncapped at VW = 2), so 32 warps an SM
#ifndef SPMV_WIDE_MIN_BLOCKS
#define SPMV_WIDE_MIN_BLOCKS 4
#endif
#if SPMV_WIDE_CHUNK < 1 || SPMV_WIDE_CHUNK > WIDE_FOLD || \
    (SPMV_WIDE_VW != 1 && SPMV_WIDE_VW != 2 && SPMV_WIDE_VW != 4)
#error "SPMV_WIDE_CHUNK must be in [1, WIDE_FOLD], SPMV_WIDE_VW 1, 2 or 4"
#endif
// Entries summed into the narrow slab's signed limb sums between two
// reductions (at most 1023; a multiple of the chunk).
#define SPMV_WIDE_NARROW_FOLD 512
#define SPMV_WIDE_LIMB_BITS 21

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

// s mod p in [0, p) for a signed sum |s| < 2^63.
__device__ __forceinline__ u64 smod(long long s, const WideField& f) {
  const bool neg = s < 0;
  const u64 r = barrett_reduce(static_cast<u64>(neg ? -s : s), f.p, f.mu);
  return neg && r != 0 ? f.p - r : r;
}

// One output's running sum, by slab kind.
template <bool NARROW>
struct Sum;

template <>
struct Sum<false> {  // u64 residues: a 128-bit lazy sum
  typedef u64 Val;
  U128 a;
  __device__ __forceinline__ void zero() { a = {0, 0}; }
  __device__ __forceinline__ void add(u64 v, u64 x) { mac128(a, v, x); }
  __device__ __forceinline__ void fold(const WideField& f) { fold128(a, f); }
  __device__ __forceinline__ u64 finish(const WideField& f) {
    return reduce128(a, f);
  }
  __device__ __forceinline__ void mix(u64 v, u64 x) { a.lo ^= v ^ x; }
};

template <>
struct Sum<true> {  // signed coefficients: three signed 21-bit limb sums
  typedef int Val;
  long long s[3];
  __device__ __forceinline__ void zero() { s[0] = s[1] = s[2] = 0; }
  __device__ __forceinline__ void add(int c, u64 x) {
    constexpr u64 M = (1ull << SPMV_WIDE_LIMB_BITS) - 1;
    const int x0 = static_cast<int>(x & M);
    const int x1 = static_cast<int>((x >> SPMV_WIDE_LIMB_BITS) & M);
    const int x2 = static_cast<int>(x >> (2 * SPMV_WIDE_LIMB_BITS));
    s[0] += static_cast<long long>(x0) * c;  // one IMAD.WIDE each
    s[1] += static_cast<long long>(x1) * c;
    s[2] += static_cast<long long>(x2) * c;
  }
  __device__ __forceinline__ void fold(const WideField& f) {
#pragma unroll
    for (int k = 0; k < 3; ++k) s[k] = static_cast<long long>(smod(s[k], f));
  }
  // r0 + r1 2^21 + r2 2^42 < 2^105, reduced once
  __device__ __forceinline__ u64 finish(const WideField& f) {
    fold(f);
    const u64 r0 = s[0], r1 = s[1], r2 = s[2];
    U128 t = {r1 << SPMV_WIDE_LIMB_BITS, r1 >> (64 - SPMV_WIDE_LIMB_BITS)};
    add128(t, r0);
    const u64 lo2 = r2 << (2 * SPMV_WIDE_LIMB_BITS);
    t.hi += r2 >> (64 - 2 * SPMV_WIDE_LIMB_BITS);
    add128(t, lo2);
    return reduce128(t, f);
  }
  __device__ __forceinline__ void mix(int c, u64 x) {
    s[0] ^= static_cast<long long>(x ^ static_cast<u64>(c));
  }
};

// The entries k0 .. k0 + SPMV_WIDE_CHUNK - 1 (< count) of one walk, at
// element index at(k): their columns and values.  The slab and spill are
// read once, so they load evict-first (ld.global.cs) and sweep less of x
// out of the L2.
template <bool NARROW, typename At>
__device__ __forceinline__ void load_chunk(
    int k0, int count, At at, const int* __restrict__ cols,
    const typename Sum<NARROW>::Val* __restrict__ vals,
    int (&col)[SPMV_WIDE_CHUNK],
    typename Sum<NARROW>::Val (&val)[SPMV_WIDE_CHUNK]) {
#pragma unroll
  for (int u = 0; u < SPMV_WIDE_CHUNK; ++u) {
    const bool in = k0 + u < count;
    const long long s = at(k0 + u);
    val[u] = in ? __ldcs(vals + s) : 0;
    col[u] = in ? __ldcs(cols + s) : 0;
  }
}

// acc[l] += sum over the `count` entries of one walk (the slab row or the
// spill row) of val * x[col, lane0 + l].
template <int VW, bool NARROW, typename At>
__device__ __forceinline__ void walk(
    int count, At at, const int* __restrict__ cols,
    const typename Sum<NARROW>::Val* __restrict__ vals,
    const u64* __restrict__ x, int n, int lane0, const WideField& f,
    Sum<NARROW> (&acc)[VW], int& since) {
  typedef typename Sum<NARROW>::Val V;
  int col[SPMV_WIDE_CHUNK];
  V val[SPMV_WIDE_CHUNK];
  if (count > 0) load_chunk<NARROW>(0, count, at, cols, vals, col, val);
  for (int k0 = 0; k0 < count; k0 += SPMV_WIDE_CHUNK) {
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
    V cur[SPMV_WIDE_CHUNK];
#pragma unroll
    for (int u = 0; u < SPMV_WIDE_CHUNK; ++u) cur[u] = val[u];
    // the next chunk's pairs, in flight during this chunk's gathers
    if (k0 + SPMV_WIDE_CHUNK < count)
      load_chunk<NARROW>(k0 + SPMV_WIDE_CHUNK, count, at, cols, vals, col,
                         val);
#pragma unroll
    for (int u = 0; u < SPMV_WIDE_CHUNK; ++u)
#pragma unroll
      for (int l = 0; l < VW; ++l) {
#ifdef SPMV_WIDE_GATHER_ONLY
        acc[l].mix(cur[u], xv[u][l]);
#else
        acc[l].add(cur[u], xv[u][l]);
#endif
      }
    since += SPMV_WIDE_CHUNK;
    if (since >= (NARROW ? SPMV_WIDE_NARROW_FOLD : SPMV_WIDE_CHUNK)) {
      since = 0;
#pragma unroll
      for (int l = 0; l < VW; ++l) acc[l].fold(f);
    }
  }
}

template <int VW, bool NARROW>
__global__ void __launch_bounds__(SPMV_WIDE_THREADS, SPMV_WIDE_MIN_BLOCKS)
    spmv_wide_kernel(const int* __restrict__ cols,
                     const typename Sum<NARROW>::Val* __restrict__ vals,
                     int ell, long long ld, const int* __restrict__ rowptr,
                     const int* __restrict__ sp_cols,
                     const typename Sum<NARROW>::Val* __restrict__ sp_vals,
                     const u64* __restrict__ x, u64* __restrict__ y,
                     long long out_dim, long long out_rows, int n, int groups,
                     WideField f) {
  const long long t =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= out_rows * groups) return;
  const long long r = t / groups;
  const int lane0 = static_cast<int>(t - r * groups) * VW;
  Sum<NARROW> acc[VW];
#pragma unroll
  for (int l = 0; l < VW; ++l) acc[l].zero();
  u64 out[VW];
  if (r < out_dim) {
    int since = 0;
    walk<VW, NARROW>(ell, [=](int k) { return static_cast<long long>(k) * ld + r; },
                     cols, vals, x, n, lane0, f, acc, since);
    const int e0 = __ldg(rowptr + r);
    walk<VW, NARROW>(__ldg(rowptr + r + 1) - e0,
                     [=](int k) { return static_cast<long long>(e0) + k; },
                     sp_cols, sp_vals, x, n, lane0, f, acc, since);
#pragma unroll
    for (int l = 0; l < VW; ++l) out[l] = acc[l].finish(f);
  } else {
#pragma unroll
    for (int l = 0; l < VW; ++l) out[l] = 0;
  }
  store_y<VW>(y + r * n + lane0, out);
}

template <int VW, bool NARROW>
static void launch(const int* cols, const void* vals, int ell, long long ld,
                   const int* rowptr, const int* sp_cols, const void* sp_vals,
                   const u64* x, u64* y, long long out_dim, long long out_rows,
                   int n, const WideField& f, cudaStream_t stream) {
  typedef typename Sum<NARROW>::Val V;
  const int threads = SPMV_WIDE_THREADS;
  const int groups = n / VW;
  const long long total = out_rows * groups;
  if (total <= 0) return;
  const unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
  spmv_wide_kernel<VW, NARROW><<<blocks, threads, 0, stream>>>(
      cols, static_cast<const V*>(vals), ell, ld, rowptr, sp_cols,
      static_cast<const V*>(sp_vals), x, y, out_dim, out_rows, n, groups, f);
}

template <bool NARROW>
static void launch_vw(int vw, const int* cols, const void* vals, int ell,
                      long long ld, const int* rowptr, const int* sp_cols,
                      const void* sp_vals, const u64* x, u64* y,
                      long long out_dim, long long out_rows, int n,
                      const WideField& f, cudaStream_t s) {
  if constexpr (SPMV_WIDE_VW >= 4) {  // built only where it may be taken
    if (vw == 4)
      return launch<4, NARROW>(cols, vals, ell, ld, rowptr, sp_cols, sp_vals,
                               x, y, out_dim, out_rows, n, f, s);
  }
  if constexpr (SPMV_WIDE_VW >= 2) {
    if (vw == 2)
      return launch<2, NARROW>(cols, vals, ell, ld, rowptr, sp_cols, sp_vals,
                               x, y, out_dim, out_rows, n, f, s);
  }
  launch<1, NARROW>(cols, vals, ell, ld, rowptr, sp_cols, sp_vals, x, y,
                    out_dim, out_rows, n, f, s);
}

extern "C" int spmv_wide(const int* cols, const void* vals, int ell,
                         long long ld, const int* rowptr, const int* sp_cols,
                         const void* sp_vals, int narrow, const u64* x, u64* y,
                         long long out_dim, long long out_rows, int n,
                         unsigned long long p, unsigned long long mu,
                         unsigned long long pinv, unsigned long long r2,
                         void* stream) {
  if (n < 1) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const WideField f{p, mu, pinv, r2};
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y);
  int vw = 1;
  if (align % 16 == 0) vw = n % 4 == 0 ? 4 : n % 2 == 0 ? 2 : 1;
  if (vw > SPMV_WIDE_VW) vw = SPMV_WIDE_VW;
  if (narrow)
    launch_vw<true>(vw, cols, vals, ell, ld, rowptr, sp_cols, sp_vals, x, y,
                    out_dim, out_rows, n, f, s);
  else
    launch_vw<false>(vw, cols, vals, ell, ld, rowptr, sp_cols, sp_vals, x, y,
                     out_dim, out_rows, n, f, s);
  return static_cast<int>(cudaGetLastError());
}
