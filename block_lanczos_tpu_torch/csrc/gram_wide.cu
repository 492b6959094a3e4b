// gram_wide — exact G = [v | Av]^T * Av mod p for wide primes (p < 2^62), on
// u64 residues, in one launch, on the integer tensor cores.
//
// Replaces, in the JAX package, ops/wide_ops.py::gram_mod (chunked Montgomery
// pair products with 15-bit limb sums, scanned over row chunks), which the
// wide solver calls as gram_mod([v | Av], Av) (models/lanczos_wide.py:73).
// Shapes: v (N, n), Av (N, n) -> G (2n, n), row-major: G[i, j] =
// sum_r X[r, i] Av[r, j], X = [v | Av] never materialised.  The full G is
// formed, both triangles: the symmetry of v^T A v and (Av)^T Av is one of
// the solver's per-iteration checks, which a mirrored triangle would pass
// whatever the kernel did.
//
// Limbs.  A residue x < p < 2^62 is eight u8 limbs, x = sum_s x_s 2^(8s)
// (x_7 < 2^6), so a product is sum_{s,t} x_s y_t 2^(8(s+t)): 64 limb
// products, summed by `mma.sync.m16n8k32.s32.u8.u8` (mma_u8.cuh) over 32 rows
// at a time, and recombined as sum S * (2^(8(s+t)) mod p) in 128 bits
// (modp64.cuh: mac128, fold128, reduce128).  Two layouts of the limbs:
//   * folded (n <= GW_FOLDED_MAX_N, the main path's n = 4): the limb index
//     is folded into the MMA's M and N.  A's rows are (column i of [v | Av],
//     limb s), B's columns (column j of Av, limb t), so the s32 products
//     C'[(i, s), (j, t)] are 16n x 8n, n^2 m16n8 tiles and no padding (16
//     MMAs per 32 rows at n = 4).  Each entry is one limb pair, <= K 255^2,
//     exact in s32 for K <= 33,025 rows (GW_FOLDED_FOLD_ROWS = 32,768).  An
//     m16n8 tile holds exactly G[2mi, nj] and G[2mi + 1, nj] with all 64 of
//     their limb pairs, spread over the warp's 32 lanes (two a lane): at a
//     flush each lane recombines its two terms, the warp adds the 2n^2 <= 32
//     sums by butterflies and lane L folds entry L into one running 128-bit
//     sum.  A warp holds all n^2 tiles and streams its own 32-row chunks
//     (chunk w, w + W, ... of the grid's W warps) through a private ring of
//     GW_FOLDED_STAGES cp.async copies and its own limb planes: no CTA
//     barrier in the loop, so the CTAs' loads stay in flight (a CTA-wide ring,
//     one stage in flight between two barriers, ran 0.0228 ms at n = 4 in
//     the sweep and 0.037 in the solve);
//   * shift classes (n > GW_FOLDED_MAX_N, n = 32 for example): a warp owns a
//     16 x 8 block of G and adds limb pair (s, t) into class s + t's s32
//     accumulators (15 classes, at most 8 pairs in one), exact for K <= 4,128
//     rows (GW_CLASS_FOLD_ROWS = 4,096): 60 accumulators for 128 entries,
//     where folding would take 64 for 32.  64 MMAs per 32 rows and block;
//     blocks tile G over the CTA's warps (and over gridDim.y past 16 blocks);
//     with fewer than 8 blocks, `ksplit` warps share a block and split its
//     rows.
// Staging.  Raw rows of v and Av go to shared memory by cp.async (16 bytes
// a copy where n is even and the blocks are 16-byte aligned, else 8), and a
// __byte_perm transpose (mma_u8.cuh::to_limbs on each 32-bit half) turns
// them into eight limb planes of 4-row words, padded so that the fragment
// loads are free of bank conflicts ([column][limb] planes for the folded
// layout, whose lanes differ by limb, [limb][column] planes 4 mod 8 words
// long for the classes, whose lanes differ by column).  The classes' CTA
// walks a contiguous range of rows in stages of GW_CLASS_ROWS through a
// CTA-wide ring of GW_STAGES.
// Across CTAs.  At the end each thread reduces its running sums (reduce128),
// the CTA adds the warps that share an entry in shared memory as two 31-bit
// halves and adds them into a u64 scratch with integer atomicAdd: at most
// GW_MAX_CTA_WARPS = 16 warp residues a CTA (GW_FOLDED_WARPS <= 16, ksplit
// <= 8) and GW_MAX_CTAS = 2^10 CTAs a column of the grid, each half below
// 2^31, so each half's sum stays below 2^4 * 2^10 * 2^31 = 2^45, exact.  The CTA that draws the last ticket (threadfence
// reduction) recombines hi * 2^31 + lo in 128 bits, reduces it, writes G and
// clears the scratch and the ticket with atomicExch: the wrapper allocates
// the scratch once per device (zeroed) and never clears it.
// What bounds it on an H100: bytes, v and Av read once (19.2 MB at the bench
// size, n = 4: 0.0057 ms at 3.35 TB/s); the limb products are 64 u8 products
// a residue product, 1.2 G operations at the bench (300,000 rows x 32
// residue products x 64 limb products x 2), 0.0006 ms at the 1,979 T/s of
// the int8 tensor cores.  At n = 32 the bytes (153.6 MB,
// 0.046 ms) and the limb products (0.039 ms) come close.  Measured
// (utils/kernel_sweeps.py, PERF.md): the parent design (a 64 x 64 -> 128-bit
// product a thread and row, CTA partials stored and summed by the last CTA)
// ran 0.0422 / 2.9928 ms at n = 4 / 32, its serial tail 23% / 53% of that.
// This one runs 0.0143 / 0.1661: at n = 4 a warp's chunk of 32 rows costs
// ~1,200-3,000 cycles of issue (copies, transpose, 16 MMAs), waiting on the
// cp.async ring 1-5% of them; the finish (scratch adds, ticket, last CTA)
// takes ~0.002 ms.  A CTA-wide ring (one stage in flight between two
// barriers) and a 32-slot reduce-scatter or butterflies for the flush (5
// shuffle rounds of 128-bit sums, 0.011 ms) were measured slower.  The
// shift classes at n <= 2 take twice as long as the folded limbs (fixed
// cost: 60 accumulators for 2 or 8 entries).
#include <cstdint>

#include "mma_u8.cuh"
#include "modp64.cuh"

#define GW_MAX_N 64
#define GW_MAX_OUT (2 * GW_MAX_N * GW_MAX_N)  // entries of G at most
#define GW_HALVES (2 * GW_MAX_OUT)            // scratch: two halves an entry
#define GW_SCRATCH (GW_HALVES + 1)            // and the ticket
#define GW_MAX_CTAS 1024                      // CTAs along the rows at most
#define GW_MAX_CTA_WARPS 16                   // warp residues a CTA adds
#define GW_LIMBS 8
#define GW_CLASSES (2 * GW_LIMBS - 1)
#define GW_FOLDED_MAX_N 4
// Rows an s32 accumulator sums between two recombinations: a limb pair at
// most 255^2 a row, one pair an entry folded (K <= 33,025) and at most 8 in
// a shift class (K <= 4,128).  ops/gfp_wide.py mirrors both.  Smaller
// values only recombine more often (chip_smoke.py builds 64 / 128, so that
// its cases cross them).
#ifndef GW_FOLDED_FOLD_ROWS
#define GW_FOLDED_FOLD_ROWS 32768
#endif
#ifndef GW_CLASS_FOLD_ROWS
#define GW_CLASS_FOLD_ROWS 4096
#endif
#if GW_FOLDED_FOLD_ROWS % 32 || GW_FOLDED_FOLD_ROWS > 33025 || \
    GW_FOLDED_FOLD_ROWS < 32 || GW_CLASS_FOLD_ROWS > 4128
#error "gram_wide: a fold past the s32 bound"
#endif
// The folded layout's warps a CTA (one 32-row chunk each per stage) and the
// classes' rows a stage (a multiple of 32 that divides GW_CLASS_FOLD_ROWS;
// the launch halves it while the stages do not fit): chosen by
// utils/kernel_sweeps.py (PERF.md).  The stages in the cp.async rings: two
// (deeper rings measured no faster).
#ifndef GW_FOLDED_WARPS
#define GW_FOLDED_WARPS 8
#endif
#ifndef GW_CLASS_ROWS
#define GW_CLASS_ROWS 128
#endif
#define GW_STAGES 2
#define GW_FOLDED_STAGES 2
// n from which the shift classes take over from the folded layout.
#ifndef GW_CLASS_MIN_N
#define GW_CLASS_MIN_N (GW_FOLDED_MAX_N + 1)
#endif
#if GW_CLASS_MIN_N < 1 || GW_CLASS_MIN_N > GW_FOLDED_MAX_N + 1 ||       \
    GW_FOLDED_WARPS < 1 || GW_FOLDED_WARPS > GW_MAX_CTA_WARPS ||        \
    GW_CLASS_ROWS % 32 || GW_CLASS_FOLD_ROWS % GW_CLASS_ROWS
#error "gram_wide: bad tile macros"
#endif
#define GW_SMEM_MAX (227 * 1024)

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Issue the copies of rows rs .. rs + R - 1 (zeros from r1 on) of [v | Av]
// into buf, [row][2n] u64, as one group.
template <bool VEC>
__device__ __forceinline__ void stage_rows(u64* buf, const u64* v,
                                           const u64* av, int n, int R,
                                           long long rs, long long r1) {
  const int sc = 2 * n, per = VEC ? n : sc;  // copies a row
  for (int task = threadIdx.x; task < R * per; task += blockDim.x) {
    const int rr = task / per;
    const int col = (task - rr * per) * (VEC ? 2 : 1);
    const long long r = rs + rr;
    u64* dst = buf + rr * sc + col;
    if (r < r1) {
      const u64* src = col < n ? v + r * n + col : av + r * n + (col - n);
      if (VEC) cp_async16(dst, src); else cp_async8(dst, src);
    } else {
      dst[0] = 0;
      if (VEC) dst[1] = 0;
    }
  }
  cp_commit();
}

// The raw rows of a stage into eight limb planes: word q of plane (s, c)
// holds limb s of column c of rows 4q .. 4q + 3 (one byte each), at
// plane[s * ls + c * lc + q].
__device__ __forceinline__ void to_planes(const u64* buf, u32* plane,
                                          int sc, int R, int ls, int lc) {
  for (int task = threadIdx.x; task < sc * (R / 4); task += blockDim.x) {
    const int c = task % sc, q = task / sc;
    u32 lo[4], hi[4], l0[4], l1[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const u64 x = buf[(4 * q + u) * sc + c];
      lo[u] = static_cast<u32>(x);
      hi[u] = static_cast<u32>(x >> 32);
    }
    to_limbs(lo, l0);
    to_limbs(hi, l1);
#pragma unroll
    for (int l = 0; l < 4; ++l) {
      plane[l * ls + c * lc + q] = l0[l];
      plane[(l + 4) * ls + c * lc + q] = l1[l];
    }
  }
}

// w[k] = 2^(8k) mod p for k < GW_CLASSES, one thread each.
__device__ __forceinline__ void limb_weights64(u64* w, const WideField& f) {
  const int k = threadIdx.x;
  if (k < GW_CLASSES)
    w[k] = reduce128({k < 8 ? 1ull << (8 * k) : 0ull,
                      k < 8 ? 0ull : 1ull << (8 * k - 64)}, f);
}

// acc += s * w (s an s32 sum of limb products, never negative).
__device__ __forceinline__ void mac_sw(U128& acc, int s, u64 w) {
  mac128(acc, static_cast<u64>(static_cast<u32>(s)), w);
}

// T = hi * 2^31 + lo for the two halves' sums (each < 2^45): 128 bits.
__device__ __forceinline__ U128 halves128(u64 lo, u64 hi) {
  U128 t = {hi << 31, hi >> 33};
  add128(t, lo);
  return t;
}

// After the CTA has added its halves into the scratch: take a ticket; the
// last CTA writes G and clears the scratch and the ticket.
__device__ __forceinline__ void gram_wide_finish(u64* scratch, int ab,
                                                 u64* gout,
                                                 const WideField& f) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  auto* sc = reinterpret_cast<unsigned long long*>(scratch);
  if (threadIdx.x == 0) {
    const u64 total = static_cast<u64>(gridDim.x) * gridDim.y;
    last = atomicAdd(sc + GW_HALVES, 1ull) == total - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int o = threadIdx.x; o < ab; o += blockDim.x) {
    const u64 lo = atomicExch(sc + 2 * o, 0ull);
    const u64 hi = atomicExch(sc + 2 * o + 1, 0ull);
    gout[o] = reduce128(halves128(lo, hi), f);
  }
  if (threadIdx.x == 0) atomicExch(sc + GW_HALVES, 0ull);
}

__device__ __forceinline__ void add_halves(u64* scratch, int o, u64 lo,
                                           u64 hi) {
  auto* sc = reinterpret_cast<unsigned long long*>(scratch);
  atomicAdd(sc + 2 * o, lo);
  atomicAdd(sc + 2 * o + 1, hi);
}

constexpr u64 M31 = (1ull << 31) - 1;

// Design measurement only: built with -DGW_TIMELINE (utils/kernel_sweeps.py),
// the folded kernel records, over its CTAs, %globaltimer ns at the first
// and the last CTA's start, the last end of warp 0's row loop and of its
// flush, the last CTA's end of its scratch adds and of the finish
// (atomicMin / atomicMax), and sums warp 0's clock64() cycles in the loop,
// in its cp.async waits and its chunks; gram_wide_stamps copies them to the
// host and resets them.
#ifdef GW_TIMELINE
enum {
  GW_T_FIRST, GW_T_LAST_START, GW_T_LOOP, GW_T_FLUSH, GW_T_HALVES, GW_T_END,
  GW_T_LOOP_CYCLES, GW_T_WAIT_CYCLES, GW_T_CHUNKS, GW_T_SLOTS
};
__device__ unsigned long long gw_stamps[GW_T_SLOTS];
__device__ __forceinline__ unsigned long long gw_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define GW_MIN(slot) atomicMin(gw_stamps + (slot), gw_ns())
#define GW_MAX(slot) atomicMax(gw_stamps + (slot), gw_ns())
#define GW_ADD(slot, v) \
  atomicAdd(gw_stamps + (slot), static_cast<unsigned long long>(v))
extern "C" int gram_wide_stamps(long long* host) {
  cudaError_t err = cudaMemcpyFromSymbol(host, gw_stamps, sizeof(gw_stamps));
  if (err != cudaSuccess) return static_cast<int>(err);
  unsigned long long zero[GW_T_SLOTS] = {~0ull};
  return static_cast<int>(cudaMemcpyToSymbol(gw_stamps, zero, sizeof(zero)));
}
#endif

// ---------------------------------------------------------------------------
// Folded layout (n = NN <= GW_FOLDED_MAX_N)
// ---------------------------------------------------------------------------

// A warp's shared memory in the folded layout, in u64 words: a ring of raw
// 32-row chunks, [row][2n] padded to RS words a row (the transpose's lanes,
// 4 rows apart, then miss each other: RS = 2n + 2 where the copies are 16
// bytes, else 2n + 1), then its limb planes, [column][limb] planes of 8
// words (32 rows) padded to LS = 12, a column's 8 planes padded by 4 words
// (neither the transpose's stores, lanes along the columns, nor the
// fragment loads, lanes along the limbs, meet).  At a flush the same region
// holds E rows of the s32 sums, RED words a row (padded from 64 to 68).
template <int NN, bool VEC>
struct Folded {
  static constexpr int SC = 2 * NN, E = 2 * NN * NN;
  static constexpr int RS = SC + (VEC ? 2 : 1), RAW = 32 * RS;
  static constexpr int LS = 12, LC = GW_LIMBS * LS + 4;
  static constexpr int RED = GW_LIMBS * GW_LIMBS + 4;
  static constexpr int WORK = GW_FOLDED_STAGES * RAW + (SC * LC + 1) / 2;
  static constexpr int WR = WORK > (E * RED + 1) / 2 ? WORK
                                                     : (E * RED + 1) / 2;
};

template <int NN, bool VEC>
__global__ void __launch_bounds__(32 * GW_FOLDED_WARPS, 2)
    gram_wide_folded_kernel(const u64* __restrict__ v,
                            const u64* __restrict__ av, long long N,
                            WideField f, u64* scratch, u64* gout) {
  typedef Folded<NN, VEC> K;
  constexpr int SC = K::SC, E = K::E, RS = K::RS, RAW = K::RAW;
  constexpr int LS = K::LS, LC = K::LC;
  static_assert(E <= 32, "a lane keeps one entry of G");
  extern __shared__ __align__(16) u64 smw[];
  __shared__ u64 wts[GW_CLASSES];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  u64* ring = smw + warp * K::WR;
  u32* plane = reinterpret_cast<u32*>(ring + GW_FOLDED_STAGES * RAW);
  int* red = reinterpret_cast<int*>(ring);  // the flush's s32 rows
  // this warp's chunks of 32 rows: gw, gw + TW, ...
  const long long chunks = (N + 31) / 32;
  const long long TW = static_cast<long long>(gridDim.x) * (blockDim.x >> 5);
  const long long gw = static_cast<long long>(blockIdx.x) * (blockDim.x >> 5)
                     + warp;
  const long long count = gw < chunks ? (chunks - gw + TW - 1) / TW : 0;

  // the copies of chunk i of this warp into its ring, as one group
  auto stage = [&](long long i) {
    if (i < count) {
      const long long r0 = (gw + i * TW) * 32;
      u64* buf = ring + (i % GW_FOLDED_STAGES) * RAW;
      constexpr int per = VEC ? NN : SC;  // copies a row
#pragma unroll
      for (int task = lane; task < 32 * per; task += 32) {
        const int rr = task / per, col = (task - rr * per) * (VEC ? 2 : 1);
        const long long r = r0 + rr;
        u64* dst = buf + rr * RS + col;
        if (r < N) {
          const u64* src = col < NN ? v + r * NN + col
                                    : av + r * NN + (col - NN);
          if (VEC) cp_async16(dst, src); else cp_async8(dst, src);
        } else {
          dst[0] = 0;
          if (VEC) dst[1] = 0;
        }
      }
    }
    cp_commit();
  };

#ifdef GW_TIMELINE
  if (threadIdx.x == 0) GW_MIN(GW_T_FIRST), GW_MAX(GW_T_LAST_START);
  long long wait_cycles = 0;
  const long long loop0 = clock64();
#endif
  for (int k = 0; k < GW_FOLDED_STAGES - 1; ++k) stage(k);
  limb_weights64(wts, f);
  __syncthreads();
  int S[NN][NN][4];
#pragma unroll
  for (int a = 0; a < NN; ++a)
#pragma unroll
    for (int b = 0; b < NN; ++b)
#pragma unroll
      for (int e = 0; e < 4; ++e) S[a][b][e] = 0;
  U128 tot = {0, 0};

  // lane L's running sum of entry L.  The ring may hold chunks in flight:
  // they land first, and a flush inside the loop copies them again after.
  // Each lane stores its two s32 sums of every entry (limbs s = g, t = 2t,
  // 2t + 1) into the entry's row; lane L adds row L's 64 sums by shift
  // class and recombines the 15 class sums with the weights.
  auto flush = [&]() {
    asm volatile("cp.async.wait_all;\n" ::);
    __syncwarp();
#pragma unroll
    for (int a = 0; a < NN; ++a)
#pragma unroll
      for (int b = 0; b < NN; ++b)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int* row = red + ((a * NN + b) * 2 + h) * K::RED;
          *reinterpret_cast<int2*>(row + g * 8 + 2 * t) =
              make_int2(S[a][b][2 * h], S[a][b][2 * h + 1]);
          S[a][b][2 * h] = S[a][b][2 * h + 1] = 0;
        }
    __syncwarp();
    if (lane < E) {
      u64 cls[GW_CLASSES];
#pragma unroll
      for (int k = 0; k < GW_CLASSES; ++k) cls[k] = 0;
      const int4* row = reinterpret_cast<const int4*>(red + lane * K::RED);
#pragma unroll
      for (int q = 0; q < GW_LIMBS * GW_LIMBS / 4; ++q) {
        const int4 x = row[q];  // limbs s = q / 2, t = 4 (q % 2) + 0..3
        const int s = q / 2, t0 = 4 * (q % 2);
        cls[s + t0] += static_cast<u32>(x.x);
        cls[s + t0 + 1] += static_cast<u32>(x.y);
        cls[s + t0 + 2] += static_cast<u32>(x.z);
        cls[s + t0 + 3] += static_cast<u32>(x.w);
      }
#pragma unroll
      for (int k = 0; k < GW_CLASSES; ++k) mac128(tot, cls[k], wts[k]);
      fold128(tot, f);
    }
    __syncwarp();
  };

  int since = 0;  // chunks since the last flush
  for (long long i = 0; i < count; ++i) {
    stage(i + GW_FOLDED_STAGES - 1);
#ifdef GW_TIMELINE
    const long long w0c = clock64();
#endif
    asm volatile("cp.async.wait_group %0;\n" ::"n"(GW_FOLDED_STAGES - 1));
    __syncwarp();  // chunk i landed, for every lane
#ifdef GW_TIMELINE
    wait_cycles += clock64() - w0c;
#endif
    // the transpose: (column c, word q) a task, two or more a lane
    const u64* buf = ring + (i % GW_FOLDED_STAGES) * RAW;
#pragma unroll
    for (int task = lane; task < SC * 8; task += 32) {
      const int c = task % SC, q = task / SC;
      u32 lo[4], hi[4], l0[4], l1[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const u64 x = buf[(4 * q + u) * RS + c];
        lo[u] = static_cast<u32>(x);
        hi[u] = static_cast<u32>(x >> 32);
      }
      to_limbs(lo, l0);
      to_limbs(hi, l1);
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        plane[c * LC + l * LS + q] = l0[l];
        plane[c * LC + (l + 4) * LS + q] = l1[l];
      }
    }
    __syncwarp();
    // fragment word (column c, half h) of limb g: rows 4t.., 16 + 4t..
    u32 F[SC][2];
#pragma unroll
    for (int c = 0; c < SC; ++c)
#pragma unroll
      for (int h = 0; h < 2; ++h) F[c][h] = plane[c * LC + g * LS + 4 * h + t];
    __syncwarp();  // the planes are read before the next chunk's transpose
#pragma unroll
    for (int a = 0; a < NN; ++a)
#pragma unroll
      for (int b = 0; b < NN; ++b) {
        const u32 A[4] = {F[2 * a][0], F[2 * a + 1][0], F[2 * a][1],
                          F[2 * a + 1][1]};
        const u32 B[2] = {F[NN + b][0], F[NN + b][1]};
        mma_u8(S[a][b], A, B);
      }
    if (++since == GW_FOLDED_FOLD_ROWS / 32) {
      since = 0;
      flush();
      for (int k = 1; k < GW_FOLDED_STAGES; ++k) stage(i + k);  // again
    }
  }
#ifdef GW_TIMELINE
  if (threadIdx.x == 0) {  // warp 0 of each CTA: fewer same-address atomics
    GW_MAX(GW_T_LOOP);
    GW_ADD(GW_T_LOOP_CYCLES, clock64() - loop0);
    GW_ADD(GW_T_WAIT_CYCLES, wait_cycles);
    GW_ADD(GW_T_CHUNKS, count);
  }
#endif
  flush();
#ifdef GW_TIMELINE
  if (threadIdx.x == 0) GW_MAX(GW_T_FLUSH);
#endif
  // the CTA's sum of each entry, then the scratch
  __syncthreads();
  u64* sums = smw;  // the warps' regions are free now
  sums[warp * 32 + lane] = lane < E ? reduce128(tot, f) : 0ull;
  __syncthreads();
  if (threadIdx.x < E) {
    u64 lo = 0, hi = 0;
    for (int w = 0; w < static_cast<int>(blockDim.x >> 5); ++w) {
      const u64 r = sums[w * 32 + threadIdx.x];
      lo += r & M31;
      hi += r >> 31;
    }
    // slot e = (a NN + b) 2 + h is G[2a + h, b]
    const int e = threadIdx.x, h = e & 1, ab = e >> 1;
    add_halves(scratch, (2 * (ab / NN) + h) * NN + ab % NN, lo, hi);
#ifdef GW_TIMELINE
    if (e == 0) GW_MAX(GW_T_HALVES);
#endif
  }
  gram_wide_finish(scratch, E, gout, f);
#ifdef GW_TIMELINE
  if (threadIdx.x == 0) GW_MAX(GW_T_END);
#endif
}

// ---------------------------------------------------------------------------
// Shift classes (any n <= GW_MAX_N)
// ---------------------------------------------------------------------------

template <bool VEC>
__global__ void __launch_bounds__(512)
    gram_wide_class_kernel(const u64* __restrict__ v,
                           const u64* __restrict__ av, int n, long long N,
                           long long rows_per, int R, int bw, int ksplit,
                           WideField f, u64* scratch, u64* gout) {
  extern __shared__ __align__(16) u64 smw[];
  __shared__ u64 wts[GW_CLASSES];
  const int sc = 2 * n, ab = 2 * n * n;
  const int ps = R / 4 + 4;
  const int ls = sc * ps, lc = ps;  // [limb][column] planes
  u64* ring = smw;
  u32* plane = reinterpret_cast<u32*>(smw + GW_STAGES * R * sc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wb = warp % bw, kslice = warp / bw;
  const int njb = (n + 7) / 8;
  const int blk = blockIdx.y * bw + wb;
  const bool has = blk < ((sc + 15) / 16) * njb;
  const int i0 = (blk / njb) * 16, j0 = (blk % njb) * 8;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per;
  const long long r1 = min(N, r0 + rows_per);
  const long long steps = r0 < r1 ? (r1 - r0 + R - 1) / R : 0;

  for (int k = 0; k < GW_STAGES - 1; ++k) {
    if (k < steps)
      stage_rows<VEC>(ring + k * R * sc, v, av, n, R, r0 + k * R, r1);
    else
      cp_commit();
  }
  limb_weights64(wts, f);
  __syncthreads();
  int S[GW_CLASSES][4];
#pragma unroll
  for (int c = 0; c < GW_CLASSES; ++c)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[c][e] = 0;
  U128 acc[4] = {{0, 0}, {0, 0}, {0, 0}, {0, 0}};

  auto flush = [&]() {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int c = 0; c < GW_CLASSES; ++c) {
        mac_sw(acc[e], S[c][e], wts[c]);
        S[c][e] = 0;
      }
      fold128(acc[e], f);
    }
  };

  const bool arow0 = i0 + g < sc, arow1 = i0 + g + 8 < sc;
  const bool bcol = j0 + g < n;
  int since = 0;  // stages since the last flush
  for (long long step = 0; step < steps; ++step) {
    const long long ahead = step + GW_STAGES - 1;
    if (ahead < steps)
      stage_rows<VEC>(ring + (ahead % GW_STAGES) * R * sc, v, av, n, R,
                      r0 + ahead * R, r1);
    else
      cp_commit();
    asm volatile("cp.async.wait_group %0;\n" ::"n"(GW_STAGES - 1));
    __syncthreads();
    to_planes(ring + (step % GW_STAGES) * R * sc, plane, sc, R, ls, lc);
    __syncthreads();
    for (int kc = kslice; has && kc < R / 32; kc += ksplit) {
      const int q = kc * 8 + t;
      u32 B[GW_LIMBS][2];
#pragma unroll
      for (int l = 0; l < GW_LIMBS; ++l) {
        const u32* pb = plane + l * ls + (n + j0 + g) * lc + q;
        B[l][0] = bcol ? pb[0] : 0u;
        B[l][1] = bcol ? pb[4] : 0u;
      }
#pragma unroll
      for (int s = 0; s < GW_LIMBS; ++s) {
        const u32* pa = plane + s * ls + (i0 + g) * lc + q;
        const u32 A[4] = {arow0 ? pa[0] : 0u, arow1 ? pa[8 * lc] : 0u,
                          arow0 ? pa[4] : 0u, arow1 ? pa[8 * lc + 4] : 0u};
#pragma unroll
        for (int l = 0; l < GW_LIMBS; ++l) mma_u8(S[s + l], A, B[l]);
      }
    }
    if (++since == GW_CLASS_FOLD_ROWS / R) {
      since = 0;
      flush();
    }
  }
  flush();
  // the CTA adds the ksplit warps of each block, then the scratch
  asm volatile("cp.async.wait_all;\n" ::);
  __syncthreads();
  u64* red = smw;  // [warp][lane][e]: the ring is free now
#pragma unroll
  for (int e = 0; e < 4; ++e)
    red[(warp * 32 + lane) * 4 + e] = has ? reduce128(acc[e], f) : 0ull;
  __syncthreads();
  for (int x = threadIdx.x; x < bw * 128; x += blockDim.x) {
    const int b = x >> 7, ln = (x >> 2) & 31, e = x & 3;
    const int bb = blockIdx.y * bw + b;
    const int i = (bb / njb) * 16 + (ln >> 2) + 8 * (e >> 1);
    const int j = (bb % njb) * 8 + 2 * (ln & 3) + (e & 1);
    if (i >= sc || j >= n) continue;
    u64 lo = 0, hi = 0;
    for (int k = 0; k < ksplit; ++k) {
      const u64 r = red[((k * bw + b) * 32 + ln) * 4 + e];
      lo += r & M31;
      hi += r >> 31;
    }
    add_halves(scratch, i * n + j, lo, hi);
  }
  gram_wide_finish(scratch, ab, gout, f);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

static int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

static long long clamp_ll(long long x, long long lo, long long hi) {
  return x < lo ? lo : x > hi ? hi : x;
}

// Set the kernel's dynamic shared memory and return the CTAs an SM holds,
// once per (kernel, smem, threads).
template <typename K>
static cudaError_t prepare(K kernel, size_t smem, int threads, int* fit) {
  static const void* last_k = nullptr;
  static size_t last_smem = 0;
  static int last_threads = 0, last_fit = 1;
  if (reinterpret_cast<const void*>(kernel) != last_k || smem != last_smem ||
      threads != last_threads) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int f = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&f, kernel, threads,
                                                        smem);
    if (err != cudaSuccess) return err;
    last_k = reinterpret_cast<const void*>(kernel);
    last_smem = smem, last_threads = threads, last_fit = f > 0 ? f : 1;
  }
  *fit = last_fit;
  return cudaSuccess;
}

// gx CTAs along the rows (one wave of gy columns at most), R-row stages.
static void grid_rows(long long N, int R, int fit, int gy, long long* gx,
                      long long* rows_per) {
  const long long cap = clamp_ll(static_cast<long long>(fit) * sm_count() / gy,
                                 1, GW_MAX_CTAS);
  *gx = clamp_ll((N + R - 1) / R, 1, cap);
  *rows_per = ((N + *gx - 1) / *gx + R - 1) / R * R;
}

template <int NN, bool VEC>
static cudaError_t launch_folded(const u64* v, const u64* av, long long N,
                                 const WideField& f, u64* scratch, u64* gout,
                                 cudaStream_t s) {
  const int threads = 32 * GW_FOLDED_WARPS;
  const size_t smem =
      static_cast<size_t>(GW_FOLDED_WARPS) * Folded<NN, VEC>::WR * 8;
  auto kernel = gram_wide_folded_kernel<NN, VEC>;
  int fit = 1;
  cudaError_t err = prepare(kernel, smem, threads, &fit);
  if (err != cudaSuccess) return err;
  const long long chunks = (N + 31) / 32;
  const long long gx = clamp_ll(
      (chunks + GW_FOLDED_WARPS - 1) / GW_FOLDED_WARPS, 1,
      clamp_ll(static_cast<long long>(fit) * sm_count(), 1, GW_MAX_CTAS));
  kernel<<<static_cast<unsigned>(gx), threads, smem, s>>>(v, av, N, f,
                                                          scratch, gout);
  return cudaGetLastError();
}

template <bool VEC>
static cudaError_t launch_class(const u64* v, const u64* av, int n,
                                long long N, const WideField& f, u64* scratch,
                                u64* gout, cudaStream_t s) {
  const int sc = 2 * n;
  int R = GW_CLASS_ROWS;
  size_t smem;
  for (;; R /= 2) {  // the largest stage that fits
    smem = GW_STAGES * static_cast<size_t>(R) * sc * 8 +
           static_cast<size_t>(GW_LIMBS) * sc * (R / 4 + 4) * 4;
    if (smem <= GW_SMEM_MAX || R == 32) break;
  }
  const int blocks = ((sc + 15) / 16) * ((n + 7) / 8);
  const int bw = blocks < 16 ? blocks : 16;
  int ksplit = 8 / bw;
  if (ksplit < 1) ksplit = 1;
  if (ksplit > R / 32) ksplit = R / 32;
  const int threads = 32 * bw * ksplit;
  if (smem < static_cast<size_t>(threads) * 4 * 8)  // the CTA's last sums
    smem = static_cast<size_t>(threads) * 4 * 8;
  const int gy = (blocks + bw - 1) / bw;
  auto kernel = gram_wide_class_kernel<VEC>;
  int fit = 1;
  cudaError_t err = prepare(kernel, smem, threads, &fit);
  if (err != cudaSuccess) return err;
  long long gx, rows_per;
  grid_rows(N, R, fit, gy, &gx, &rows_per);
  kernel<<<dim3(static_cast<unsigned>(gx), gy), threads, smem, s>>>(
      v, av, n, N, rows_per, R, bw, ksplit, f, scratch, gout);
  return cudaGetLastError();
}

template <bool VEC>
static cudaError_t launch_n(const u64* v, const u64* av, int n, long long N,
                            const WideField& f, u64* scratch, u64* gout,
                            cudaStream_t s) {
  if (n < GW_CLASS_MIN_N) {
    switch (n) {
      case 1: return launch_folded<1, false>(v, av, N, f, scratch, gout, s);
      case 2: return launch_folded<2, VEC>(v, av, N, f, scratch, gout, s);
      case 3: return launch_folded<3, false>(v, av, N, f, scratch, gout, s);
      default: return launch_folded<4, VEC>(v, av, N, f, scratch, gout, s);
    }
  }
  return launch_class<VEC>(v, av, n, N, f, scratch, gout, s);
}

extern "C" int gram_wide(const u64* v, const u64* av, int n, long long N,
                         unsigned long long p, unsigned long long mu,
                         unsigned long long pinv, unsigned long long r2,
                         u64* scratch, u64* gout, void* stream) {
  if (n < 1 || n > GW_MAX_N || N < 0) return cudaErrorInvalidValue;
  const WideField f{p, mu, pinv, r2};
  const auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(av);
  const bool vec = n % 2 == 0 && align % 16 == 0;
  return static_cast<int>(
      vec ? launch_n<true>(v, av, n, N, f, scratch, gout, s)
          : launch_n<false>(v, av, n, N, f, scratch, gout, s));
}
