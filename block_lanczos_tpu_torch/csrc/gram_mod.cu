// gram_mod — exact G = [V1 | V2]^T * W mod p, without materialising the
// concatenation [V1 | V2].
//
// Replaces, in the JAX package, ops/pallas_gram.py::gram_mod_pallas (the
// Pallas TPU kernel) and its XLA twin ops/dense.py::gram_mod, which the
// solver calls as gram_mod([v | Av], Av) (models/lanczos.py:137).  Shapes:
// V1 (N, n1), V2 (N, n2) (V2 may be absent, or be W itself), W (N, b) ->
// G (n1 + n2, b), row-major.
//
// What bounds it on an H100: bytes — one pass over V1, V2 and W (9.6 MB at
// the bench size, n = 4: 0.0029 ms at 3.35 TB/s; 0.023 ms at n = 32, where
// the main path's V2 is W and is read once).  The TPU kernel carried its
// sum in VMEM scratch from one sequential grid step to the next; CTAs on
// Hopper run in no order.  The first port reduced every product with a
// 64-bit `%` and took two launches: 26x the byte bound at n = 4, 165x at
// n = 32.  Design:
//   * One launch per call.  Each CTA reduces its row range to an (a, b)
//     partial below p and adds it into a u64 scratch with integer
//     atomicAdd (exact and order-independent: at most GRAM_MAX_CTAS = 2^11
//     CTAs of at most 2^5 warp partials below p < 2^30 each, < 2^46).  The
//     CTA that draws the last ticket (threadfence reduction) writes G mod p
//     and resets the scratch and the ticket to zero with atomicExch, so the
//     caller allocates the scratch once (zeroed) and never clears it.
//   * No `%`: the CUDA-core paths sum raw u32 x u32 -> u64 products lazily
//     and fold with barrett_reduce once every LAZY_FOLD rows (modp.cuh).
//   * Row path (n1 = b = n <= GRAM_ROW_MAX_N, V2 absent, separate or W; the
//     main path's n = 4): two neighbouring threads share a row, one forming
//     V1^T W and one V2^T W (16 accumulators at n = 4, ~80 registers, so
//     several CTAs per SM), with 16-, 8- or 4-byte vector loads (Av once
//     when V2 is W); one wave of CTAs walks the rows; a warp reduce-scatters
//     its sums with 15 shuffles and the CTA adds its warps in shared memory.
//   * Tensor-core path (b >= GRAM_MMA_MIN_N): the contraction runs over
//     rows, so a CTA stages GRAM_MMA_ROWS-row tiles of V1, V2 and W (Av
//     once when V2 is W) in shared memory through a ring of cp.async
//     stages, transposes each into u8 limb planes (rows along the MMA's k,
//     `__byte_perm`; plane rows padded to 4 mod 8 words, conflict-free
//     fragment loads), and each warp runs 16 m16n8k32 MMAs per 32 rows on
//     its 16 x 8 block of G into 7 s32 shift classes (mma_u8.cuh),
//     recombined into a residue every MMA_FOLD_ROWS = 8192 rows (the s32
//     bound, proved there).
//   * Any other shape: a thread owns a 4 x 4 block of G and a lane of
//     rows, with the same lazy sums.
// What bounds it now (PERF.md): at n = 4, 4x the byte bound, latency: a
// thread has two or three rounds of row loads, then the warp reduction,
// the atomics and the last CTA's round trips, with one wave of CTAs; at
// n = 32, 3.7x: the mma.sync issue (16 per 32 rows and 16 x 8 block of G)
// and the staging, which overlap only in part.
#include <cstdint>

#include "mma_u8.cuh"

#ifndef GRAM_THREADS
#define GRAM_THREADS 256
#endif
#ifndef GRAM_ROWS_PER_THREAD
#define GRAM_ROWS_PER_THREAD 4
#endif
// b from which the tensor cores take over: at n = 8 they took 0.027 ms
// against 0.050 on the CUDA cores, at n = 4 0.018 against 0.010 for the
// row path (utils/kernel_sweeps.py, bench size; PERF.md).
#ifndef GRAM_MMA_MIN_N
#define GRAM_MMA_MIN_N 8
#endif
#define GRAM_ROW_MAX_N 4
#define GRAM_MAX_A 128
#define GRAM_MAX_B 64
#define GRAM_TICKET (GRAM_MAX_A * GRAM_MAX_B)  // scratch slot of the ticket
#define GRAM_MAX_CTAS 2048
// Rows a tensor-core CTA stages per step (a multiple of 32 that divides
// MMA_FOLD_ROWS; the launch halves it while the stages do not fit), and
// the stages in flight (cp.async ring).
#ifndef GRAM_MMA_ROWS
#define GRAM_MMA_ROWS 128
#endif
#ifndef GRAM_MMA_STAGES
#define GRAM_MMA_STAGES 2
#endif
// Rows a row-path thread loads before it multiplies (divides LAZY_FOLD).
#ifndef GRAM_UNROLL
#define GRAM_UNROLL (LAZY_FOLD < 4 ? LAZY_FOLD : 4)
#endif
#if LAZY_FOLD % GRAM_UNROLL != 0 || GRAM_MMA_ROWS % 32 != 0 || \
    MMA_FOLD_ROWS % GRAM_MMA_ROWS != 0
#error "GRAM_UNROLL must divide LAZY_FOLD, GRAM_MMA_ROWS 32 | it | 8192"
#endif

enum { GRAM_NO_V2 = 0, GRAM_V2 = 1, GRAM_V2_IS_W = 2 };

// After every thread of the CTA has added its partial into the scratch:
// take a ticket; the last CTA writes G = scratch mod p and clears the
// scratch and the ticket for the next call.
__device__ __forceinline__ void gram_finish(u64* scratch, int ab, int* gout,
                                            u64 p, u64 mu) {
  __shared__ bool last;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const u64 total = static_cast<u64>(gridDim.x) * gridDim.y;
    last = atomicAdd(scratch + GRAM_TICKET, 1ULL) == total - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int o = threadIdx.x; o < ab; o += blockDim.x)
    gout[o] = static_cast<int>(
        barrett_reduce(atomicExch(scratch + o, 0ULL), p, mu));
  if (threadIdx.x == 0) atomicExch(scratch + GRAM_TICKET, 0ULL);
}

template <int VW>
__device__ __forceinline__ void load_vec(const int* p, u32* o) {
  if constexpr (VW == 4) {
    const int4 v = __ldg(reinterpret_cast<const int4*>(p));
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  } else if constexpr (VW == 2) {
    const int2 v = __ldg(reinterpret_cast<const int2*>(p));
    o[0] = v.x, o[1] = v.y;
  } else {
    o[0] = static_cast<u32>(__ldg(p));
  }
}

// ---------------------------------------------------------------------------
// Row path
// ---------------------------------------------------------------------------

template <int NN, int VW>
__global__ void __launch_bounds__(GRAM_THREADS)
    gram_mod_kernel(const int* __restrict__ v1, const int* __restrict__ v2,
                    const int* __restrict__ w, int mode, long long N, u64 p,
                    u64 mu, u64* scratch, int* gout) {
  // A pair of neighbouring threads shares a row: the even one forms the
  // n x n block V1^T W, the odd one V2^T W (nothing without V2); both read
  // W's row (one sector for the pair), and when V2 is W the odd one takes
  // that row as its V2 row: Av is read once.
  constexpr int B = NN * NN;
  static_assert(B <= 16, "the row path keeps n*n <= 16 outputs a thread");
  __shared__ u32 part[GRAM_THREADS / 32][32];
  const int lane = threadIdx.x & 31, h = lane & 1;
  const int* xsrc = h == 0 ? v1 : v2;
  const bool xload = h == 0 || mode == GRAM_V2;
  const bool xisw = h == 1 && mode == GRAM_V2_IS_W;
  u64 acc[NN][NN];
#pragma unroll
  for (int i = 0; i < NN; ++i)
#pragma unroll
    for (int j = 0; j < NN; ++j) acc[i][j] = 0;
  const long long P = (static_cast<long long>(gridDim.x) * blockDim.x) >> 1;
  int since = 0;
  for (long long r = (static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x) >> 1;
       r < N; r += GRAM_UNROLL * P) {
    u32 x[GRAM_UNROLL][NN], y[GRAM_UNROLL][NN];
#pragma unroll
    for (int u = 0; u < GRAM_UNROLL; ++u) {
      const long long rr = r + u * P;
#pragma unroll
      for (int k = 0; k < NN; ++k) x[u][k] = y[u][k] = 0;
      if (rr < N) {
#pragma unroll
        for (int k = 0; k < NN; k += VW) {
          load_vec<VW>(w + rr * NN + k, &y[u][k]);
          if (xload) load_vec<VW>(xsrc + rr * NN + k, &x[u][k]);
        }
        if (xisw)
#pragma unroll
          for (int k = 0; k < NN; ++k) x[u][k] = y[u][k];
      }
    }
#pragma unroll
    for (int u = 0; u < GRAM_UNROLL; ++u)
#pragma unroll
      for (int i = 0; i < NN; ++i)
#pragma unroll
        for (int j = 0; j < NN; ++j)
          acc[i][j] += static_cast<u64>(x[u][i]) * y[u][j];
    since += GRAM_UNROLL;
    if (since == LAZY_FOLD) {  // at most LAZY_FOLD products since a fold
      since = 0;
#pragma unroll
      for (int i = 0; i < NN; ++i)
#pragma unroll
        for (int j = 0; j < NN; ++j) acc[i][j] = barrett_reduce(acc[i][j], p, mu);
    }
  }
  // reduce-scatter over the 16 lanes of a parity: lane L ends with output
  // L >> 1 of its block, the warp's sum of it
  u32 val[16];
#pragma unroll
  for (int o = 0; o < 16; ++o)
    val[o] = o < B
        ? static_cast<u32>(barrett_reduce(acc[o / NN][o % NN], p, mu)) : 0u;
  const u32 P32 = static_cast<u32>(p);
#pragma unroll
  for (int off = 16; off >= 2; off >>= 1) {
    const bool upper = lane & off;
    const int half = off >> 1;
#pragma unroll
    for (int i = 0; i < half; ++i) {
      const u32 send = upper ? val[i] : val[i + half];
      const u32 keep = upper ? val[i + half] : val[i];
      const u32 s = keep + __shfl_xor_sync(0xffffffffu, send, off);
      val[i] = s >= P32 ? s - P32 : s;  // both < p < 2^30: no u32 wrap
    }
  }
  part[threadIdx.x >> 5][lane] = val[0];
  __syncthreads();
  const int idx = threadIdx.x >> 1;
  if (threadIdx.x < 32 && idx < B && (h == 0 || mode != GRAM_NO_V2)) {
    u64 s = 0;
    for (int k = 0; k < static_cast<int>(blockDim.x >> 5); ++k)
      s += part[k][threadIdx.x];
    atomicAdd(scratch + h * B + idx, s);
  }
  gram_finish(scratch, (mode == GRAM_NO_V2 ? 1 : 2) * B, gout, p, mu);
}

// ---------------------------------------------------------------------------
// General CUDA-core path: 4 x 4 blocks of G per thread
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tile_rows(const int* __restrict__ v1, int n1,
                                          const int* __restrict__ v2, int n2,
                                          const int* __restrict__ w, int b,
                                          int i0, int j0, long long r,
                                          long long r1, long long step,
                                          u64 p, u64 mu, u32 (&out)[16]) {
  const int a = n1 + n2;
  u64 acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0;
  int since = 0;
  for (; r < r1; r += step) {
    u32 x[4], y[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int i = i0 + u, j = j0 + u;
      x[u] = i < n1 ? static_cast<u32>(__ldg(v1 + r * n1 + i))
           : i < a ? static_cast<u32>(__ldg(v2 + r * n2 + (i - n1))) : 0u;
      y[u] = j < b ? static_cast<u32>(__ldg(w + r * b + j)) : 0u;
    }
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] += static_cast<u64>(x[e >> 2]) * y[e & 3];
    if (++since == LAZY_FOLD) {
      since = 0;
#pragma unroll
      for (int e = 0; e < 16; ++e) acc[e] = barrett_reduce(acc[e], p, mu);
    }
  }
#pragma unroll
  for (int e = 0; e < 16; ++e)
    out[e] = static_cast<u32>(barrett_reduce(acc[e], p, mu));
}

__global__ void __launch_bounds__(GRAM_THREADS)
    gram_mod_tiles_kernel(const int* __restrict__ v1, int n1,
                          const int* __restrict__ v2, int n2,
                          const int* __restrict__ w, int b, long long N,
                          long long rows_per, u64 p, u64 mu, u64* scratch,
                          int* gout) {
  __shared__ u32 red[GRAM_THREADS * 16];
  const int a = n1 + n2;
  const int tj = (b + 3) / 4, ot = ((a + 3) / 4) * tj;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per;
  const long long r1 = min(N, r0 + rows_per);
  const int T = blockDim.x;
  u32 out[16];
  if (ot <= T) {
    // lanes of rows x blocks of G; the CTA then sums its lanes
    const int lanes = T / ot, lane = threadIdx.x / ot;
    const int tile = threadIdx.x - lane * ot;
    if (lane < lanes) {
      tile_rows(v1, n1, v2, n2, w, b, (tile / tj) * 4, (tile % tj) * 4,
                r0 + lane, r1, lanes, p, mu, out);
#pragma unroll
      for (int e = 0; e < 16; ++e) red[threadIdx.x * 16 + e] = out[e];
    }
    __syncthreads();
    for (int o = threadIdx.x; o < a * b; o += T) {
      const int i = o / b, j = o - (o / b) * b;
      const int t = (i >> 2) * tj + (j >> 2), e = (i & 3) * 4 + (j & 3);
      u64 s = 0;
      for (int l = 0; l < lanes; ++l) s += red[(l * ot + t) * 16 + e];
      atomicAdd(scratch + o, s);
    }
  } else {
    // more blocks of G than threads: each walks the CTA's rows per block
    for (int tile = threadIdx.x; tile < ot; tile += T) {
      const int i0 = (tile / tj) * 4, j0 = (tile % tj) * 4;
      tile_rows(v1, n1, v2, n2, w, b, i0, j0, r0, r1, 1, p, mu, out);
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        const int i = i0 + (e >> 2), j = j0 + (e & 3);
        if (i < a && j < b) atomicAdd(scratch + i * b + j, static_cast<u64>(out[e]));
      }
    }
  }
  gram_finish(scratch, a * b, gout, p, mu);
}

// ---------------------------------------------------------------------------
// Tensor-core path
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp_async16(u32* smem, const int* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}
__device__ __forceinline__ void cp_async4(u32* smem, const int* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

// Issue the copies of rows rs..rs+rows-1 (zeros from r1 on) of the staged
// columns [V1 | V2 | W] (W left out when it is V2) into buf, as one group.
template <bool VEC>
__device__ __forceinline__ void stage_rows(
    u32* buf, int rs_stride, int rows, const int* v1, int n1, const int* v2,
    int n2, const int* w, int b, int sc, long long rs, long long r1) {
  const int per = VEC ? sc / 4 : sc;  // copies per row
  for (int task = threadIdx.x; task < rows * per; task += blockDim.x) {
    const int rr = task / per;
    const int col = (task - rr * per) * (VEC ? 4 : 1);
    const long long r = rs + rr;
    u32* dst = buf + rr * rs_stride + col;
    if (r < r1) {
      const int* src = col < n1 ? v1 + r * n1 + col
                     : col < n1 + n2 ? v2 + r * n2 + (col - n1)
                     : w + r * b + (col - n1 - n2);
      if (VEC) cp_async16(dst, src); else cp_async4(dst, src);
    } else {
#pragma unroll
      for (int u = 0; u < (VEC ? 4 : 1); ++u) dst[u] = 0;
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <bool VEC>
__global__ void __launch_bounds__(512)
    gram_mod_mma_kernel(const int* __restrict__ v1, int n1,
                        const int* __restrict__ v2, int n2,
                        const int* __restrict__ w, int b, int mode,
                        long long N, long long rows_per, int rows_stage,
                        u64 p, u64 mu, u64* scratch, int* gout) {
  extern __shared__ __align__(16) u32 sm[];
  const int ps = rows_stage / 4 + 4;  // plane row stride in words, = 4 mod 8
  const int a = n1 + n2;
  const int sc = mode == GRAM_V2_IS_W ? a : a + b;  // staged columns
  const int wcol0 = mode == GRAM_V2_IS_W ? n1 : a;  // W's first staged column
  const int rs_stride = (sc + 3) & ~3;
  const int buf_words = rows_stage * rs_stride;   // a stage of raw rows
  u32* plane = sm + GRAM_MMA_STAGES * buf_words;  // [4][sc][ps]

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int nt_count = (b + 7) / 8;
  const int pair = blockIdx.y * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const bool has = pair < ((a + 15) / 16) * nt_count;
  const int i0 = (pair / nt_count) * 16 + g, j = (pair % nt_count) * 8 + g;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per;
  const long long r1 = min(N, r0 + rows_per);
  const long long steps = r0 < r1 ? (r1 - r0 + rows_stage - 1) / rows_stage : 0;

  u32 cw[MMA_CLASSES];
  limb_weights(p, mu, cw);
  int S[MMA_CLASSES][4];
  u64 acc[4] = {0, 0, 0, 0};
#pragma unroll
  for (int s = 0; s < MMA_CLASSES; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e) S[s][e] = 0;

  // a ring of GRAM_MMA_STAGES stages: GRAM_MMA_STAGES - 1 in flight
  // while one is transposed and multiplied
  for (int k = 0; k < GRAM_MMA_STAGES - 1; ++k) {
    if (k < steps)
      stage_rows<VEC>(sm + k * buf_words, rs_stride, rows_stage, v1, n1, v2,
                      n2, w, b, sc, r0 + k * rows_stage, r1);
    else
      asm volatile("cp.async.commit_group;\n" ::);
  }
  for (long long step = 0; step < steps; ++step) {
    const long long ahead = step + GRAM_MMA_STAGES - 1;
    if (ahead < steps)  // into the stage transposed one step ago
      stage_rows<VEC>(sm + (ahead % GRAM_MMA_STAGES) * buf_words, rs_stride,
                      rows_stage, v1, n1, v2, n2, w, b, sc,
                      r0 + ahead * rows_stage, r1);
    else
      asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(GRAM_MMA_STAGES - 1));
    __syncthreads();  // this step's rows landed; the last step's MMAs done
    const u32* buf = sm + (step % GRAM_MMA_STAGES) * buf_words;
    for (int task = threadIdx.x; task < sc * (rows_stage / 4);
         task += blockDim.x) {
      const int c = task % sc, q = task / sc;
      u32 wq[4], limb[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) wq[u] = buf[(4 * q + u) * rs_stride + c];
      to_limbs(wq, limb);
#pragma unroll
      for (int l = 0; l < 4; ++l) plane[(l * sc + c) * ps + q] = limb[l];
    }
    __syncthreads();
    // 32 staged rows (one k of the MMA) at a time
    for (int kc = 0; has && kc < rows_stage / 32; ++kc) {
      u32 A[4][4], B[4][2];
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const u32* pa = plane + (l * sc + i0) * ps + kc * 8 + t;
        const u32* pbb = plane + (l * sc + wcol0 + j) * ps + kc * 8 + t;
        A[l][0] = i0 < a ? pa[0] : 0u;
        A[l][1] = i0 + 8 < a ? pa[8 * ps] : 0u;
        A[l][2] = i0 < a ? pa[4] : 0u;
        A[l][3] = i0 + 8 < a ? pa[8 * ps + 4] : 0u;
        B[l][0] = j < b ? pbb[0] : 0u;
        B[l][1] = j < b ? pbb[4] : 0u;
      }
      mma_limb_classes(S, A, B);
    }
    if (has) {
      if ((step + 1) % (MMA_FOLD_ROWS / rows_stage) == 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          acc[e] = limb_recombine(S, e, acc[e], cw, p, mu);
#pragma unroll
          for (int s = 0; s < MMA_CLASSES; ++s) S[s][e] = 0;
        }
      }
    }
  }
  if (has) {
    const int ib = (pair / nt_count) * 16, jb = (pair % nt_count) * 8;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = ib + g + 8 * (e >> 1), jj = jb + 2 * t + (e & 1);
      if (i < a && jj < b)
        atomicAdd(scratch + i * b + jj, limb_recombine(S, e, acc[e], cw, p, mu));
    }
  }
  gram_finish(scratch, a * b, gout, p, mu);
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

// CTAs resident at once on the card (one wave), once per kernel.
template <auto Kernel>
static long long one_wave(int threads) {
  static int fit = 0;
  if (fit == 0) {
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, Kernel, threads, 0);
    if (fit <= 0) fit = 1;
  }
  return clamp_ll(static_cast<long long>(fit) * sm_count(), 1, GRAM_MAX_CTAS);
}

template <int NN, int VW>
static void launch_row(const int* v1, const int* v2, const int* w, int mode,
                       long long N, u64 p, u64 mu, u64* scratch, int* gout,
                       cudaStream_t s) {
  // about GRAM_ROWS_PER_THREAD rows a thread, in at most one wave
  const long long per = static_cast<long long>(GRAM_THREADS) * GRAM_ROWS_PER_THREAD;
  const long long blocks = clamp_ll(
      (N + per - 1) / per, 1, one_wave<gram_mod_kernel<NN, VW>>(GRAM_THREADS));
  gram_mod_kernel<NN, VW><<<static_cast<unsigned>(blocks), GRAM_THREADS, 0,
                            s>>>(v1, v2, w, mode, N, p, mu, scratch, gout);
}

template <int NN>
static void launch_row_vw(int vw, const int* v1, const int* v2, const int* w,
                          int mode, long long N, u64 p, u64 mu, u64* scratch,
                          int* gout, cudaStream_t s) {
  if constexpr (NN % 4 == 0) {
    if (vw == 4) return launch_row<NN, 4>(v1, v2, w, mode, N, p, mu, scratch, gout, s);
  }
  if constexpr (NN % 2 == 0) {
    if (vw >= 2) return launch_row<NN, 2>(v1, v2, w, mode, N, p, mu, scratch, gout, s);
  }
  launch_row<NN, 1>(v1, v2, w, mode, N, p, mu, scratch, gout, s);
}

template <bool VEC>
static cudaError_t launch_mma(const int* v1, int n1, const int* v2, int n2,
                              const int* w, int b, int mode, long long N,
                              u64 p, u64 mu, u64* scratch, int* gout,
                              cudaStream_t s) {
  const int a = n1 + n2;
  const int sc = mode == GRAM_V2_IS_W ? a : a + b;
  const int rs_stride = (sc + 3) & ~3;
  int rows_stage = GRAM_MMA_ROWS;
  size_t smem;
  for (;; rows_stage /= 2) {  // the largest stage that fits 227 KB
    smem = (GRAM_MMA_STAGES * static_cast<size_t>(rows_stage) * rs_stride +
            4 * static_cast<size_t>(sc) * (rows_stage / 4 + 4)) * 4;
    if (smem <= 227 * 1024 || rows_stage == 32) break;
  }
  const int pairs = ((a + 15) / 16) * ((b + 7) / 8);
  const int warps = static_cast<int>(clamp_ll(pairs, 4, 16));
  const int gy = (pairs + warps - 1) / warps;
  auto kernel = gram_mod_mma_kernel<VEC>;
  // cudaFuncSetAttribute and the occupancy query, once per shape
  static int last_smem = -1, last_warps = -1, last_fit = 1;
  if (static_cast<int>(smem) != last_smem || warps != last_warps) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    int fit = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel,
                                                        warps * 32, smem);
    if (err != cudaSuccess) return err;
    last_smem = static_cast<int>(smem), last_warps = warps;
    last_fit = fit > 0 ? fit : 1;
  }
  const long long cap = clamp_ll(static_cast<long long>(last_fit) * sm_count() / gy,
                                 1, GRAM_MAX_CTAS / gy);
  const long long gx = clamp_ll((N + rows_stage - 1) / rows_stage, 1, cap);
  const long long rows_per =
      ((N + gx - 1) / gx + rows_stage - 1) / rows_stage * rows_stage;
  kernel<<<dim3(static_cast<unsigned>(gx), gy), warps * 32, smem, s>>>(
      v1, n1, v2, n2, w, b, mode, N, rows_per, rows_stage, p, mu, scratch,
      gout);
  return cudaGetLastError();
}

extern "C" int gram_mod(const int* v1, int n1, const int* v2, int n2,
                        const int* w, int b, long long N,
                        unsigned long long p, unsigned long long mu,
                        unsigned long long* scratch, int* gout,
                        void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  const int a = n1 + n2;
  if (n1 < 1 || n2 < 0 || b < 1 || a > GRAM_MAX_A || b > GRAM_MAX_B || N < 0)
    return cudaErrorInvalidValue;
  const int mode = n2 == 0 ? GRAM_NO_V2
                 : (v2 == w && n2 == b) ? GRAM_V2_IS_W : GRAM_V2;
  uintptr_t align = reinterpret_cast<uintptr_t>(v1) |
                    reinterpret_cast<uintptr_t>(w);
  if (mode == GRAM_V2) align |= reinterpret_cast<uintptr_t>(v2);
  if (b >= GRAM_MMA_MIN_N) {
    const bool vec = align % 16 == 0 && n1 % 4 == 0 && n2 % 4 == 0 &&
                     b % 4 == 0;
    return static_cast<int>(
        vec ? launch_mma<true>(v1, n1, v2, n2, w, b, mode, N, p, mu, scratch, gout, s)
            : launch_mma<false>(v1, n1, v2, n2, w, b, mode, N, p, mu, scratch, gout, s));
  }
  if (n1 == b && (n2 == 0 || n2 == b) && b <= GRAM_ROW_MAX_N) {
    const int vw = b % 4 == 0 && align % 16 == 0 ? 4
                 : b % 2 == 0 && align % 8 == 0 ? 2 : 1;
    switch (b) {
      case 1: launch_row_vw<1>(vw, v1, v2, w, mode, N, p, mu, scratch, gout, s); break;
      case 2: launch_row_vw<2>(vw, v1, v2, w, mode, N, p, mu, scratch, gout, s); break;
      case 3: launch_row_vw<3>(vw, v1, v2, w, mode, N, p, mu, scratch, gout, s); break;
      default: launch_row_vw<4>(vw, v1, v2, w, mode, N, p, mu, scratch, gout, s); break;
    }
    return static_cast<int>(cudaGetLastError());
  }
  const long long per = static_cast<long long>(GRAM_THREADS) * GRAM_ROWS_PER_THREAD;
  const long long blocks = clamp_ll((N + per - 1) / per, 1, GRAM_MAX_CTAS);
  const long long rows_per = N > 0 ? (N + blocks - 1) / blocks : 0;
  gram_mod_tiles_kernel<<<static_cast<unsigned>(blocks), GRAM_THREADS, 0, s>>>(
      v1, n1, v2, n2, w, b, N, rows_per, p, mu, scratch, gout);
  return static_cast<int>(cudaGetLastError());
}
