// gram_gf2 — the GF(2) Gram pair [v | Av]^T Av over bit-packed blocks, in
// one launch, on the binary tensor cores.
//
// Replaces, in the JAX package, ops/gf2.py::gram_gf2 (called at
// models/lanczos_gf2.py:216 on the concatenation [v | Av]), which XLA
// compiled on the TPU.  For v, Av (N, W) words, n = 32 W, computes the
// (2n, W) word matrix
//
//   G[a, w] = XOR over rows r of (bit a of [v | Av][r]) & Av[r, w]
//
// i.e. rows 0..n-1 are vtAv and rows n..2n-1 vtAAv.  v and Av are read
// through their own pointers: the concatenation is never formed.
//
// Design.  G is the parity of an integer product, G = (X^T Y) & 1 with
// X = [v | Av] (N x 2n bits) and Y = Av (N x n bits), contracted over the
// rows r.  That product runs on the tensor cores as
// mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc: a 16 x 8 tile
// of s32 counts += popc(A_row & B_col) over 256 rows at a time.
//   * Grid.  A CTA of 16 warps owns a region of G, GG_REGION_A = 256 output
//     rows a by GG_REGION_B = 128 output columns b (grid x: all of G up to
//     n = 128), and a contiguous run of input rows (grid y), walked in
//     K-tiles of GG_K = 256 rows.
//   * Stage.  Warp w stages rows 32 (w % 8) .. + 31 of each K-tile, one row
//     a lane: 4 of the region's 8 words of X (w / 8 picks which) and, for
//     w < 8 where the region's columns b are not among its rows a, its 4
//     words of Y; 16-byte cp.async where W % 4 == 0 and v, Av are 16-byte
//     aligned, else 4-byte.  The ring holds GG_STAGES K-tiles (2: one in
//     flight while the one in use is taken out; 3 and 4 measured no faster,
//     PERF.md); a lane reads back only its own row, so its own
//     cp.async.wait_group orders the ring.
//   * Transpose.  Each word goes through the 32 x 32 bit transpose of
//     transpose32x2 (five shuffle-and-mask stages, two words a shuffle),
//     after which lane l holds the word whose bit c is bit l of row
//     32 (w % 8) + c.  It lands in shared memory as T[s][32 j + l]: slot s
//     holds k = 32 s .. 32 s + 31 of the region's bit-columns (X's a-columns
//     at 0..255, Y's b-columns at 256..383 when they are staged apart, else
//     read where they sit among the a-columns).  Two T buffers, one barrier
//     a K-tile: the loop transposes K-tile k + 1 into one buffer while it
//     multiplies K-tile k out of the other.
//   * Multiply.  Warp w owns 2 x 8 tiles of 16 x 8 counts (a-rows
//     32 (w % 8) .. + 32, b-columns 64 (w / 8) .. + 64 of the region), 64 s32
//     registers a lane.  Fragments (lane = 4 g + t): a0 / a1 = T[2t][a + g] /
//     T[2t][a + g + 8], a2 / a3 = T[2t + 1][...]; b0 / b1 = T[2t][b + g],
//     T[2t + 1][b + g].  A and B take the same slot for the same register
//     position, so every count pairs the same 256 rows whatever order the
//     hardware gives the k within a register.  Slots 2t and 2t + 1 of a
//     column sit side by side (one 8-byte load) and a slot pair is
//     GG_STRIDE = 388 columns, so the fragment loads are free of bank
//     conflicts.  A CTA holds fewer than 2^31 rows: no count overflows.
//   * Finish.  Each count's parity (& 1) is packed into G's words: a lane
//     builds its 8 bits of a word, the four lanes of a group OR theirs
//     together with two shuffles, and one XORs the word into a zeroed
//     int32 scratch with atomicXor; the CTA that draws the last ticket
//     (threadfence reduction) moves the scratch into G and zeroes it and
//     the ticket for the next call (plain L2 loads and stores: by then no
//     other CTA touches it).  XOR is exact in any order.
// ops/gf2.py::gram_gf2_tiles_np mirrors the regions, the staging, the
// transpose, the fragments and the packing step for step.
//
// What bounds it on an H100.  The floor is bytes: v and Av read once (9.6 MB
// at the bench size, n = 128: ~0.003 ms at 3.35 TB/s); the product is
// 2n * n * N bit multiply-adds, 2 * 256 * 128 * 3e5 = 2e10 operations at
// n = 128, ~0.002 ms at the binary rate that gram_gf2_rate measures
// (~10,000 TOP/s; chip_smoke.py bounds the kernel at it).  What the
// kernel meets first is instruction issue: each warp stages, transposes and
// loads fragments for 32 rows x 4 words a K-tile, and builds with those
// parts patched out showed no single part dominating (PERF.md).
// Above n = 128 a region re-reads its rows for each of its column blocks.
#include <cstdint>

#include "gf2.cuh"

#define GG_K 256                // input rows per K-tile: one m16n8k256
#define GG_SLOTS (GG_K / 32)    // 32-row slots per K-tile
#define GG_WARPS 16
#define GG_REGION_A 256         // output rows a of a region
#define GG_REGION_B 128         // output columns b of a region
#define GG_STRIDE (GG_REGION_A + GG_REGION_B + 4)  // columns a slot pair
#ifndef GG_STAGES
#define GG_STAGES 2             // K-tiles of staged rows in the ring
#endif
#define GG_TICKET (2 * GF2_MAXN * GF2_MAXW)  // scratch slot of the ticket
// dynamic shared memory: the ring (X words: a 16-byte chunk per warp and
// lane; Y words: the same for warps 0..7), then T
#define GG_RING_A (GG_STAGES * GG_WARPS * 32 * 4)
#define GG_RING_B (GG_STAGES * GG_SLOTS * 32 * 4)
#define GG_SMEM_WORDS (GG_RING_A + GG_RING_B + 2 * GG_SLOTS * GG_STRIDE)

__device__ __forceinline__ void cp_async4(u32* dst, const int* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async16(u32* dst, const int* src,
                                           bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0));
}

// Stage words w0 .. w0 + 3 of row r of [v | Av] (w0 % 4 == 0 when vec16)
// into dst[0..4); zero past the row range or 2W words.
template <int W>
__device__ __forceinline__ void stage4(const int* __restrict__ v,
                                       const int* __restrict__ av,
                                       long long r, long long r_end, int w0,
                                       bool vec16, u32* dst) {
  const bool in = r < r_end;
  const long long base = in ? r * W : 0;
  if (vec16) {     // W % 4 == 0: the 4 words lie in v or in Av, aligned
    cp_async16(dst, w0 < W ? v + base + w0 : av + base + (w0 - W),
               in && w0 < 2 * W);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int w = w0 + j;
      cp_async4(dst + j, w < W ? v + base + w : av + base + (w - W),
                in && w < 2 * W);
    }
  }
}

template <int W>
__global__ void __launch_bounds__(GG_WARPS * 32, 1)
gram_gf2_kernel(const int* __restrict__ v, const int* __restrict__ av,
                long long N, long long rows_per, int regions_b, int vec16,
                int* __restrict__ scratch, int* __restrict__ gout) {
  constexpr int n = 32 * W;
  extern __shared__ __align__(16) u32 smem[];
  u32* ring_a = smem;                           // [stage][warp][lane][4]
  u32* ring_b = smem + GG_RING_A;               // [stage][slot][lane][4]
  // T[buf][slot / 2][GG_STRIDE][slot % 2]: slots 2t and 2t + 1 of a
  // column side by side, so a lane's fragment pair is one 8-byte load
  u32* T = smem + GG_RING_A + GG_RING_B;
  __shared__ bool last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int slot = warp & 7, half = warp >> 3;
  const int ra = blockIdx.x / regions_b, rb = blockIdx.x % regions_b;
  const int xa0 = ra * (GG_REGION_A / 32);      // the region's first X word
  const int yb0 = rb * (GG_REGION_B / 32);      // ... and first Y word
  // The columns b as X bits n + 128 rb ..: read among the staged a-columns
  // when they lie there, else staged apart at GG_REGION_A.
  const int b_width = n - GG_REGION_B * rb < GG_REGION_B
                          ? n - GG_REGION_B * rb : GG_REGION_B;
  const int b_in_a = n + GG_REGION_B * rb - GG_REGION_A * ra;
  const bool b_apart = b_in_a < 0 || b_in_a + b_width > GG_REGION_A;
  const int b_off = b_apart ? GG_REGION_A : b_in_a;
  const bool stage_b = b_apart && half == 0;    // warp-uniform
  // this warp's tiles: a-rows a_base .. +32, b-columns b_base .. +64 (local)
  const int a_base = slot * 32, b_base = half * 64;
  const bool a_live[2] = {ra * GG_REGION_A + a_base < 2 * n,
                          ra * GG_REGION_A + a_base + 16 < 2 * n};
  bool b_live[8];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    b_live[j] = rb * GG_REGION_B + b_base + 8 * j < n;
  // the X words this warp stages and transposes: 4 half .. 4 half + 3
  const int wa0 = xa0 + 4 * half;
  const bool a_words = wa0 < 2 * W;             // warp-uniform
  int acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const long long r_begin = static_cast<long long>(blockIdx.y) * rows_per;
  const long long r_end = r_begin + rows_per < N ? r_begin + rows_per : N;
  const int row = 32 * slot + lane;             // of each K-tile
  auto stage = [&](long long r0, int slot_st) {
    if (a_words)
      stage4<W>(v, av, r0 + row, r_end, wa0, vec16,
                ring_a + ((slot_st * GG_WARPS + warp) * 32 + lane) * 4);
    if (stage_b)
      stage4<W>(v, av, r0 + row, r_end, W + yb0, vec16,
                ring_b + ((slot_st * GG_SLOTS + slot) * 32 + lane) * 4);
    asm volatile("cp.async.commit_group;\n" ::);
  };
  int st = 0;   // the ring entry of the next K-tile to take
  // Take the staged K-tile at r0 out of the ring, transpose it into T
  // buffer `b`, and stage the K-tile GG_STAGES - 1 further on into the
  // entry taken one K-tile ago.
  auto take = [&](long long r0, int b) {
    asm volatile("cp.async.wait_group %0;\n" ::"n"(GG_STAGES - 2));
    u32* Tb = T + 2 * ((b * GG_SLOTS / 2 + slot / 2) * GG_STRIDE + lane) +
              (slot & 1);
    if (a_words) {
      const uint4 q = *reinterpret_cast<const uint4*>(
          ring_a + ((st * GG_WARPS + warp) * 32 + lane) * 4);
      u32 x0 = q.x, x1 = q.y, x2 = q.z, x3 = q.w;
      transpose32x2(x0, x1, lane);
      transpose32x2(x2, x3, lane);
      u32* dst = Tb + 2 * 32 * 4 * half;
      dst[0] = x0, dst[64] = x1, dst[128] = x2, dst[192] = x3;
    }
    if (stage_b) {
      const uint4 q = *reinterpret_cast<const uint4*>(
          ring_b + ((st * GG_SLOTS + slot) * 32 + lane) * 4);
      u32 y0 = q.x, y1 = q.y, y2 = q.z, y3 = q.w;
      transpose32x2(y0, y1, lane);
      transpose32x2(y2, y3, lane);
      u32* dst = Tb + 2 * GG_REGION_A;
      dst[0] = y0, dst[64] = y1, dst[128] = y2, dst[192] = y3;
    }
    stage(r0 + (GG_STAGES - 1) * GG_K, st == 0 ? GG_STAGES - 1 : st - 1);
    st = st == GG_STAGES - 1 ? 0 : st + 1;
  };
#pragma unroll
  for (int k = 0; k < GG_STAGES - 1; ++k) stage(r_begin + k * GG_K, k);
  take(r_begin, 0);
  __syncthreads();
  // Software-pipelined: each K-tile's products run beside the next one's
  // transposes (into the other T buffer); one barrier a K-tile.
  int buf = 0;
  for (long long r0 = r_begin; r0 < r_end; r0 += GG_K, buf ^= 1) {
    if (r0 + GG_K < r_end) take(r0 + GG_K, buf ^ 1);
    // (slot 2t, slot 2t + 1) of column c
    const uint2* s01 = reinterpret_cast<const uint2*>(T) +
                       (buf * GG_SLOTS / 2 + t) * GG_STRIDE;
    u32 bf[8][2];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const uint2 q = s01[b_off + b_base + 8 * j + g];
      bf[j][0] = q.x;
      bf[j][1] = q.y;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      if (!a_live[i]) continue;
      const int ar = a_base + 16 * i + g;
      const uint2 p = s01[ar], p8 = s01[ar + 8];
      const u32 af[4] = {p.x, p8.x, p.y, p8.y};
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (b_live[j]) mma_b1(acc[i][j], af, bf[j]);
    }
    __syncthreads();
  }
  asm volatile("cp.async.wait_group 0;\n" ::);

  // parities into G's words: b-columns b_base + 8 j + 2 t + e sit in word
  // (b_base + 8 j) / 32 at bit 8 (j % 4) + 2 t + e
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        u32 word = 0;
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int j = 4 * q + jj;
          word |= static_cast<u32>(acc[i][j][2 * h] & 1) << (8 * jj + 2 * t);
          word |= static_cast<u32>(acc[i][j][2 * h + 1] & 1)
                  << (8 * jj + 2 * t + 1);
        }
        word |= __shfl_xor_sync(GF2_FULL_MASK, word, 1);
        word |= __shfl_xor_sync(GF2_FULL_MASK, word, 2);
        const int a = ra * GG_REGION_A + a_base + 16 * i + 8 * h + g;
        const int wb = yb0 + (b_base >> 5) + q;
        if (t == 0 && a_live[i] && wb < W && word)
          atomicXor(reinterpret_cast<u32*>(scratch) + a * W + wb, word);
      }
  // take a ticket; the last CTA writes G and clears the scratch and ticket
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned total = gridDim.x * gridDim.y;
    last = atomicAdd(reinterpret_cast<u32*>(scratch) + GG_TICKET, 1u) ==
           total - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // every other CTA is done with the scratch: plain L2 loads and stores
#pragma unroll 4
  for (int e = tid; e < 2 * n * W; e += blockDim.x) {
    gout[e] = __ldcg(scratch + e);
    scratch[e] = 0;
  }
  if (tid == 0) atomicExch(scratch + GG_TICKET, 0);
}

template <int W>
static cudaError_t launch(const int* v, const int* av, long long N,
                          int* scratch, int* gout, cudaStream_t s) {
  constexpr int n = 32 * W;
  constexpr int smem = GG_SMEM_WORDS * 4;
  static bool sized = false;     // the > 48 KB of dynamic shared memory
  if (!sized) {
    const cudaError_t e = cudaFuncSetAttribute(
        gram_gf2_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return e;
    sized = true;
  }
  const int regions_a = (2 * n + GG_REGION_A - 1) / GG_REGION_A;
  const int regions_b = (n + GG_REGION_B - 1) / GG_REGION_B;
  const int gx = regions_a * regions_b;
  const long long tiles = (N + GG_K - 1) / GG_K;
  long long gy = gf2_sm_count() / gx;   // one CTA per SM
  if (gy < 1) gy = 1;
  if (gy > tiles) gy = tiles > 0 ? tiles : 1;
  const long long rows_per = (tiles + gy - 1) / gy * GG_K;
  gy = N > 0 ? (N + rows_per - 1) / rows_per : 1;
  const int vec16 = W % 4 == 0 &&
      ((reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(av)) &
       15) == 0;
  gram_gf2_kernel<W><<<dim3(gx, static_cast<unsigned>(gy)), GG_WARPS * 32,
                       smem, s>>>(v, av, N, rows_per, regions_b, vec16,
                                  scratch, gout);
  return cudaGetLastError();
}

extern "C" int gram_gf2(const int* v, const int* av, long long N, int W,
                        int* scratch, int* gout, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (N < 0) return cudaErrorInvalidValue;
#define GG_CALL(w) \
  return static_cast<int>(launch<w>(v, av, N, scratch, gout, s))
  GF2_SWITCH_W(W, GG_CALL)
#undef GG_CALL
}

// ---------------------------------------------------------------------------
// The binary tensor cores' rate, for the bounds: every warp issues `iters`
// rounds of 8 independent m16n8k256 .and.popc mma.sync on register operands
// (2 * 16 * 8 * 256 operations each).  The caller times the launch; `sink`
// is written only if the sums take a value they never do, which keeps the
// products live.
// ---------------------------------------------------------------------------

__global__ void gram_gf2_rate_kernel(int iters, int* sink) {
  const u32 seed = (blockIdx.x * blockDim.x + threadIdx.x) * 0x9e3779b9u;
  const u32 a[4] = {seed, seed ^ 0x5bd1e995u, seed + 7u, ~seed};
  const u32 b[2] = {seed * 3u + 1u, seed ^ 0xdeadbeefu};
  int c[8][4];
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[q][e] = 0;
  for (int it = 0; it < iters; ++it)
#pragma unroll
    for (int q = 0; q < 8; ++q) mma_b1(c[q], a, b);
  int s = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q)
#pragma unroll
    for (int e = 0; e < 4; ++e) s ^= c[q][e];
  if (s == 0x7fffffff) sink[0] = s;
}

extern "C" int gram_gf2_rate(int blocks, int threads, int iters, int* sink,
                             void* stream) {
  gram_gf2_rate_kernel<<<blocks, threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(iters, sink);
  return static_cast<int>(cudaGetLastError());
}
