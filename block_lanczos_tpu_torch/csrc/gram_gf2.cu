// gram_gf2 — the GF(2) Gram pair [v | Av]^T Av over bit-packed blocks, in
// one launch.
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
// Design.  A CTA owns `blockDim.x` output rows a (grid x) and a contiguous
// run of input rows (grid y).  It stages GG_ROWS rows of v and Av at a time
// in shared memory (coalesced loads); then every thread walks the staged
// rows with W register accumulators: the word of [v | Av] holding its bit a
// (the same word for the 32 threads of a warp: a broadcast) becomes a mask,
// and acc ^= mask & Av[r] (broadcast loads again).  At the end each thread
// XORs its accumulators into a zeroed int32 scratch with atomicXor; the CTA
// that draws the last ticket (threadfence reduction) moves the scratch into
// G with atomicExch(…, 0), which leaves the scratch and the ticket zeroed
// for the next call.  XOR is exact in any order, so the result does not
// depend on the schedule.
//
// What bounds it on an H100: the AND/XOR issue on the CUDA cores.  The byte
// floor is v and Av read once and G written (9.6 MB at the bench size,
// n = 128: ~0.003 ms); the work is 2n * W * N mask-and-XORs (LOP3), 3e8 at
// that size, ~0.02 ms at the 64 integer lanes per SM.  Binary tensor cores
// (mma .b1 AND + popc) or a four-Russians table would cut it (ROADMAP).
#include <cstdint>

#include "gf2.cuh"

#define GG_ROWS 64            // input rows staged per round
#define GG_CTAS_PER_SM 4      // CTAs in the grid per SM (all output slices)
#define GG_TICKET (2 * GF2_MAXN * GF2_MAXW)  // scratch slot of the ticket

template <int W>
__global__ void gram_gf2_kernel(const int* __restrict__ v,
                                const int* __restrict__ av, long long N,
                                long long rows_per, int* __restrict__ scratch,
                                int* __restrict__ gout) {
  constexpr int n = 32 * W;
  __shared__ u32 tv[GG_ROWS * W];
  __shared__ u32 tav[GG_ROWS * W];
  __shared__ bool last;
  const int tid = threadIdx.x;
  const int a = blockIdx.x * blockDim.x + tid;  // < 2n: blockDim.x | 2n
  const bool from_v = a < n;
  const int wa = (from_v ? a : a - n) >> 5, ba = a & 31;
  const u32* src = from_v ? tv : tav;
  u32 acc[W];
#pragma unroll
  for (int w = 0; w < W; ++w) acc[w] = 0;
  const long long r_begin = static_cast<long long>(blockIdx.y) * rows_per;
  const long long r_end = r_begin + rows_per < N ? r_begin + rows_per : N;
  for (long long r0 = r_begin; r0 < r_end; r0 += GG_ROWS) {
    const int rows = static_cast<int>(r_end - r0 < GG_ROWS ? r_end - r0
                                                           : GG_ROWS);
    const long long base = r0 * W;
    for (int e = tid; e < rows * W; e += blockDim.x) {
      tv[e] = static_cast<u32>(__ldg(v + base + e));
      tav[e] = static_cast<u32>(__ldg(av + base + e));
    }
    __syncthreads();
#pragma unroll 4
    for (int rr = 0; rr < rows; ++rr) {
      const u32 m = bit_mask(src[rr * W + wa], ba);
#pragma unroll
      for (int w = 0; w < W; ++w) acc[w] ^= m & tav[rr * W + w];
    }
    __syncthreads();
  }
#pragma unroll
  for (int w = 0; w < W; ++w)
    if (acc[w]) atomicXor(reinterpret_cast<u32*>(scratch) + a * W + w, acc[w]);
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
  for (int e = tid; e < 2 * n * W; e += blockDim.x)
    gout[e] = atomicExch(scratch + e, 0);
  if (tid == 0) atomicExch(scratch + GG_TICKET, 0);
}

template <int W>
static cudaError_t launch(const int* v, const int* av, long long N,
                          int* scratch, int* gout, cudaStream_t s) {
  constexpr int two_n = 64 * W;
  const int threads = two_n % 256 == 0 ? 256 : two_n % 128 == 0 ? 128 : 64;
  const int gx = two_n / threads;
  const long long chunks = (N + GG_ROWS - 1) / GG_ROWS;
  long long gy = GG_CTAS_PER_SM * gf2_sm_count() / gx;
  if (gy < 1) gy = 1;
  if (gy > chunks) gy = chunks > 0 ? chunks : 1;
  const long long rows_per = (chunks + gy - 1) / gy * GG_ROWS;
  gy = N > 0 ? (N + rows_per - 1) / rows_per : 1;
  gram_gf2_kernel<W><<<dim3(gx, static_cast<unsigned>(gy)), threads, 0, s>>>(
      v, av, N, rows_per, scratch, gout);
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
