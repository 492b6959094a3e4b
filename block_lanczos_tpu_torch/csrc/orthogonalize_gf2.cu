// orthogonalize_gf2 — the GF(2) recurrence step, in place.
//
// Replaces, in the JAX package, models/lanczos_gf2.py::orthogonalize_gf2
// (the (N, 2n) x (2n, 2n) ops/gf2.py::matmul_gf2 of [v | p] by the
// right-hand side, and the masked selects on d) together with the halt
// selects of models/lanczos_gf2.py::iteration_step (v, p = where(stop, ...)),
// which XLA compiled on the TPU.  For v, p, Av (N, W) words, n = 32 W, the
// right-hand side rhs (2n, 2W) = [[c, winv], [vtAvd, 0]] of
// semi_inverse_gf2.cu and cm the column mask of d:
//
//   upd = [v | p] * rhs                 (over GF(2))
//   v  <- ((Av & cm) | (v & ~cm)) ^ upd[:, :W]
//   p  <- (p & ~cm) ^ upd[:, W:]
//
// v and p are updated IN PLACE.  When the latched state says stop or a
// failed invariant (state = [stop, inv_ok, k_done, frozen]), v and p are
// left as they are.  Thread 0 of block 0 counts the iteration in k_done
// while the state is not yet frozen and freezes it on a halt, so a block of K
// launched iterations counts exactly the unhalted ones (the stopping probe
// included) and every iteration after a halt changes nothing.
//
// Design.  rhs goes to shared memory (2n x 2W words: 8 KB at n = 128) with
// the column mask.  One thread per row, grid-stride: it reads its row of v
// and p a word at a time; each bit k becomes a mask (all ones or zero) and
// the thread XORs mask & rhs[k] (a broadcast load: every thread reads the
// same rhs row) into 2W register accumulators, W for the rows k >= n whose
// right half is zero.  The row is read whole before it is written, so the
// update in place is safe.
//
// What bounds it on an H100: the AND/XOR issue on the CUDA cores.  The byte
// floor is v, p and Av read and v and p written (24 MB at the bench size,
// n = 128: ~0.007 ms); the work is 3 n W masked word XORs per row, 1.5e3 at
// n = 128, ~4.6e8 LOP3s for 300 000 rows.  Binary tensor cores (mma .b1
// AND + popc, [v | p] as the A operand) would take the product off them
// (ROADMAP).
#include <cstdint>

#include "gf2.cuh"

#define OG_THREADS 256

template <int W>
__global__ void __launch_bounds__(OG_THREADS)
    orthogonalize_gf2_kernel(int* __restrict__ v, int* __restrict__ pb,
                             const int* __restrict__ av,
                             const int* __restrict__ rhs,
                             const int* __restrict__ d, long long N,
                             int* __restrict__ state) {
  constexpr int n = 32 * W, RW = 2 * W;
  extern __shared__ __align__(16) u32 sh[];
  u32* R = sh;              // rhs, (2n, 2W)
  u32* cm = sh + 2 * n * RW;
  if (ortho_halt(state)) return;
  for (int e = threadIdx.x; e < 2 * n * RW; e += blockDim.x)
    R[e] = static_cast<u32>(__ldg(rhs + e));
  if (threadIdx.x < W) {
    u32 m = 0;
    for (int b = 0; b < 32; ++b)
      m |= static_cast<u32>(__ldg(d + 32 * threadIdx.x + b) != 0) << b;
    cm[threadIdx.x] = m;
  }
  __syncthreads();
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < N; r += stride) {
    int* vr = v + r * W;
    int* pr = pb + r * W;
    u32 acc[RW];
#pragma unroll
    for (int c = 0; c < RW; ++c) acc[c] = 0;
    // rows k < n of rhs, selected by the bits of v
#pragma unroll 1
    for (int kw = 0; kw < W; ++kw) {
      const u32 x = static_cast<u32>(vr[kw]);
      const u32* base = R + 32 * kw * RW;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const u32 m = bit_mask(x, b);
        u32 row[RW];
        load_row<RW>(base + b * RW, row);
#pragma unroll
        for (int c = 0; c < RW; ++c) acc[c] ^= m & row[c];
      }
    }
    // rows n + k, selected by the bits of p: their right half is zero
#pragma unroll 1
    for (int kw = 0; kw < W; ++kw) {
      const u32 x = static_cast<u32>(pr[kw]);
      const u32* base = R + (n + 32 * kw) * RW;
#pragma unroll
      for (int b = 0; b < 32; ++b) {
        const u32 m = bit_mask(x, b);
        u32 row[W];
        load_row<W>(base + b * RW, row);
#pragma unroll
        for (int c = 0; c < W; ++c) acc[c] ^= m & row[c];
      }
    }
#pragma unroll
    for (int w = 0; w < W; ++w) {
      const u32 vw = static_cast<u32>(vr[w]), pw = static_cast<u32>(pr[w]);
      const u32 aw = static_cast<u32>(__ldg(av + r * W + w));
      vr[w] = static_cast<int>(((aw & cm[w]) | (vw & ~cm[w])) ^ acc[w]);
      pr[w] = static_cast<int>((pw & ~cm[w]) ^ acc[W + w]);
    }
  }
}

template <int W>
static cudaError_t launch(int* v, int* pb, const int* av, const int* rhs,
                          const int* d, long long N, int* state,
                          cudaStream_t s) {
  constexpr int n = 32 * W;
  const size_t smem = (2 * n * 2 * W + W) * sizeof(u32);
  auto kernel = orthogonalize_gf2_kernel<W>;
  static int fit = 0;  // CTAs per SM, once per W
  if (fit == 0) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel,
                                                        OG_THREADS, smem);
    if (err != cudaSuccess) return err;
    if (fit < 1) fit = 1;
  }
  // at least one CTA, so that the state is counted even when N == 0
  long long blocks = (N + OG_THREADS - 1) / OG_THREADS;
  const long long wave = static_cast<long long>(fit) * gf2_sm_count();
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), OG_THREADS, smem, s>>>(
      v, pb, av, rhs, d, N, state);
  return cudaGetLastError();
}

extern "C" int orthogonalize_gf2(int* v, int* pb, const int* av,
                                 const int* rhs, const int* d, long long N,
                                 int W, int* state, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (N < 0) return cudaErrorInvalidValue;
#define OG_CALL(w) \
  return static_cast<int>(launch<w>(v, pb, av, rhs, d, N, state, s))
  GF2_SWITCH_W(W, OG_CALL)
#undef OG_CALL
}
