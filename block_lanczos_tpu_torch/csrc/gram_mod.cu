// gram_mod — exact G = [V1 | V2]^T * W mod p, without materialising the
// concatenation [V1 | V2].
//
// Replaces, in the JAX package, ops/pallas_gram.py::gram_mod_pallas (the
// Pallas TPU kernel) and its XLA twin ops/dense.py::gram_mod, which the
// solver calls as gram_mod([v | Av], Av) (models/lanczos.py:137).  Shapes:
// V1 (N, n1), V2 (N, n2) (n2 may be 0), W (N, b) -> G (n1 + n2, b).
//
// What bounds it on an H100: bytes — one pass over V1, V2 and W (9.6 MB at
// the bench size, n = 4), about 3 us at 3.35 TB/s; the mulmods are few
// (N * a * b).  The TPU kernel carried its sum in VMEM scratch from one
// sequential grid step to the next; on Hopper blocks run in no order, so:
//   pass 1: each CTA walks its own row range and keeps the partial sums of
//           all a*b outputs in u64 registers (a row-lane split when
//           a*b <= blockDim, several outputs per thread otherwise), reduces
//           across its row lanes in shared memory, and writes its (a, b)
//           partial mod p to a (nblocks, a, b) scratch;
//   pass 2: one thread per output sums the nblocks partials in u64 and
//           reduces mod p.
// Both passes are launched by the one C entry point.  Each product is
// reduced % p before it is summed (modp.cuh), so the result is exact and
// independent of the block split; a*b up to 64 x 32 (n = 32) and N not a
// multiple of anything are handled.
#include "modp.cuh"

#define GRAM_THREADS 256
#define GRAM_MAX_PER_THREAD 32  // a*b <= 8192 outputs

__device__ __forceinline__ u32 gram_lhs(const int* __restrict__ v1, int n1,
                                        const int* __restrict__ v2, int n2,
                                        long long r, int i) {
  return i < n1 ? static_cast<u32>(__ldg(v1 + r * n1 + i))
                : static_cast<u32>(__ldg(v2 + r * n2 + (i - n1)));
}

__global__ void gram_partial_kernel(const int* __restrict__ v1, int n1,
                                    const int* __restrict__ v2, int n2,
                                    const int* __restrict__ w, int b,
                                    long long N, long long rows_per_block,
                                    u64 p, int* __restrict__ partial) {
  __shared__ u64 red[GRAM_THREADS];
  const int ab = (n1 + n2) * b;
  const int T = blockDim.x;
  const long long r0 = static_cast<long long>(blockIdx.x) * rows_per_block;
  const long long r1 = min(N, r0 + rows_per_block);
  int* out = partial + static_cast<long long>(blockIdx.x) * ab;
  if (ab <= T) {
    // row lanes: thread = (lane, output); lanes stride over the rows
    const int lanes = T / ab;
    const int lane = threadIdx.x / ab;
    const int o = threadIdx.x - lane * ab;
    u64 acc = 0;
    if (lane < lanes) {
      const int i = o / b, j = o - (o / b) * b;
      for (long long r = r0 + lane; r < r1; r += lanes)
        acc += mulmod(gram_lhs(v1, n1, v2, n2, r, i),
                      static_cast<u32>(__ldg(w + r * b + j)), p);
    }
    red[threadIdx.x] = acc % p;
    __syncthreads();
    if (threadIdx.x < ab) {
      u64 s = 0;
      for (int l = 0; l < lanes; ++l) s += red[l * ab + threadIdx.x];
      out[threadIdx.x] = static_cast<int>(s % p);
    }
  } else {
    // several outputs per thread, every thread walks all rows of the range
    u64 acc[GRAM_MAX_PER_THREAD];
    const int per = (ab + T - 1) / T;
    for (int q = 0; q < per; ++q) acc[q] = 0;
    for (long long r = r0; r < r1; ++r) {
      for (int q = 0; q < per; ++q) {
        const int o = threadIdx.x + q * T;
        if (o < ab) {
          const int i = o / b, j = o - (o / b) * b;
          acc[q] += mulmod(gram_lhs(v1, n1, v2, n2, r, i),
                           static_cast<u32>(__ldg(w + r * b + j)), p);
        }
      }
    }
    for (int q = 0; q < per; ++q) {
      const int o = threadIdx.x + q * T;
      if (o < ab) out[o] = static_cast<int>(acc[q] % p);
    }
  }
}

__global__ void gram_reduce_kernel(const int* __restrict__ partial,
                                   int nblocks, int ab, u64 p,
                                   int* __restrict__ g) {
  const int o = blockIdx.x * blockDim.x + threadIdx.x;
  if (o >= ab) return;
  u64 s = 0;
  for (int k = 0; k < nblocks; ++k)
    s += static_cast<u32>(partial[static_cast<long long>(k) * ab + o]);
  g[o] = static_cast<int>(s % p);
}

extern "C" int gram_mod(const int* v1, int n1, const int* v2, int n2,
                        const int* w, int b, long long N,
                        long long rows_per_block, int nblocks,
                        unsigned long long p, int* partial, int* g,
                        void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ab = (n1 + n2) * b;
  if (ab > GRAM_THREADS * GRAM_MAX_PER_THREAD) return cudaErrorInvalidValue;
  gram_partial_kernel<<<nblocks, GRAM_THREADS, 0, s>>>(
      v1, n1, v2, n2, w, b, N, rows_per_block, p, partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  gram_reduce_kernel<<<(ab + 255) / 256, 256, 0, s>>>(partial, nblocks, ab,
                                                       p, g);
  return static_cast<int>(cudaGetLastError());
}
