// orthogonalize_wide — one step of the Thome recurrence for wide primes
// (p < 2^62), in place, on u64 residues:
//
//   upd = [v | p] * rhs                      (rhs from semi_inverse_wide.cu)
//   v  <- where(d, Av, v) + upd[:, :n]       (mod p)
//   p  <- where(d, 0,  p) + upd[:, n:]       (mod p)
//
// Replaces, in the JAX package, the (N, 2n) x (2n, 2n) pass of
// models/lanczos_wide.py::orthogonalize_device (wide_ops.matmul_mont /
// matmul_mod on Montgomery uint32 pairs, plus the masked selects on d) and
// the stop select of models/lanczos_wide.py::iteration_step, which XLA
// fused on the TPU.  rhs is [[c, winv], [vtAvd, 0]] in standard residues:
// its bottom-right n x n block is zero and is never read, so a p' column
// sums n products and a v' column 2n.
//
// v and p are updated IN PLACE, with the halt and k_done / frozen
// bookkeeping of the narrow kernel (modp.cuh::ortho_halt): when the latched
// state says stop or a failed invariant, v and p are left as they are (on
// stop the converged block is the pre-update v); thread (0, 0) counts the
// iteration while the state is not frozen and freezes it on a halt.
//
// Design.  Every output starts from the reduced base where(d, Av, v) or
// where(d, 0, p) and sums raw 128-bit products (mac128), folded by Barrett
// every WIDE_FOLD products and reduced once (reduce128; modp64.cuh); rhs is
// staged once a CTA in shared memory (broadcast reads).  Two paths:
//   * n <= OW_ROW_MAX_N (the main path's n = 4): one thread owns a row: it
//     reads the row of v and p into registers, forms all 2n outputs and
//     writes them, so nothing is shared and the update stays in place with
//     no barrier;
//   * above: a CTA of OW_THREADS threads walks tiles of R = OW_THREADS /
//     (2n) rows (2 at n = 64): the tile's [v | p] rows are staged in shared
//     memory, then thread (q, c) forms output column c of row q.  The row's
//     threads have all read it before the barrier that precedes their
//     writes.  Shared memory: rhs 128 KB at n = 64, so it is dynamic.
//
// What bounds it on an H100: bytes, v, p and Av read once and v and p
// written once (40 B per row and column: 48 MB at the bench size, n = 4,
// 0.014 ms at 3.35 TB/s), against 3 n^2 products a row (48 at n = 4, ~8
// integer multiply-adds each: 115 M, 0.0034 ms at the 67 T/s chip_smoke
// takes).
#include "modp64.cuh"

#define OW_THREADS 256
#define OW_MAX_N 64
// n up to which a thread owns a row (utils/kernel_sweeps.py builds with
// -DOW_ROW_MAX_N=0 to time the tile path at every n; PERF.md)
#ifndef OW_ROW_MAX_N
#define OW_ROW_MAX_N 8
#endif

template <int NN>
__global__ void __launch_bounds__(OW_THREADS)
    orthogonalize_wide_row_kernel(u64* __restrict__ v, u64* __restrict__ pb,
                                  const u64* __restrict__ av,
                                  const u64* __restrict__ rhs,
                                  const int* __restrict__ d, long long N,
                                  WideField f, int* state) {
  if (ortho_halt(state)) return;
  constexpr int W = 2 * NN;
  __shared__ u64 srhs[W * W];
  __shared__ int sd[NN];
  for (int e = threadIdx.x; e < W * W; e += blockDim.x) srhs[e] = __ldg(rhs + e);
  for (int e = threadIdx.x; e < NN; e += blockDim.x) sd[e] = __ldg(d + e);
  __syncthreads();
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < N; r += static_cast<long long>(gridDim.x) * blockDim.x) {
    u64 x[W];  // the row of [v | p]
    U128 acc[W];
#pragma unroll
    for (int c = 0; c < NN; ++c) {
      x[c] = v[r * NN + c];
      x[NN + c] = pb[r * NN + c];
    }
#pragma unroll
    for (int c = 0; c < NN; ++c) {
      acc[c] = {sd[c] ? __ldg(av + r * NN + c) : x[c], 0ull};
      acc[NN + c] = {sd[c] ? 0ull : x[NN + c], 0ull};
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (c < NN || k < NN) mac128(acc[c], x[k], srhs[k * W + c]);
      if ((k & (WIDE_FOLD - 1)) == WIDE_FOLD - 1)
#pragma unroll
        for (int c = 0; c < W; ++c) fold128(acc[c], f);
    }
#pragma unroll
    for (int c = 0; c < NN; ++c) {
      v[r * NN + c] = reduce128(acc[c], f);
      pb[r * NN + c] = reduce128(acc[NN + c], f);
    }
  }
}

template <int NN>
static int launch_row(u64* v, u64* pb, const u64* av, const u64* rhs,
                      const int* d, long long N, const WideField& f,
                      int* state, cudaStream_t s) {
  long long blocks = (N + OW_THREADS - 1) / OW_THREADS;
  if (blocks > 8 * 132) blocks = 8 * 132;
  if (blocks < 1) blocks = 1;  // still one CTA: it counts the iteration
  orthogonalize_wide_row_kernel<NN>
      <<<static_cast<unsigned>(blocks), OW_THREADS, 0, s>>>(v, pb, av, rhs, d,
                                                           N, f, state);
  return static_cast<int>(cudaGetLastError());
}

__global__ void __launch_bounds__(OW_THREADS)
    orthogonalize_wide_kernel(u64* __restrict__ v, u64* __restrict__ pb,
                              const u64* __restrict__ av,
                              const u64* __restrict__ rhs,
                              const int* __restrict__ d, long long N, int n,
                              WideField f, int* state) {
  if (ortho_halt(state)) return;
  extern __shared__ __align__(16) u64 ow_smem[];
  const int w = 2 * n, R = OW_THREADS / w;
  u64* srhs = ow_smem;          // (2n, 2n)
  u64* tile = srhs + w * w;     // (R, 2n): the tile's [v | p] rows
  int* sd = reinterpret_cast<int*>(tile + R * w);
  const int tid = threadIdx.x;
  for (int e = tid; e < w * w; e += blockDim.x) srhs[e] = __ldg(rhs + e);
  for (int e = tid; e < n; e += blockDim.x) sd[e] = __ldg(d + e);
  const int q = tid / w, c = tid - q * w;
  const bool active = q < R;
  const bool is_v = c < n;
  const int cc = is_v ? c : c - n;   // the column within v or p
  const int K = is_v ? w : n;        // rhs rows a v' / p' column reads
  for (long long r0 = static_cast<long long>(blockIdx.x) * R; r0 < N;
       r0 += static_cast<long long>(gridDim.x) * R) {
    const long long r = r0 + q;
    const bool row = active && r < N;
    __syncthreads();  // rhs staged; the previous tile's reads are done
    if (row) tile[q * w + c] = is_v ? v[r * n + cc] : pb[r * n + cc];
    __syncthreads();
    if (!row) continue;
    const u64* x = tile + q * w;
    U128 acc = {sd[cc] ? (is_v ? __ldg(av + r * n + cc) : 0ull) : x[c], 0};
    for (int k0 = 0; k0 < K; k0 += WIDE_FOLD) {
      const int k1 = k0 + WIDE_FOLD < K ? k0 + WIDE_FOLD : K;
      for (int k = k0; k < k1; ++k) mac128(acc, x[k], srhs[k * w + c]);
      fold128(acc, f);
    }
    const u64 out = reduce128(acc, f);
    if (is_v)
      v[r * n + cc] = out;
    else
      pb[r * n + cc] = out;
  }
}

extern "C" int orthogonalize_wide(u64* v, u64* pb, const u64* av,
                                  const u64* rhs, const int* d, long long N,
                                  int n, unsigned long long p,
                                  unsigned long long mu,
                                  unsigned long long pinv,
                                  unsigned long long r2, int* state,
                                  void* stream) {
  if (n < 1 || n > OW_MAX_N || N < 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const WideField f{p, mu, pinv, r2};
  if (n <= OW_ROW_MAX_N) {
    switch (n) {
      case 1: return launch_row<1>(v, pb, av, rhs, d, N, f, state, s);
      case 2: return launch_row<2>(v, pb, av, rhs, d, N, f, state, s);
      case 3: return launch_row<3>(v, pb, av, rhs, d, N, f, state, s);
      case 4: return launch_row<4>(v, pb, av, rhs, d, N, f, state, s);
      case 5: return launch_row<5>(v, pb, av, rhs, d, N, f, state, s);
      case 6: return launch_row<6>(v, pb, av, rhs, d, N, f, state, s);
      case 7: return launch_row<7>(v, pb, av, rhs, d, N, f, state, s);
      default: return launch_row<8>(v, pb, av, rhs, d, N, f, state, s);
    }
  }
  const int w = 2 * n, R = OW_THREADS / w;
  const size_t smem = (static_cast<size_t>(w) * w + static_cast<size_t>(R) * w)
                      * sizeof(u64) + n * sizeof(int);
  static bool smem_set = false;  // the attribute, once for the widest n
  if (!smem_set) {
    const size_t most = (4ull * OW_MAX_N * OW_MAX_N + OW_THREADS) * sizeof(u64)
                        + OW_MAX_N * sizeof(int);
    const cudaError_t err = cudaFuncSetAttribute(
        orthogonalize_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(most));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  // one CTA a tile up to 8 waves of 132 SMs, each walking the rest
  long long blocks = (N + R - 1) / R;
  if (blocks > 8 * 132) blocks = 8 * 132;
  if (blocks < 1) blocks = 1;  // still one CTA: it counts the iteration
  orthogonalize_wide_kernel<<<static_cast<unsigned>(blocks), OW_THREADS, smem,
                              s>>>(v, pb, av, rhs, d, N, n, f, state);
  return static_cast<int>(cudaGetLastError());
}
