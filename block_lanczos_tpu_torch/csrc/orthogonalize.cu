// orthogonalize — one step of the Thome recurrence, in place:
//
//   upd = [v | p] * rhs                      (rhs from semi_inverse.cu)
//   v  <- where(d, Av, v) + upd[:, :n]       (mod p)
//   p  <- where(d, 0,  p) + upd[:, n:]       (mod p)
//
// Replaces, in the JAX package, the (N, 2n) x (2n, 2n) pass of
// models/lanczos.py::orthogonalize_device (dense.matmul_mod plus the masked
// selects on d) and the stop/invariant selects of iteration_step
// (models/lanczos.py:144-148), which XLA fused on the TPU.  rhs is
// [[c, winv], [vtAvd, 0]]: its bottom-right n x n block is zero and is
// never read, so a p' column sums n products and a v' column 2n.
//
// v and p are updated IN PLACE.  When the latched state says stop or a
// failed invariant (state = [stop, inv_ok, k_done, frozen]), v and p are
// left untouched: on stop the converged block is the pre-update v, as in the
// reference.  Thread (0, 0) counts the iteration in k_done while the state
// is not yet frozen and freezes it on a halt, so a block of K launched
// iterations counts exactly the unhalted ones (the stopping probe included)
// and every iteration after a halt recomputes the same values and changes
// nothing.  In every path a row is owned by one thread (row path) or one
// warp (tensor-core path) or one CTA (shared-memory path), which reads all
// of the row's inputs before it writes the row.
//
// What bounds it on an H100: bytes — v, p and Av read once, v and p
// written once (20 B per row and column: 24 MB at the bench size, n = 4,
// 0.0072 ms at 3.35 TB/s; 0.057 ms at n = 32).  The first port reduced
// every product with a 64-bit `%`, 2n threads per row, and ran at 15x the
// byte bound at n = 4 and 68x at n = 32.  Design:
//   * n <= ORTHO_ROW_MAX_N (the main path's n = 4): one thread owns a whole
//     row.  It reads the rows of v, p and Av with 16-, 8- or 4-byte vector
//     loads (from n and the pointers' alignment), keeps them in registers,
//     and sums raw u32 x u32 -> u64 products lazily from the reduced base
//     where(d, Av, v) or where(d, 0, p), folding with barrett_reduce once
//     every LAZY_FOLD products (modp.cuh proves the bound).  rhs and d are
//     read once per CTA into shared memory (broadcast reads).
//   * n >= ORTHO_MMA_MIN_N: (N, 2n) x (2n, 2n) is a real GEMM (921 M
//     products at n = 32, several integer instructions each on the CUDA
//     cores).  It runs on the integer tensor cores as u8-limb products
//     (mma_u8.cuh): a warp owns 16-row tiles, loads their [v | p] rows once
//     as limb fragments (`__byte_perm` packs the bytes of 4 neighbouring
//     columns into one register), and for each 8-column tile of [v' | p']
//     runs 16 m16n8k32 MMAs per 32 columns of k into 7 s32 shift classes,
//     then recombines and Barrett-reduces each output once.  rhs is built
//     once per CTA as transposed byte planes in shared memory (row stride
//     = 4 mod 8 words: conflict-free fragment loads); n that is not a
//     multiple of 8 (or k of 32) is padded with zeros there and in
//     registers, never in global memory.
//   * otherwise (only where a build forces ORTHO_MMA_MIN_N above
//     ORTHO_ROW_MAX_N + 1, as the design sweeps do): a CTA stages
//     ORTHO_SMEM_ROWS rows of v and p in shared memory, synchronises, and
//     each thread forms outputs from there with the same lazy sums.
// What bounds it now (PERF.md): at n = 4, 1.3x the byte bound; at n = 32,
// 2.4x: per 16-row tile a warp issues 192 MMAs and recombines 32 outputs a
// lane (7 multiply-adds and a Barrett reduction each) between its loads
// and stores, so the tensor and integer pipes, not HBM, set the pace.
#include <cstdint>

#include "mma_u8.cuh"

#ifndef ORTHO_THREADS
#define ORTHO_THREADS 256
#endif
#ifndef ORTHO_ROWS_PER_THREAD
#define ORTHO_ROWS_PER_THREAD 1
#endif
// n from which the tensor cores take over: every n the row path does not
// hold.  At n = 8 the row path took 0.032 ms against 0.039 on the tensor
// cores; at n = 16 the tensor cores 0.083 against 0.31 for the
// shared-memory path (utils/kernel_sweeps.py, bench size; PERF.md).
#ifndef ORTHO_MMA_MIN_N
#define ORTHO_MMA_MIN_N 9
#endif
#ifndef ORTHO_MMA_WARPS
#define ORTHO_MMA_WARPS 8
#endif
#define ORTHO_ROW_MAX_N 8
#define ORTHO_SMEM_ROWS 16
#define ORTHO_MAX_N 64

template <int VW>
struct RowIO;
template <>
struct RowIO<4> {
  template <bool NC>
  static __device__ __forceinline__ void load(const int* p, u32* o) {
    const int4 v = NC ? __ldg(reinterpret_cast<const int4*>(p))
                      : *reinterpret_cast<const int4*>(p);
    o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
  }
  static __device__ __forceinline__ void store(int* p, const u64* a) {
    *reinterpret_cast<int4*>(p) = make_int4(
        static_cast<int>(a[0]), static_cast<int>(a[1]),
        static_cast<int>(a[2]), static_cast<int>(a[3]));
  }
};
template <>
struct RowIO<2> {
  template <bool NC>
  static __device__ __forceinline__ void load(const int* p, u32* o) {
    const int2 v = NC ? __ldg(reinterpret_cast<const int2*>(p))
                      : *reinterpret_cast<const int2*>(p);
    o[0] = v.x, o[1] = v.y;
  }
  static __device__ __forceinline__ void store(int* p, const u64* a) {
    *reinterpret_cast<int2*>(p) =
        make_int2(static_cast<int>(a[0]), static_cast<int>(a[1]));
  }
};
template <>
struct RowIO<1> {
  template <bool NC>
  static __device__ __forceinline__ void load(const int* p, u32* o) {
    o[0] = static_cast<u32>(NC ? __ldg(p) : *p);
  }
  static __device__ __forceinline__ void store(int* p, const u64* a) {
    *p = static_cast<int>(a[0]);
  }
};

// ---------------------------------------------------------------------------
// Row path: one thread, one row, everything in registers
// ---------------------------------------------------------------------------

// acc (< p on entry) += sum_k x[k] * col[k * stride], k < K, folded every
// LAZY_FOLD products; returns acc mod p.  K and the fold points are
// compile-time.
template <int K>
__device__ __forceinline__ u64 lazy_row_dot(u64 acc, const u32 (&x)[K],
                                            const u32* col, int stride,
                                            u64 p, u64 mu) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    acc += static_cast<u64>(x[k]) * col[k * stride];
    if (k % LAZY_FOLD == LAZY_FOLD - 1) acc = barrett_reduce(acc, p, mu);
  }
  return acc;
}

template <int NN, int VW>
__global__ void __launch_bounds__(ORTHO_THREADS)
    orthogonalize_kernel(int* v, int* pb, const int* __restrict__ av,
                         const int* __restrict__ rhs,
                         const int* __restrict__ d, long long N, u64 p,
                         u64 mu, int* state) {
  constexpr int W = 2 * NN;
  __shared__ u32 top[NN * W];   // rhs rows 0..n-1: [c | winv]
  __shared__ u32 bot[NN * NN];  // rhs rows n..2n-1, left half: vtAvd
  __shared__ int dm[NN];
  if (ortho_halt(state)) return;
  for (int e = threadIdx.x; e < NN * W; e += blockDim.x)
    top[e] = static_cast<u32>(__ldg(rhs + e));
  for (int e = threadIdx.x; e < NN * NN; e += blockDim.x)
    bot[e] = static_cast<u32>(__ldg(rhs + (NN + e / NN) * W + e % NN));
  if (threadIdx.x < NN) dm[threadIdx.x] = __ldg(d + threadIdx.x);
  __syncthreads();

  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < N; r += static_cast<long long>(gridDim.x) * blockDim.x) {
    u32 x[NN], y[NN], a[NN];
#pragma unroll
    for (int k = 0; k < NN; k += VW) {
      RowIO<VW>::template load<false>(v + r * NN + k, x + k);
      RowIO<VW>::template load<false>(pb + r * NN + k, y + k);
      RowIO<VW>::template load<true>(av + r * NN + k, a + k);
    }
    u64 ov[NN], op[NN];
#pragma unroll
    for (int c = 0; c < NN; ++c) {
      // v'[c] = base + sum_k v[k] c[k, c] + sum_k p[k] vtAvd[k, c]; the
      // second sum continues the first's fold count
      u64 acc = lazy_row_dot<NN>(dm[c] ? a[c] : x[c], x, top + c, W, p, mu);
#pragma unroll
      for (int k = 0; k < NN; ++k) {
        acc += static_cast<u64>(y[k]) * bot[k * NN + c];
        if ((NN + k) % LAZY_FOLD == LAZY_FOLD - 1)
          acc = barrett_reduce(acc, p, mu);
      }
      ov[c] = barrett_reduce(acc, p, mu);
      // p'[c] = base + sum_k v[k] winv[k, c]
      op[c] = barrett_reduce(
          lazy_row_dot<NN>(dm[c] ? 0u : y[c], x, top + NN + c, W, p, mu), p,
          mu);
    }
#pragma unroll
    for (int k = 0; k < NN; k += VW) {
      RowIO<VW>::store(v + r * NN + k, ov + k);
      RowIO<VW>::store(pb + r * NN + k, op + k);
    }
  }
}

// ---------------------------------------------------------------------------
// Shared-memory path: ORTHO_SMEM_ROWS rows per CTA, any n
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(ORTHO_THREADS)
    orthogonalize_smem_kernel(int* v, int* pb, const int* __restrict__ av,
                              const int* __restrict__ rhs,
                              const int* __restrict__ d, long long N, int n,
                              u64 p, u64 mu, int* state) {
  extern __shared__ u32 sm[];
  const int w = 2 * n;
  u32* top = sm;                             // n x 2n
  u32* bot = top + n * w;                    // n x n
  u32* xs = bot + n * n;                     // ORTHO_SMEM_ROWS x n of v
  u32* ys = xs + ORTHO_SMEM_ROWS * n;        // ... of p
  int* dm = reinterpret_cast<int*>(ys + ORTHO_SMEM_ROWS * n);
  if (ortho_halt(state)) return;
  for (int e = threadIdx.x; e < n * w; e += blockDim.x)
    top[e] = static_cast<u32>(__ldg(rhs + e));
  for (int e = threadIdx.x; e < n * n; e += blockDim.x)
    bot[e] = static_cast<u32>(__ldg(rhs + (n + e / n) * w + e % n));
  for (int e = threadIdx.x; e < n; e += blockDim.x) dm[e] = __ldg(d + e);
  const long long r0 = static_cast<long long>(blockIdx.x) * ORTHO_SMEM_ROWS;
  const int rows = static_cast<int>(min(static_cast<long long>(ORTHO_SMEM_ROWS),
                                        N - r0));
  for (int e = threadIdx.x; e < rows * n; e += blockDim.x) {
    xs[e] = static_cast<u32>(v[r0 * n + e]);
    ys[e] = static_cast<u32>(pb[r0 * n + e]);
  }
  __syncthreads();  // every input of the CTA's rows is read: now write
  for (int o = threadIdx.x; o < rows * w; o += blockDim.x) {
    const int lr = o / w, c = o - (o / w) * w;
    const u32* x = xs + lr * n;
    const long long g = (r0 + lr) * n;
    u64 acc;
    int q = 0;
    if (c < n) {
      acc = dm[c] ? static_cast<u32>(__ldg(av + g + c)) : x[c];
      for (int k = 0; k < n; ++k, ++q) {
        acc += static_cast<u64>(x[k]) * top[k * w + c];
        if ((q & (LAZY_FOLD - 1)) == LAZY_FOLD - 1)
          acc = barrett_reduce(acc, p, mu);
      }
      const u32* y = ys + lr * n;
      for (int k = 0; k < n; ++k, ++q) {
        acc += static_cast<u64>(y[k]) * bot[k * n + c];
        if ((q & (LAZY_FOLD - 1)) == LAZY_FOLD - 1)
          acc = barrett_reduce(acc, p, mu);
      }
      v[g + c] = static_cast<int>(barrett_reduce(acc, p, mu));
    } else {
      const int cj = c - n;
      acc = dm[cj] ? 0u : ys[lr * n + cj];
      for (int k = 0; k < n; ++k, ++q) {
        acc += static_cast<u64>(x[k]) * top[k * w + c];
        if ((q & (LAZY_FOLD - 1)) == LAZY_FOLD - 1)
          acc = barrett_reduce(acc, p, mu);
      }
      pb[g + cj] = static_cast<int>(barrett_reduce(acc, p, mu));
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path: u8 limbs, m16n8k32, a warp per 16-row tile
// ---------------------------------------------------------------------------

// The words of [v | p] at row r, columns k..k+3 (zeros past 2n or N).
template <bool VEC>
__device__ __forceinline__ void vp_quad(const int* v, const int* pb,
                                        long long r, int k, int n,
                                        long long N, u32 (&w)[4]) {
  if (VEC) {  // n % 4 == 0 and 16-byte aligned: the quad is in v or in p
    int4 q = make_int4(0, 0, 0, 0);
    if (r < N && k < 2 * n)
      q = *reinterpret_cast<const int4*>(k < n ? v + r * n + k
                                               : pb + r * n + (k - n));
    w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kk = k + u;
      w[u] = r >= N ? 0u
           : kk < n ? static_cast<u32>(v[r * n + kk])
           : kk < 2 * n ? static_cast<u32>(pb[r * n + kk - n]) : 0u;
    }
  }
}

// The bases of the outputs (r, c), (r, c + 1), (r + 8, c), (r + 8, c + 1)
// of [v' | p'] (an accumulator fragment's elements), zero outside.
__device__ __forceinline__ void ortho_base(const int* v, const int* pb,
                                           const int* __restrict__ av,
                                           const int* dm, long long r, int c,
                                           int n, long long N, u32 (&b)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const long long rr = r + 8 * (e >> 1);
    const int cc = c + (e & 1);
    b[e] = rr >= N || cc >= 2 * n ? 0u
         : cc < n ? (dm[cc] ? static_cast<u32>(__ldg(av + rr * n + cc))
                            : static_cast<u32>(v[rr * n + cc]))
         : dm[cc - n] ? 0u : static_cast<u32>(pb[rr * n + (cc - n)]);
  }
}

template <int KC, bool VEC>
__global__ void __launch_bounds__(ORTHO_MMA_WARPS * 32)
    orthogonalize_mma_kernel(int* v, int* pb, const int* __restrict__ av,
                             const int* __restrict__ rhs,
                             const int* __restrict__ d, long long N, int n,
                             u64 p, u64 mu, int* state) {
  extern __shared__ u32 sm[];
  constexpr int PS = KC * 8 + 4;   // plane row stride in words, = 4 mod 8
  const int w = 2 * n;
  const int np = (w + 7) & ~7;     // output columns, padded to the n-tile
  u32* plane = sm;                 // [4 limbs][np columns][PS]
  int* dm = reinterpret_cast<int*>(plane + 4 * np * PS);
  if (ortho_halt(state)) return;
  // B = rhs as byte planes: plane[l][c][k / 4] holds limb l of rhs[k..k+3, c]
  for (int task = threadIdx.x; task < np * KC * 8; task += blockDim.x) {
    const int c = task / (KC * 8), q = task - c * (KC * 8);
    u32 wq[4], limb[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = 4 * q + u;
      const bool in = k < w && c < w && (k < n || c < n);  // skip the zero block
      wq[u] = in ? static_cast<u32>(__ldg(rhs + k * w + c)) : 0u;
    }
    to_limbs(wq, limb);
#pragma unroll
    for (int l = 0; l < 4; ++l) plane[(l * np + c) * PS + q] = limb[l];
  }
  for (int e = threadIdx.x; e < n; e += blockDim.x) dm[e] = __ldg(d + e);
  __syncthreads();

  u32 cw[MMA_CLASSES];
  limb_weights(p, mu, cw);
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long tiles = (N + 15) / 16;
  const int kc_p = (n + 31) / 32;  // k chunks a p' column needs (k < n)
  for (long long tile = static_cast<long long>(blockIdx.x) * ORTHO_MMA_WARPS +
                        (threadIdx.x >> 5);
       tile < tiles; tile += static_cast<long long>(gridDim.x) * ORTHO_MMA_WARPS) {
    const long long r0 = tile * 16;
    // the tile's [v | p] rows as A fragments, all read before any write
    u32 A[KC][4][4];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          u32 wq[4], limb[4];
          vp_quad<VEC>(v, pb, r0 + g + 8 * rr, kc * 32 + 16 * h + 4 * t, n,
                       N, wq);
          to_limbs(wq, limb);
#pragma unroll
          for (int l = 0; l < 4; ++l) A[kc][l][rr + 2 * h] = limb[l];
        }
    // the reduced base of each output, where(d, Av, v) or where(d, 0, p),
    // loaded one column tile ahead of its use (its latency under the MMAs)
    u32 base[4], next[4] = {0, 0, 0, 0};
    ortho_base(v, pb, av, dm, r0 + g, 2 * t, n, N, base);
    for (int col0 = 0; col0 < np; col0 += 8) {
      if (col0 + 8 < np) ortho_base(v, pb, av, dm, r0 + g, col0 + 8 + 2 * t,
                                    n, N, next);
      int S[MMA_CLASSES][4];
#pragma unroll
      for (int s = 0; s < MMA_CLASSES; ++s)
#pragma unroll
        for (int e = 0; e < 4; ++e) S[s][e] = 0;
      const int kc_end = col0 >= n ? kc_p : KC;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        if (kc < kc_end) {
          u32 B[4][2];
#pragma unroll
          for (int l = 0; l < 4; ++l) {
            const u32* pl = plane + (l * np + col0 + g) * PS + kc * 8 + t;
            B[l][0] = pl[0];
            B[l][1] = pl[4];
          }
          mma_limb_classes(S, A[kc], B);
        }
      }
      // outputs (r, c) and (r, c + 1) for the rows g and g + 8
      const int c = col0 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long r = r0 + g + 8 * half;
        if (r >= N || c >= w) continue;
        const int o0 = static_cast<int>(
            limb_recombine(S, 2 * half, base[2 * half], cw, p, mu));
        const int o1 = static_cast<int>(
            limb_recombine(S, 2 * half + 1, base[2 * half + 1], cw, p, mu));
        int* dst = c < n ? v + r * n + c : pb + r * n + (c - n);
        if (VEC) {  // n even: c and c + 1 on one side, 8-byte aligned
          *reinterpret_cast<int2*>(dst) = make_int2(o0, o1);
        } else {
          dst[0] = o0;
          if (c + 1 == n) pb[r * n] = o1;  // w = 2n is even: c + 1 < w
          else dst[1] = o1;
        }
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) base[e] = next[e];
    }
  }
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

template <typename K>
static cudaError_t launch_dyn(K kernel, unsigned blocks, int threads,
                              size_t smem, cudaStream_t s, int* v, int* pb,
                              const int* av, const int* rhs, const int* d,
                              long long N, int n, u64 p, u64 mu, int* state) {
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, s>>>(v, pb, av, rhs, d, N, n, p, mu, state);
  return cudaGetLastError();
}

template <int NN, int VW>
static void launch_row(int* v, int* pb, const int* av, const int* rhs,
                       const int* d, long long N, u64 p, u64 mu, int* state,
                       cudaStream_t s) {
  const long long per = static_cast<long long>(ORTHO_THREADS) *
                        ORTHO_ROWS_PER_THREAD;
  const long long blocks = N > 0 ? (N + per - 1) / per : 1;
  orthogonalize_kernel<NN, VW><<<static_cast<unsigned>(blocks), ORTHO_THREADS,
                                 0, s>>>(v, pb, av, rhs, d, N, p, mu, state);
}

template <int NN>
static void launch_row_vw(int vw, int* v, int* pb, const int* av,
                          const int* rhs, const int* d, long long N, u64 p,
                          u64 mu, int* state, cudaStream_t s) {
  if constexpr (NN % 4 == 0) {
    if (vw == 4) return launch_row<NN, 4>(v, pb, av, rhs, d, N, p, mu, state, s);
  }
  if constexpr (NN % 2 == 0) {
    if (vw >= 2) return launch_row<NN, 2>(v, pb, av, rhs, d, N, p, mu, state, s);
  }
  launch_row<NN, 1>(v, pb, av, rhs, d, N, p, mu, state, s);
}

template <int KC>
static cudaError_t launch_mma(bool vec, int* v, int* pb, const int* av,
                              const int* rhs, const int* d, long long N,
                              int n, u64 p, u64 mu, int* state,
                              cudaStream_t s) {
  const int np = (2 * n + 7) & ~7;
  const size_t smem = (4 * static_cast<size_t>(np) * (KC * 8 + 4) + n) * 4;
  const long long tiles = (N + 15) / 16;
  long long blocks = (tiles + ORTHO_MMA_WARPS - 1) / ORTHO_MMA_WARPS;
  blocks = blocks < 1 ? 1 : blocks;
  const long long cap = 4LL * sm_count();
  blocks = blocks > cap ? cap : blocks;
  if (vec)
    return launch_dyn(orthogonalize_mma_kernel<KC, true>,
                      static_cast<unsigned>(blocks), ORTHO_MMA_WARPS * 32,
                      smem, s, v, pb, av, rhs, d, N, n, p, mu, state);
  return launch_dyn(orthogonalize_mma_kernel<KC, false>,
                    static_cast<unsigned>(blocks), ORTHO_MMA_WARPS * 32, smem,
                    s, v, pb, av, rhs, d, N, n, p, mu, state);
}

extern "C" int orthogonalize(int* v, int* pb, const int* av, const int* rhs,
                             const int* d, long long N, int n,
                             unsigned long long p, unsigned long long mu,
                             int* state, void* stream) {
  if (n < 1 || n > ORTHO_MAX_N || N < 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(pb) |
                          reinterpret_cast<uintptr_t>(av);
  if (n >= ORTHO_MMA_MIN_N) {
    const bool vec = n % 4 == 0 && align % 16 == 0;
    switch ((2 * n + 31) / 32) {
      case 1: return launch_mma<1>(vec, v, pb, av, rhs, d, N, n, p, mu, state, s);
      case 2: return launch_mma<2>(vec, v, pb, av, rhs, d, N, n, p, mu, state, s);
      case 3: return launch_mma<3>(vec, v, pb, av, rhs, d, N, n, p, mu, state, s);
      default: return launch_mma<4>(vec, v, pb, av, rhs, d, N, n, p, mu, state, s);
    }
  }
  if (n <= ORTHO_ROW_MAX_N) {
    const int vw = n % 4 == 0 && align % 16 == 0 ? 4
                 : n % 2 == 0 && align % 8 == 0 ? 2 : 1;
    switch (n) {
      case 1: launch_row_vw<1>(vw, v, pb, av, rhs, d, N, p, mu, state, s); break;
      case 2: launch_row_vw<2>(vw, v, pb, av, rhs, d, N, p, mu, state, s); break;
      case 3: launch_row_vw<3>(vw, v, pb, av, rhs, d, N, p, mu, state, s); break;
      case 4: launch_row_vw<4>(vw, v, pb, av, rhs, d, N, p, mu, state, s); break;
      case 5: launch_row_vw<5>(vw, v, pb, av, rhs, d, N, p, mu, state, s); break;
      case 6: launch_row_vw<6>(vw, v, pb, av, rhs, d, N, p, mu, state, s); break;
      case 7: launch_row_vw<7>(vw, v, pb, av, rhs, d, N, p, mu, state, s); break;
      default: launch_row_vw<8>(vw, v, pb, av, rhs, d, N, p, mu, state, s); break;
    }
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem = (3 * static_cast<size_t>(n) * n +
                       2 * ORTHO_SMEM_ROWS * static_cast<size_t>(n) + n) * 4;
  const long long blocks =
      N > 0 ? (N + ORTHO_SMEM_ROWS - 1) / ORTHO_SMEM_ROWS : 1;
  return static_cast<int>(launch_dyn(
      orthogonalize_smem_kernel, static_cast<unsigned>(blocks), ORTHO_THREADS,
      smem, s, v, pb, av, rhs, d, N, n, p, mu, state));
}
