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
// iteration while the state is not frozen and freezes it on a halt.  A row
// is owned by one thread (row path) or one warp (tensor-core path), which
// reads all of the row's inputs before it writes the row.
//
// Every path ends each output with ONE reduce_mont (modp64.cuh: a Barrett
// fold of the high word, one REDC): the base where(d, Av, v) or where(d, 0,
// p) enters the 128-bit sum in its HIGH word (base * 2^64), and every other
// term carries a factor 2^64 mod p, so REDC's 2^-64 leaves the standard
// residue base + sum x[k] rhs[k, c].  Two paths, by n:
//   * n < OW_MMA_MIN_N (row path, at most OW_ROW_MAX_N; the main path's
//     n = 4): one thread owns a row.  rhs is staged once a CTA in shared
//     memory in Montgomery form (rhs~ = rhs 2^64 mod p) and read again for
//     each row (a volatile broadcast load: hoisted, rhs~ held 164 registers
//     at n = 4); the rows of v, p and Av are read with 16-byte loads where
//     n is even and the blocks are 16-byte aligned, and each output sums
//     raw 64 x 64 -> 128-bit products x rhs~ (mac128) onto base 2^64,
//     folded every WIDE_FOLD products.  Lazy-sum budget with the base in
//     the high word: the sum starts below p 2^64, as after a fold, so
//     p 2^64 + WIDE_FOLD (p - 1)^2 < 2^126 + 2^127 < 2^128 still holds after
//     each fold (modp64.cuh).
//   * n >= OW_MMA_MIN_N: the integer tensor cores on u8 limbs in shift
//     classes (mma_u8.cuh's m16n8k32 and to_limbs).  A residue is eight u8 limbs
//     (x_7 < 2^6, as in gram_wide.cu), so a product is sum_{s,t} x_s r_t
//     2^(8(s+t)).  A warp owns 16-row tiles of [v | p]: it loads each row
//     once and turns it into limb fragments (__byte_perm on each 32-bit
//     half), kept in registers; rhs is staged once a CTA as eight byte
//     planes in shared memory (row stride 4 mod 8 words: conflict-free
//     fragment loads).  For each 8-column tile of [v' | p'] the warp runs
//     the 64 limb pairs (s, t) of each 32-wide k chunk into the 15 shift
//     classes q = s + t (s32 accumulators; the p' columns skip the k chunks
//     of the zero block), then recombines each output as base 2^64 +
//     sum_q S_q w_q with w_q = 2^(8q) 2^64 mod p and reduces it once.
//     Bounds: a class holds at most 8 limb pairs, so S_q <= 8 * 2n * 255^2
//     <= 66,585,600 < 2^31 at n = 64; all classes together hold 64 pairs,
//     sum_q S_q <= 64 * 2n * 255^2 < 2^29, so with w_q's 32-bit halves the
//     sums L = sum S_q lo(w_q) < 2^61 and H = sum S_q hi(w_q) < 2^59 stay
//     in u64, and base 2^64 + H 2^32 + L < 2^127.  ops/gfp_wide.py::
//     ortho_wide_tc_np mirrors it and asserts each bound.
// The threshold comes from utils/kernel_sweeps.py on the bench rows (PERF.md,
// an H100 80GB HBM3 at 700 W): the row path 0.0054 / 0.0097 / 0.0182 /
// 0.0270 ms at n = 1 / 2 / 3 / 4, the classes 0.100 / 0.181 / 0.394 at
// n = 8 / 16 / 32 (the row path 0.105 at n = 8).
//
// What bounds it on an H100: bytes, v, p and Av read once and v and p
// written once (40 B a row and column: 48 MB at the bench size, n = 4,
// 0.0143 ms at 3.35 TB/s; 0.1146 ms at n = 32).  At n = 4 the row path's
// 3 n^2 = 48 products a row (~8 IMADs each) and 8 reductions take ~0.010 ms
// of integer issue (64 IMADs a clock an SM); it runs at 0.0270 ms, one row
// a thread, its loads not overlapped with another row's products.  At n =
// 32 the classes issue 768 m16n8k32 MMAs a 16-row tile: measured by the
// slope from n = 32 to 64, ~14.5 cycles an MMA a sub-partition, ~0.2 ms of
// mma.sync alone (0.060 ms at the int8 tensor cores' 1,979 T/s, which only
// wgmma reaches); with the recombination (30 IMADs and a reduction an
// output) and 192 registers (8 warps an SM) it runs at 0.394 ms.
#include <cstdint>

#include "mma_u8.cuh"
#include "modp64.cuh"

#define OW_THREADS 256
#define OW_MAX_N 64
#define OW_ROW_MAX_N 8
#define OW_LIMBS 8
#define OW_CLASSES (2 * OW_LIMBS - 1)
// n from which the tensor cores take over (utils/kernel_sweeps.py builds
// -DOW_MMA_MIN_N=1 and =9 to time both paths at every n they share;
// PERF.md)
#ifndef OW_MMA_MIN_N
#define OW_MMA_MIN_N 5
#endif
// warps a tensor-core CTA, each walking its own 16-row tiles
#ifndef OW_MMA_WARPS
#define OW_MMA_WARPS 8
#endif
#if OW_MMA_MIN_N < 1 || OW_MMA_MIN_N > OW_ROW_MAX_N + 1 || \
    OW_MMA_WARPS < 1 || OW_MMA_WARPS > 16
#error "orthogonalize_wide: bad path macros"
#endif

// ---------------------------------------------------------------------------
// Row path: one thread, one row, rhs~ in shared memory
// ---------------------------------------------------------------------------

// K words of a row: 16-byte loads (VEC: K even, 16-byte aligned) or 8-byte.
template <int K, bool VEC>
__device__ __forceinline__ void load_row(const u64* src, u64 (&x)[K]) {
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < K; k += 2) {
      const ulonglong2 q = *reinterpret_cast<const ulonglong2*>(src + k);
      x[k] = q.x, x[k + 1] = q.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) x[k] = src[k];
  }
}

template <int K, bool VEC>
__device__ __forceinline__ void store_row(u64* dst, const u64 (&x)[K]) {
  if constexpr (VEC) {
#pragma unroll
    for (int k = 0; k < K; k += 2)
      *reinterpret_cast<ulonglong2*>(dst + k) = make_ulonglong2(x[k], x[k + 1]);
  } else {
#pragma unroll
    for (int k = 0; k < K; ++k) dst[k] = x[k];
  }
}

template <int NN, bool VEC>
__global__ void __launch_bounds__(OW_THREADS)
    orthogonalize_wide_row_kernel(u64* v, u64* pb,
                                  const u64* __restrict__ av,
                                  const u64* __restrict__ rhs,
                                  const int* __restrict__ d, long long N,
                                  WideField f, int* state) {
  if (ortho_halt(state)) return;
  constexpr int W = 2 * NN;
  __shared__ u64 srhs[W * W];  // rhs~; the zero block is never read
  __shared__ int sd[NN];
  // read a row's 3 n^2 words of rhs~ from shared memory for each row (a
  // broadcast load each): hoisted out of the row loop, they held 164
  // registers at n = 4, one CTA an SM
  const volatile u64* vr = srhs;
  for (int e = threadIdx.x; e < W * W; e += blockDim.x)
    srhs[e] = mont_mul(__ldg(rhs + e), f.r2, f);
  for (int e = threadIdx.x; e < NN; e += blockDim.x) sd[e] = __ldg(d + e);
  __syncthreads();
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       r < N; r += static_cast<long long>(gridDim.x) * blockDim.x) {
    u64 x[W], a[NN], y[NN];  // the row of [v | p], of Av
    load_row<NN, VEC>(v + r * NN, y);
#pragma unroll
    for (int c = 0; c < NN; ++c) x[c] = y[c];
    load_row<NN, VEC>(pb + r * NN, y);
#pragma unroll
    for (int c = 0; c < NN; ++c) x[NN + c] = y[c];
    load_row<NN, VEC>(av + r * NN, a);
    U128 acc[W];  // base * 2^64 + sum x[k] rhs~[k, c]
#pragma unroll
    for (int c = 0; c < NN; ++c) {
      acc[c] = {0ull, sd[c] ? a[c] : x[c]};
      acc[NN + c] = {0ull, sd[c] ? 0ull : x[NN + c]};
    }
#pragma unroll
    for (int k = 0; k < W; ++k) {
#pragma unroll
      for (int c = 0; c < W; ++c)
        if (c < NN || k < NN) mac128(acc[c], x[k], vr[k * W + c]);
      if ((k & (WIDE_FOLD - 1)) == WIDE_FOLD - 1 && k + 1 < W)
#pragma unroll
        for (int c = 0; c < W; ++c) fold128(acc[c], f);
    }
#pragma unroll
    for (int c = 0; c < NN; ++c) {
      a[c] = reduce_mont(acc[c], f);
      y[c] = reduce_mont(acc[NN + c], f);
    }
    store_row<NN, VEC>(v + r * NN, a);
    store_row<NN, VEC>(pb + r * NN, y);
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path: u8 limbs, 15 shift classes, a warp per 16-row tile
// ---------------------------------------------------------------------------

// The words of [v | p] at row r, columns k..k+3 (zeros past 2n or N).
template <bool VEC>
__device__ __forceinline__ void vp_quad64(const u64* v, const u64* pb,
                                          long long r, int k, int n,
                                          long long N, u64 (&w)[4]) {
  if (VEC) {  // n % 4 == 0 and 16-byte aligned: the quad is in v or in p
    ulonglong2 q0 = make_ulonglong2(0, 0), q1 = q0;
    if (r < N && k < 2 * n) {
      const u64* src = k < n ? v + r * n + k : pb + r * n + (k - n);
      q0 = *reinterpret_cast<const ulonglong2*>(src);
      q1 = *reinterpret_cast<const ulonglong2*>(src + 2);
    }
    w[0] = q0.x, w[1] = q0.y, w[2] = q1.x, w[3] = q1.y;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int kk = k + u;
      w[u] = r >= N ? 0ull
           : kk < n ? v[r * n + kk]
           : kk < 2 * n ? pb[r * n + kk - n] : 0ull;
    }
  }
}

// Limbs 0..3 (low words) and 4..7 (high words) of four residues, each limb
// word holding that limb of the four (to_limbs on each 32-bit half).
__device__ __forceinline__ void to_limbs64(const u64 (&w)[4],
                                           u32 (&limb)[OW_LIMBS]) {
  u32 lo[4], hi[4], l0[4], l1[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    lo[u] = static_cast<u32>(w[u]);
    hi[u] = static_cast<u32>(w[u] >> 32);
  }
  to_limbs(lo, l0);
  to_limbs(hi, l1);
#pragma unroll
  for (int l = 0; l < 4; ++l) limb[l] = l0[l], limb[l + 4] = l1[l];
}

// The bases of the outputs (r, c), (r, c + 1), (r + 8, c), (r + 8, c + 1)
// of [v' | p'] (an accumulator fragment's elements), zero outside.
__device__ __forceinline__ void ortho_base64(const u64* v, const u64* pb,
                                             const u64* __restrict__ av,
                                             const int* dm, long long r,
                                             int c, int n, long long N,
                                             u64 (&b)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const long long rr = r + 8 * (e >> 1);
    const int cc = c + (e & 1);
    b[e] = rr >= N || cc >= 2 * n ? 0ull
         : cc < n ? (dm[cc] ? __ldg(av + rr * n + cc) : v[rr * n + cc])
         : dm[cc - n] ? 0ull : pb[rr * n + (cc - n)];
  }
}

// The outputs (r, c), (r, c + 1), (r + 8, c), (r + 8, c + 1) of [v' | p']
// (an accumulator fragment's elements) into v and p; VEC (n even, 16-byte
// aligned): c and c + 1 lie on one side, one 16-byte store a row.
template <bool VEC>
__device__ __forceinline__ void store_outputs(u64* v, u64* pb, long long r,
                                              int c, int n, long long N,
                                              const u64 (&out)[4]) {
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const long long rr = r + 8 * half;
    if (rr >= N || c >= 2 * n) continue;
    const u64 o0 = out[2 * half], o1 = out[2 * half + 1];
    u64* dst = c < n ? v + rr * n + c : pb + rr * n + (c - n);
    if (VEC) {
      *reinterpret_cast<ulonglong2*>(dst) = make_ulonglong2(o0, o1);
    } else {
      dst[0] = o0;
      if (c + 1 == n) pb[rr * n] = o1;  // w = 2n is even: c + 1 < w
      else dst[1] = o1;
    }
  }
}

template <int KC, bool VEC>
__global__ void __launch_bounds__(OW_MMA_WARPS * 32)
    orthogonalize_wide_mma_kernel(u64* v, u64* pb,
                                  const u64* __restrict__ av,
                                  const u64* __restrict__ rhs,
                                  const int* __restrict__ d, long long N,
                                  int n, WideField f, int* state) {
  extern __shared__ __align__(16) u32 ows[];
  constexpr int PS = KC * 8 + 4;  // plane row stride in words, = 4 mod 8
  const int w = 2 * n;
  const int np = (w + 7) & ~7;    // output columns, padded to the n-tile
  u32* plane = ows;               // [8 limbs][np columns][PS]
  u64* wts = reinterpret_cast<u64*>(plane + OW_LIMBS * np * PS);
  int* dm = reinterpret_cast<int*>(wts + OW_CLASSES);
  if (ortho_halt(state)) return;
  // B = rhs as byte planes: plane[l][c][k / 4] holds limb l of
  // rhs[k..k+3, c]; zeros past 2n and in the zero block
  for (int task = threadIdx.x; task < np * KC * 8; task += blockDim.x) {
    const int c = task / (KC * 8), q = task - c * (KC * 8);
    u64 wq[4];
    u32 limb[OW_LIMBS];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int k = 4 * q + u;
      const bool in = k < w && c < w && (k < n || c < n);
      wq[u] = in ? __ldg(rhs + k * w + c) : 0ull;
    }
    to_limbs64(wq, limb);
#pragma unroll
    for (int l = 0; l < OW_LIMBS; ++l) plane[(l * np + c) * PS + q] = limb[l];
  }
  // w_q = 2^(8q) 2^64 mod p: reduce128 of 2^(8q + 64) for q < 8, and one
  // more factor 2^64 (a Montgomery product with 2^128 mod p) above
  if (threadIdx.x < OW_CLASSES) {
    const int q = threadIdx.x, s = q < OW_LIMBS ? q : q - OW_LIMBS;
    u64 x = reduce128({0ull, 1ull << (8 * s)}, f);
    wts[q] = q < OW_LIMBS ? x : mont_mul(x, f.r2, f);
  }
  for (int e = threadIdx.x; e < n; e += blockDim.x) dm[e] = __ldg(d + e);
  __syncthreads();

  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const long long tiles = (N + 15) / 16;
  const int kc_p = (n + 31) / 32;  // k chunks a p' column needs (k < n)
  const long long stride = static_cast<long long>(gridDim.x) * OW_MMA_WARPS;
  for (long long tile = static_cast<long long>(blockIdx.x) * OW_MMA_WARPS +
                        (threadIdx.x >> 5);
       tile < tiles; tile += stride) {
    const long long r0 = tile * 16;
    // the tile's [v | p] rows as A fragments, all read before any write
    u32 A[KC][OW_LIMBS][4];
#pragma unroll
    for (int kc = 0; kc < KC; ++kc)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          u64 wq[4];
          u32 limb[OW_LIMBS];
          vp_quad64<VEC>(v, pb, r0 + g + 8 * rr, kc * 32 + 16 * h + 4 * t, n,
                         N, wq);
          to_limbs64(wq, limb);
#pragma unroll
          for (int l = 0; l < OW_LIMBS; ++l) A[kc][l][rr + 2 * h] = limb[l];
        }
    for (int col0 = 0; col0 < np; col0 += 8) {
      // the base of each output, loaded before the column tile's MMAs
      u64 base[4];
      ortho_base64(v, pb, av, dm, r0 + g, col0 + 2 * t, n, N, base);
      int S[OW_CLASSES][4];
#pragma unroll
      for (int q = 0; q < OW_CLASSES; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) S[q][e] = 0;
      const int kc_end = col0 >= n ? kc_p : KC;
#pragma unroll
      for (int kc = 0; kc < KC; ++kc) {
        if (kc < kc_end) {
          u32 B[OW_LIMBS][2];
#pragma unroll
          for (int l = 0; l < OW_LIMBS; ++l) {
            const u32* pl = plane + (l * np + col0 + g) * PS + kc * 8 + t;
            B[l][0] = pl[0];
            B[l][1] = pl[4];
          }
#pragma unroll
          for (int i = 0; i < OW_LIMBS; ++i)
#pragma unroll
            for (int j = 0; j < OW_LIMBS; ++j) mma_u8(S[i + j], A[kc][i], B[j]);
        }
      }
      // recombine: base 2^64 + H 2^32 + L, L / H the sums of S_q times the
      // low / high 32 bits of w_q (bounds in the header)
      u64 L[4] = {0, 0, 0, 0}, H[4] = {0, 0, 0, 0};
#pragma unroll
      for (int q = 0; q < OW_CLASSES; ++q) {
        const u64 wq = wts[q];
        const u32 wl = static_cast<u32>(wq), wh = static_cast<u32>(wq >> 32);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const u64 sq = static_cast<u32>(S[q][e]);
          L[e] += sq * wl;
          H[e] += sq * wh;
        }
      }
      u64 out[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        U128 acc = {L[e], base[e] + (H[e] >> 32)};
        add128(acc, H[e] << 32);
        out[e] = reduce_mont(acc, f);
      }
      store_outputs<VEC>(v, pb, r0 + g, col0 + 2 * t, n, N, out);
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

template <int NN>
static int launch_row(bool vec, u64* v, u64* pb, const u64* av,
                      const u64* rhs, const int* d, long long N,
                      const WideField& f, int* state, cudaStream_t s) {
  long long blocks = (N + OW_THREADS - 1) / OW_THREADS;
  if (blocks > 8LL * sm_count()) blocks = 8LL * sm_count();
  if (blocks < 1) blocks = 1;  // still one CTA: it counts the iteration
  const unsigned b = static_cast<unsigned>(blocks);
  if constexpr (NN % 2 == 0) {
    if (vec) {
      orthogonalize_wide_row_kernel<NN, true>
          <<<b, OW_THREADS, 0, s>>>(v, pb, av, rhs, d, N, f, state);
      return static_cast<int>(cudaGetLastError());
    }
  }
  orthogonalize_wide_row_kernel<NN, false>
      <<<b, OW_THREADS, 0, s>>>(v, pb, av, rhs, d, N, f, state);
  return static_cast<int>(cudaGetLastError());
}

template <int KC, bool VEC>
static int launch_mma(u64* v, u64* pb, const u64* av, const u64* rhs,
                      const int* d, long long N, int n, const WideField& f,
                      int* state, cudaStream_t s) {
  auto kernel = orthogonalize_wide_mma_kernel<KC, VEC>;
  static bool smem_set = false;  // the attribute, once for the widest n
  if (!smem_set) {
    const size_t most = static_cast<size_t>(OW_LIMBS) * (KC * 32) *
                            (KC * 8 + 4) * 4 + OW_CLASSES * 8 + 32 * KC * 4;
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(most));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const int np = (2 * n + 7) & ~7;
  const size_t smem = static_cast<size_t>(OW_LIMBS) * np * (KC * 8 + 4) * 4 +
                      OW_CLASSES * 8 + n * 4;
  const long long tiles = (N + 15) / 16;
  long long blocks = (tiles + OW_MMA_WARPS - 1) / OW_MMA_WARPS;
  const long long cap = 4LL * sm_count();
  blocks = blocks > cap ? cap : blocks < 1 ? 1 : blocks;
  kernel<<<static_cast<unsigned>(blocks), OW_MMA_WARPS * 32, smem, s>>>(
      v, pb, av, rhs, d, N, n, f, state);
  return static_cast<int>(cudaGetLastError());
}

template <int KC>
static int launch_mma_vec(bool vec, u64* v, u64* pb, const u64* av,
                          const u64* rhs, const int* d, long long N, int n,
                          const WideField& f, int* state, cudaStream_t s) {
  return vec ? launch_mma<KC, true>(v, pb, av, rhs, d, N, n, f, state, s)
             : launch_mma<KC, false>(v, pb, av, rhs, d, N, n, f, state, s);
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
  const uintptr_t align = reinterpret_cast<uintptr_t>(v) |
                          reinterpret_cast<uintptr_t>(pb) |
                          reinterpret_cast<uintptr_t>(av);
  if (n >= OW_MMA_MIN_N) {
    const bool vec = n % 4 == 0 && align % 16 == 0;
    switch ((2 * n + 31) / 32) {
      case 1: return launch_mma_vec<1>(vec, v, pb, av, rhs, d, N, n, f, state, s);
      case 2: return launch_mma_vec<2>(vec, v, pb, av, rhs, d, N, n, f, state, s);
      case 3: return launch_mma_vec<3>(vec, v, pb, av, rhs, d, N, n, f, state, s);
      default: return launch_mma_vec<4>(vec, v, pb, av, rhs, d, N, n, f, state, s);
    }
  }
  const bool vec = align % 16 == 0;  // with n even (launch_row)
  switch (n) {
    case 1: return launch_row<1>(vec, v, pb, av, rhs, d, N, f, state, s);
    case 2: return launch_row<2>(vec, v, pb, av, rhs, d, N, f, state, s);
    case 3: return launch_row<3>(vec, v, pb, av, rhs, d, N, f, state, s);
    case 4: return launch_row<4>(vec, v, pb, av, rhs, d, N, f, state, s);
    case 5: return launch_row<5>(vec, v, pb, av, rhs, d, N, f, state, s);
    case 6: return launch_row<6>(vec, v, pb, av, rhs, d, N, f, state, s);
    case 7: return launch_row<7>(vec, v, pb, av, rhs, d, N, f, state, s);
    default: return launch_row<8>(vec, v, pb, av, rhs, d, N, f, state, s);
  }
}
