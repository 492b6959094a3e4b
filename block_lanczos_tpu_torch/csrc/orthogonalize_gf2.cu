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
// v and p are updated IN PLACE.  The bottom-right block of rhs (rows n..2n,
// columns n..2n) must be zero, as semi_inverse_gf2 writes it.  When the
// latched state says stop or a failed invariant (state = [stop, inv_ok,
// k_done, frozen]), v and p are left as they are.  Thread 0 of block 0
// counts the iteration in k_done while the state is not yet frozen and
// freezes it on a halt, so a block of K launched iterations counts exactly
// the unhalted ones (the stopping probe included) and every iteration after
// a halt changes nothing.
//
// Design.  upd is the parity of an integer product contracted over the 2n
// bit columns k of [v | p]: upd = (X R) & 1 with X = [v | p] (N x 2n bits)
// and R = rhs.  That product runs on the tensor cores as
// mma.sync.aligned.m16n8k256.row.col.s32.b1.b1.s32.and.popc (gram_gf2.cu's
// instruction): a 16 x 8 tile of s32 counts += popc(A_row & B_col) over 256
// k at a time.
//   * A needs no transpose.  A row of X holds its k along the bits of its
//     words (word idx < W of v, then word idx - W of p: k = 32 idx + bit),
//     so a lane's A register is one word of one row, loaded as it lies.  The
//     k-words of a row are taken 8 a K-step (OgShape::KS of them, zero past
//     2W).
//   * Only rhs is transposed.  B is .col, so an output column c needs its
//     k-bits along words: rhs^T.  Each CTA transposes rhs once (transpose32x2
//     on 32 x 32 blocks) into shared memory, laid out in fragment order: the
//     (b0, b1) pair of every lane for every n8 tile and K-step side by side,
//     so a B fragment is one conflict-free 8-byte load.  A and B put the same
//     k-word in the same register position, so every count pairs the same
//     256 k whatever order the hardware gives the k within a register.
//   * The zero block: output columns c >= n (p's update) see only rhs rows
//     k < n, so they skip the K-steps that hold only p words.
//   * A warp owns whole rows: a tile of 32 (two m16 tiles that share each B
//     fragment) across all 2n output columns.  It holds the tile's words in
//     registers (lane 4g + t: words 4i + t of rows 8h + g, the A fragments'
//     layout) and its Av words alike, and issues the next tile's loads
//     before it multiplies this one (a grid-stride loop over tiles).  Every
//     row is read before any word of it is written, so the update in place
//     is safe.
//   * Finish, per 32 output columns (4 n8 tiles): each count's parity is
//     the low bit of its low byte; two byte permutes gather the four tiles'
//     low bytes and a mask and shift place a lane's 8 bits of the word.  The
//     four lanes of a group then reduce-scatter four such words with three
//     shuffles, so lane t ends with word 4i + t of its rows, the very word it
//     holds of v or p, applies the masked selects and stores it.
// ops/gf2.py::orthogonalize_gf2_tiles_np mirrors the transpose, the
// fragments, the K-step padding, the packing and the selects step for step.
//
// What bounds it on an H100: bytes.  v, p and Av are read and v and p
// written, 5 N W words (24 MB at the bench size, n = 128: ~0.007 ms at
// 3.35 TB/s); the product is 3 n^2 bit multiply-adds a row, ~3e10
// operations at n = 128, ~0.003 ms at the binary rate gram_gf2_rate
// measures.  The kernel reaches about half the memory rate (PERF.md): a
// warp holds one tile in flight in registers while it issues some 600
// instructions a tile at n = 128, half of them the parity packing (~10 per
// 8 bits a lane), so the loads' latency and the issue share the time (an
// L2 prefetch of the tiles further on measured slower); n = 32 runs faster
// on the CUDA cores (OG_MMA_MIN_N).
#include "gf2.cuh"

#define OG_WARPS 8      // warps a CTA (16 measured no faster)
#define OG_ROWS 32      // rows a warp tile: two m16 tiles
// Below this n the CUDA-core kernel runs (one thread a row, rhs rows
// broadcast from shared memory; measured faster at n = 32), from it the
// tensor-core kernel.
#ifndef OG_MMA_MIN_N
#define OG_MMA_MIN_N 64
#endif

template <int W>
struct OgShape {
  static constexpr int n = 32 * W;
  static constexpr int KW = 2 * W;          // k-words of a row of [v | p]
  static constexpr int KS = (KW + 7) / 8;   // K-steps of 256 k
  static constexpr int KSV = (W + 7) / 8;   // those holding a word of v
  static constexpr int XI = 2 * KS;         // words 4 i + t a lane holds a row
  static constexpr int AI = (W + 3) / 4;    // ... of Av
  static constexpr int QG = (KW + 3) / 4;   // groups of 4 output words
  static constexpr int TILES = 2 * n / 8;   // n8 tiles of output columns
  static constexpr int B_WORDS = TILES * KS * 32 * 2;  // rhs^T, fragment order
};

// The low bytes of four counts as one word: bit 0 of byte j is the parity
// of c_j.
__device__ __forceinline__ u32 low_bytes(int c0, int c1, int c2, int c3) {
  return __byte_perm(__byte_perm(c0, c1, 0x0040), __byte_perm(c2, c3, 0x0040),
                     0x5410);
}

// Words 4 i + t (i < XI) of row r of [v | p] and 4 i + t (i < AI) of Av,
// zero past the row's words or past N.
template <int W>
__device__ __forceinline__ void load_rows(const int* v, const int* pb,
                                          const int* __restrict__ av,
                                          long long r, long long N, int t,
                                          u32 (&x)[OgShape<W>::XI],
                                          u32 (&a)[OgShape<W>::AI]) {
  using S = OgShape<W>;
  const bool in = r < N;
#pragma unroll
  for (int i = 0; i < S::XI; ++i) {
    const int idx = 4 * i + t;
    x[i] = 0;
    if (in && idx < S::KW)
      x[i] = static_cast<u32>(idx < W ? v[r * W + idx] : pb[r * W + idx - W]);
  }
#pragma unroll
  for (int i = 0; i < S::AI; ++i) {
    const int idx = 4 * i + t;
    a[i] = in && idx < W ? static_cast<u32>(__ldg(av + r * W + idx)) : 0u;
  }
}

template <int W>
__global__ void __launch_bounds__(OG_WARPS * 32)
    orthogonalize_gf2_mma_kernel(int* v, int* pb, const int* __restrict__ av,
                                 const int* __restrict__ rhs,
                                 const int* __restrict__ d, long long N,
                                 int* __restrict__ state) {
  using S = OgShape<W>;
  extern __shared__ __align__(16) u32 sh[];
  u32* Bf = sh;                 // [(tile KS + s) 32 + lane][2]
  u32* cm = sh + S::B_WORDS;    // the column mask of d
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  if (ortho_halt(state)) return;

  // rhs^T into fragment order: block (k-word w, column words 2 c2, 2 c2 + 1)
  // is rows 32 w + lane of rhs, transposed; lane l then holds the k-word w
  // of output columns 64 c2 + l and 64 c2 + 32 + l.
  for (int e = warp; e < 8 * S::KS * W; e += OG_WARPS) {
    const int w = e / W, c2 = e % W;
    u32 x1 = 0, x2 = 0;
    if (w < S::KW) {
      const int* row = rhs + (32 * w + lane) * S::KW + 2 * c2;
      x1 = static_cast<u32>(__ldg(row));
      x2 = static_cast<u32>(__ldg(row + 1));
    }
    transpose32x2(x1, x2, lane);
    const int s = w >> 3, j = w & 7;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = 64 * c2 + 32 * h + lane;
      Bf[(((c >> 3) * S::KS + s) * 32 + 4 * (c & 7) + (j & 3)) * 2 +
         (j >> 2)] = h ? x2 : x1;
    }
  }
  if (tid < W) {
    u32 m = 0;
    for (int b = 0; b < 32; ++b)
      m |= static_cast<u32>(__ldg(d + 32 * tid + b) != 0) << b;
    cm[tid] = m;
  }
  __syncthreads();

  const uint2* B2 = reinterpret_cast<const uint2*>(Bf) + lane;
  const long long tiles = (N + OG_ROWS - 1) / OG_ROWS;
  const long long stride = static_cast<long long>(gridDim.x) * OG_WARPS;
  long long tile = static_cast<long long>(blockIdx.x) * OG_WARPS + warp;
  // rows 8 h + g of the tile: x, its words of [v | p]; a, of Av
  u32 x[4][S::XI], a[4][S::AI];
#pragma unroll
  for (int h = 0; h < 4; ++h)
    load_rows<W>(v, pb, av, tile * OG_ROWS + 8 * h + g, N, t, x[h], a[h]);
  for (; tile < tiles; tile += stride) {
    u32 nx[4][S::XI], na[4][S::AI];
#pragma unroll
    for (int h = 0; h < 4; ++h)
      load_rows<W>(v, pb, av, (tile + stride) * OG_ROWS + 8 * h + g, N, t,
                   nx[h], na[h]);
#pragma unroll
    for (int qg = 0; qg < S::QG; ++qg) {
      u32 part[4][4];   // [row 8 h + g][word 4 qg + qq]: this lane's bits
#pragma unroll
      for (int qq = 0; qq < 4; ++qq) {
        const int q = 4 * qg + qq;     // output word: columns 32 q ..
        if (q >= S::KW) {
#pragma unroll
          for (int h = 0; h < 4; ++h) part[h][qq] = 0;
          continue;
        }
        int acc[2][4][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int jj = 0; jj < 4; ++jj)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][jj][e] = 0;
#pragma unroll
        for (int s = 0; s < (q < W ? S::KS : S::KSV); ++s) {
          u32 af[2][4];
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            af[m][0] = x[2 * m][2 * s];
            af[m][1] = x[2 * m + 1][2 * s];
            af[m][2] = x[2 * m][2 * s + 1];
            af[m][3] = x[2 * m + 1][2 * s + 1];
          }
#pragma unroll
          for (int jj = 0; jj < 4; ++jj) {
            const uint2 bq = B2[((4 * q + jj) * S::KS + s) * 32];
            const u32 bf[2] = {bq.x, bq.y};
            mma_b1(acc[0][jj], af[0], bf);
            mma_b1(acc[1][jj], af[1], bf);
          }
        }
        // bit 8 jj + 2 t + e of the word: tile jj, column 2 t + e
#pragma unroll
        for (int h = 0; h < 4; ++h) {
          const int (&c)[4][4] = acc[h >> 1];
          const int e0 = 2 * (h & 1);
          const u32 p0 = low_bytes(c[0][e0], c[1][e0], c[2][e0], c[3][e0]);
          const u32 p1 = low_bytes(c[0][e0 + 1], c[1][e0 + 1], c[2][e0 + 1],
                                   c[3][e0 + 1]);
          part[h][qq] = ((p0 & 0x01010101u) | ((p1 << 1) & 0x02020202u))
                        << (2 * t);
        }
      }
      // reduce-scatter over the 4 lanes of a group: lane t keeps word
      // 4 qg + t, the one it holds of v or p
      const bool t2 = t & 2, t1 = t & 1;
      const int qw = 4 * qg + t;
      const u32 cmw = qw < S::KW ? cm[qw < W ? qw : qw - W] : 0u;
#pragma unroll
      for (int h = 0; h < 4; ++h) {
        u32 k0 = t2 ? part[h][2] : part[h][0];
        u32 k1 = t2 ? part[h][3] : part[h][1];
        k0 |= __shfl_xor_sync(GF2_FULL_MASK, t2 ? part[h][0] : part[h][2], 2);
        k1 |= __shfl_xor_sync(GF2_FULL_MASK, t2 ? part[h][1] : part[h][3], 2);
        u32 upd = t1 ? k1 : k0;
        upd |= __shfl_xor_sync(GF2_FULL_MASK, t1 ? k0 : k1, 1);
        const long long r = tile * OG_ROWS + 8 * h + g;
        if (r >= N || qw >= S::KW) continue;
        const u32 xw = x[h][qg];
        if (qw < W) {
          const u32 aw = qg < S::AI ? a[h][qg < S::AI ? qg : 0] : 0u;
          v[r * W + qw] = static_cast<int>(((aw & cmw) | (xw & ~cmw)) ^ upd);
        } else {
          pb[r * W + qw - W] = static_cast<int>((xw & ~cmw) ^ upd);
        }
      }
    }
#pragma unroll
    for (int h = 0; h < 4; ++h) {
#pragma unroll
      for (int i = 0; i < S::XI; ++i) x[h][i] = nx[h][i];
#pragma unroll
      for (int i = 0; i < S::AI; ++i) a[h][i] = na[h][i];
    }
  }
}

// The CUDA-core kernel, below OG_MMA_MIN_N: one thread per row, rhs in
// shared memory; each bit k of the row becomes a mask and the thread XORs
// mask & rhs[k] (a broadcast load) into 2W register accumulators, W for the
// rows k >= n whose right half is zero.
#define OG_THREADS 256

template <int W>
__global__ void __launch_bounds__(OG_THREADS)
    orthogonalize_gf2_core_kernel(int* __restrict__ v, int* __restrict__ pb,
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

// Launch `kernel` with `threads` threads and `smem` bytes in a grid-stride
// loop over `work` items of `per_cta` each, at most one wave of CTAs and at
// least one CTA (so that the state is counted even when N == 0).
template <typename K>
static cudaError_t launch_wave(K kernel, int threads, size_t smem,
                               long long work, long long per_cta, int& fit,
                               int* v, int* pb, const int* av,
                               const int* rhs, const int* d, long long N,
                               int* state, cudaStream_t s) {
  if (fit == 0) {   // CTAs per SM, once per kernel
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fit, kernel,
                                                        threads, smem);
    if (err != cudaSuccess) return err;
    if (fit < 1) fit = 1;
  }
  long long blocks = (work + per_cta - 1) / per_cta;
  const long long wave = static_cast<long long>(fit) * gf2_sm_count();
  if (blocks > wave) blocks = wave;
  if (blocks < 1) blocks = 1;
  kernel<<<static_cast<unsigned>(blocks), threads, smem, s>>>(
      v, pb, av, rhs, d, N, state);
  return cudaGetLastError();
}

template <int W>
static cudaError_t launch(int* v, int* pb, const int* av, const int* rhs,
                          const int* d, long long N, int* state,
                          cudaStream_t s) {
  static int fit = 0;
  if constexpr (32 * W >= OG_MMA_MIN_N) {
    const size_t smem = (OgShape<W>::B_WORDS + W) * sizeof(u32);
    return launch_wave(orthogonalize_gf2_mma_kernel<W>, OG_WARPS * 32, smem,
                       (N + OG_ROWS - 1) / OG_ROWS, OG_WARPS, fit, v, pb, av,
                       rhs, d, N, state, s);
  } else {
    const size_t smem = (2 * 32 * W * 2 * W + W) * sizeof(u32);
    return launch_wave(orthogonalize_gf2_core_kernel<W>, OG_THREADS, smem, N,
                       OG_THREADS, fit, v, pb, av, rhs, d, N, state, s);
  }
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
