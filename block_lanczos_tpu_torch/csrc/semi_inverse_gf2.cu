// semi_inverse_gf2 — the n x n two-phase bit Gauss-Jordan "semi-inverse"
// of the GF(2) Gram matrix, the fused invariant checks and the
// orthogonalize right-hand side, in one CTA.
//
// Replaces, in the JAX package, ops/gf2.py::semi_inverse_gf2 (a fori_loop
// of masked row swaps over bit words), models/lanczos_gf2.py::
// check_invariants_gf2 (with ops/gf2.py::transpose_bits and the n x n
// matmul_gf2) and the n x n prologue of orthogonalize_gf2 (spliced =
// (vtAAv & cm) | (vtAv & ~cm), c = winv * spliced, vtAvd = vtAv & cm).
//
// Input grams (2n, W) words = [vtAv ; vtAAv], n = 32 W.  Outputs: winv
// (n, W), d (n), npiv (1), rhs (2n, 2W) = [[c, winv], [vtAvd, 0]], and the
// solver's latched flags in state = [stop, inv_ok, k_done, frozen]:
// stop = (npiv == 0) and inv_ok (1 when check == 0) are written unless the
// state is frozen (an earlier iteration halted; see orthogonalize_gf2.cu).
//
// The elimination is the JAX package's, step for step: for column j the
// pivot is the first row i >= j (in the current row order) with bit j set;
// rows j and i swap in M and W; every other row with bit j set XORs row j
// into itself, in M and in W.  Over GF(2) no row is normalised.  Rows never
// move: each row keeps its logical position `pos`, and a swap of logical
// rows j and i changes two rows' pos, which every thread works out from
// (j, i) itself.  The pivot is the least key (pos << 10 | row) among the
// candidates: it gives the pivot's logical index and its physical row
// together.  Phase 1 needs only which columns pivot (d1), so it tracks no W.
//
// Two ways to run the 2n dependent pivot steps, chosen by W at compile time:
//   * W <= SI2_WARP_MAXW (n <= 64): one warp, no block barrier.  Lane l
//     holds rows l + 32 q (q < W) of M and of W in registers, 2 W^2 words.
//     A step is each lane's least key over its rows (a tree), one
//     __reduce_min_sync, the pivot row's slot selected (it is uniform) and
//     its words shuffled from its lane, and the masked XOR into the lane's
//     rows: registers and shuffles only.  M's words below column j's word
//     are not updated: no later step reads them.  A step issues ~2 W^2 + 8 W
//     instructions on the one warp, so from n = 128 it is slower than one
//     thread a row.
//   * Wider: one thread per row in a CTA of n threads, each row in registers
//     and mirrored to shared memory, where the pivot row is read; the block-
//     wide min of the keys goes through the W warp minima in shared memory
//     (double-buffered by step, read back as vectors and reduced as a
//     tree), one barrier a step.  M's words below the step's word are
//     neither read nor written.
// The checks and the right-hand side then run a thread per output row:
// transposes by 32 broadcast loads per word, the two n x n products by
// masked XORs of broadcast rows.
//
// What bounds it on an H100: the dependent chain, not bytes or operations.
// 2n pivot steps run one after another, each at least a warp reduction
// (~40 cycles) and a dependent read of the pivot row: ~80 cycles a step.
// Measured with -DSI2_TIMELINE (utils/kernel_sweeps.py: thread 0's
// clock64() at the end of each phase and the start of every pivot step;
// PERF.md): one thread a row ~260 / 340 cycles a step (phase 1 / 2) at
// n = 128: a warp reduction, a barrier, the minima's and the pivot row's
// shared-memory reads in a row; one warp ~175 at n = 32, but at n = 128
// ~100 instructions a step on the one warp, ~280 / 350.
#include "gf2.cuh"

#define SI2_NO_PIVOT 0x7fffffff
// W up to this: the one-warp elimination (measured faster than one thread a
// row up to n = 64, slower from n = 128: PERF.md)
#ifndef SI2_WARP_MAXW
#define SI2_WARP_MAXW 2
#endif

// Design measurement only: the timeline's slots are the kernel's phases
// (SI2_T_*, and %globaltimer in ns at its start and end) and the start of
// each pivot step of phase 1 (SI2_T_STEP1 + j) and phase 2 (SI2_T_STEP2 + j);
// semi_inverse_gf2_stamps copies them to the host.
#ifdef SI2_TIMELINE
enum {
  SI2_T_START, SI2_T_LOADED, SI2_T_PHASE1, SI2_T_P2INIT, SI2_T_PHASE2,
  SI2_T_WINV, SI2_T_PRODUCTS, SI2_T_CHECKS, SI2_T_END, SI2_T_NS_START,
  SI2_T_NS_END, SI2_T_STEP1 = 16, SI2_T_STEP2 = SI2_T_STEP1 + GF2_MAXN,
  SI2_T_SLOTS = SI2_T_STEP2 + GF2_MAXN
};
__device__ long long si2_stamps[SI2_T_SLOTS];
#define SI2_STAMP(slot) \
  if (threadIdx.x == 0) si2_stamps[slot] = clock64()
__device__ __forceinline__ long long globaltimer_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int semi_inverse_gf2_stamps(long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, si2_stamps, sizeof(si2_stamps)));
}
#else
#define SI2_STAMP(slot)
#endif

struct Si2Shared {
  __align__(16) u32 red[2][GF2_MAXW];  // warp minima of the pivot keys, by
                                       // step parity
  u32 d1[GF2_MAXN];      // phase 1's pivot columns (one thread a row)
  u32 d[GF2_MAXN];       // phase 2's
  u32 cm[GF2_MAXW];      // column mask: of d1, then of d
  int ok;
};

// a ^= row (words below `from` may be left out)
template <int W>
__device__ __forceinline__ void xor_row(u32 (&a)[W], const u32* row,
                                        int from = 0) {
  u32 b[W];
#pragma unroll
  for (int q = 0; q < W; ++q) b[q] = 0;
  load_row<W>(row, b, from);
#pragma unroll
  for (int q = 0; q < W; ++q) a[q] ^= b[q];
}

// The least of k[0 .. C), as a tree (depth log2 C).
template <int C, typename T>
__device__ __forceinline__ T tree_min(T (&k)[C]) {
#pragma unroll
  for (int s = 1; s < C; s *= 2)
#pragma unroll
    for (int q = 0; q + s < C; q += 2 * s) k[q] = min(k[q], k[q + s]);
  return k[0];
}

// One Gauss-Jordan sweep over the n = 32 W columns of M (and Wm) by one
// warp: lane l holds physical rows l + 32 q in m[q] (and w[q]), and their
// keys pk[q] = pos << 10 | row; from logical order = physical order.  Sets
// dw (the pivot columns as words, the same in every lane) and pk (the final
// logical positions); returns the number of pivots.  A step: the
// candidates' keys, their least by a tree in the lane and __reduce_min_sync
// across lanes, the pivot row's slot selected (it is uniform) and its words
// shuffled from its lane, then the masked XOR and the pos swap.
template <int W, bool WITH_W>
__device__ int eliminate_warp(u32 (&m)[W][W], u32 (&w)[W][W], int (&pk)[W],
                              u32 (&dw)[W]) {
  const int lane = threadIdx.x & 31;
  int npiv = 0;
#pragma unroll
  for (int q = 0; q < W; ++q) pk[q] = (lane + 32 * q) * 1025;
#pragma unroll
  for (int jw = 0; jw < W; ++jw) {
    u32 found = 0;
#pragma unroll 1
    for (int b = 0; b < 32; ++b) {
      const int j = 32 * jw + b;
      SI2_STAMP((WITH_W ? SI2_T_STEP2 : SI2_T_STEP1) + j);
      const u32 bit = 1u << b;
      int key[W];
#pragma unroll
      for (int q = 0; q < W; ++q)
        key[q] = (m[q][jw] & bit) && pk[q] >= j << 10 ? pk[q] : SI2_NO_PIVOT;
      const int k = __reduce_min_sync(GF2_FULL_MASK, tree_min<W>(key));
      if (k == SI2_NO_PIVOT) continue;  // uniform: nothing is written
      found |= bit;
      ++npiv;
      const int P = k & 1023, qp = P >> 5;
      u32 pm[W], pw[W];   // M's words below jw: no later step reads them
#pragma unroll
      for (int c = jw; c < W; ++c) {
        u32 x = m[0][c];
#pragma unroll
        for (int q = 1; q < W; ++q) x = q == qp ? m[q][c] : x;
        pm[c] = __shfl_sync(GF2_FULL_MASK, x, P & 31);
      }
      if constexpr (WITH_W) {
#pragma unroll
        for (int c = 0; c < W; ++c) {
          u32 x = w[0][c];
#pragma unroll
          for (int q = 1; q < W; ++q) x = q == qp ? w[q][c] : x;
          pw[c] = __shfl_sync(GF2_FULL_MASK, x, P & 31);
        }
      }
      // logical rows piv = k >> 10 and j trade places: either one's pos
      // flips by piv ^ j
      const int swap = ((k >> 10) ^ j) << 10;
#pragma unroll
      for (int q = 0; q < W; ++q) {
        if ((m[q][jw] & bit) && pk[q] != k) {
#pragma unroll
          for (int c = jw; c < W; ++c) m[q][c] ^= pm[c];
          if constexpr (WITH_W) {
#pragma unroll
            for (int c = 0; c < W; ++c) w[q][c] ^= pw[c];
          }
        }
        const int pos = pk[q] >> 10;
        if (pos == k >> 10 || pos == j) pk[q] ^= swap;
      }
    }
    dw[jw] = found;
  }
  return npiv;
}

// One Gauss-Jordan sweep over the n = 32 W columns of M (and Wm), one
// thread per physical row t, holding the row in m (and w) and mirroring it
// to Ms[t] (and Ws[t]); from logical order = physical order.  Writes d (by
// thread 0), returns the number of pivots and sets pos to the final
// logical position of the thread's row.  Ends with a barrier.
template <int W, bool WITH_W>
__device__ int eliminate(u32 (&m)[W], u32 (&w)[W], u32* Ms, u32* Ws,
                         Si2Shared& s, u32* d, int& pos) {
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  int npiv = 0;
  pos = t;
#pragma unroll
  for (int jw = 0; jw < W; ++jw) {
#pragma unroll 1
    for (int b = 0; b < 32; ++b) {
      const int j = 32 * jw + b;
      SI2_STAMP((WITH_W ? SI2_T_STEP2 : SI2_T_STEP1) + j);
      const bool bit = (m[jw] >> b) & 1u;
      const int key = bit && pos >= j ? (pos << 10) | t : SI2_NO_PIVOT;
      const int wmin = __reduce_min_sync(GF2_FULL_MASK, key);
      if (lane == 0) s.red[b & 1][warp] = wmin;
      __syncthreads();
      u32 mins[W];
      load_row<W>(s.red[b & 1], mins);
      const int k = static_cast<int>(tree_min<W>(mins));
      if (t == 0) d[j] = k != SI2_NO_PIVOT;
      if (k == SI2_NO_PIVOT) continue;  // uniform: nothing is written
      const int piv = k >> 10, P = k & 1023;
      ++npiv;
      if (pos == piv)
        pos = j;
      else if (pos == j)
        pos = piv;
      if (bit && t != P) {   // M's words below jw: no later step reads them
        xor_row<W>(m, Ms + P * W, jw);
        store_row<W>(Ms + t * W, m, jw);
        if constexpr (WITH_W) {
          xor_row<W>(w, Ws + P * W);
          store_row<W>(Ws + t * W, w);
        }
      }
    }
  }
  __syncthreads();
  return npiv;
}

// Both phases by one warp (warp 0): rows from U in shared memory; leaves
// winv in logical order in Ms, d in s.d and its column mask in s.cm.
template <int W>
__device__ int semi_inverse_warp(const u32* U, u32* Ms, Si2Shared& s) {
  const int lane = threadIdx.x & 31;
  u32 m[W][W], w[W][W], d1[W], d2[W];
  int pk[W];
#pragma unroll
  for (int q = 0; q < W; ++q) load_row<W>(U + (lane + 32 * q) * W, m[q]);
  eliminate_warp<W, false>(m, w, pk, d1);
  SI2_STAMP(SI2_T_PHASE1);
  // phase 2: re-eliminate U masked by d1 (rows and columns) from eye * d1
#pragma unroll
  for (int q = 0; q < W; ++q) {
    const bool keep = (d1[q] >> lane) & 1u;
    load_row<W>(U + (lane + 32 * q) * W, m[q]);
#pragma unroll
    for (int c = 0; c < W; ++c) {
      m[q][c] = keep ? m[q][c] & d1[c] : 0u;
      w[q][c] = keep && c == q ? 1u << lane : 0u;
    }
  }
  SI2_STAMP(SI2_T_P2INIT);
  const int npiv = eliminate_warp<W, true>(m, w, pk, d2);
  SI2_STAMP(SI2_T_PHASE2);
#pragma unroll
  for (int q = 0; q < W; ++q) {
    store_row<W>(Ms + (pk[q] >> 10) * W, w[q]);
    s.d[lane + 32 * q] = (d2[q] >> lane) & 1u;
    if (lane == 0) s.cm[q] = d2[q];
  }
  return npiv;
}

// Word wc of row i of X^T: bit b is bit i of row 32 wc + b of X (rows of W
// words; the 32 threads of a warp read the same words: broadcasts).
template <int W>
__device__ __forceinline__ u32 transposed_word(const u32* X, int i, int wc) {
  u32 t = 0;
#pragma unroll
  for (int b = 0; b < 32; ++b)
    t |= ((X[(32 * wc + b) * W + (i >> 5)] >> (i & 31)) & 1u) << b;
  return t;
}

template <int W>
__global__ void __launch_bounds__(32 * W)
    semi_inverse_gf2_kernel(const int* __restrict__ grams, int check,
                            int* __restrict__ winv, int* __restrict__ d_out,
                            int* __restrict__ npiv_out, int* __restrict__ rhs,
                            int* __restrict__ state) {
  constexpr int n = 32 * W;
  extern __shared__ __align__(16) u32 dyn[];
  __shared__ Si2Shared s;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
#ifdef SI2_TIMELINE
  if (t == 0) si2_stamps[SI2_T_NS_START] = globaltimer_ns();
#endif
  SI2_STAMP(SI2_T_START);
  u32* U = dyn;          // vtAv
  u32* UA = U + n * W;   // vtAAv
  u32* Ms = UA + n * W;  // M's rows (one thread a row); then winv, logical
  u32* Ws = Ms + n * W;  // phase 2's W rows (one thread a row); then spliced
  const int frozen = t == 0 ? state[3] : 0;  // read early, used at the end

  {
    u32 u[W], ua[W];
#pragma unroll
    for (int q = 0; q < W; ++q) {
      u[q] = static_cast<u32>(__ldg(grams + t * W + q));
      ua[q] = static_cast<u32>(__ldg(grams + (n + t) * W + q));
    }
    store_row<W>(U + t * W, u);
    store_row<W>(UA + t * W, ua);
  }
  if (t == 0) s.ok = 1;
  int npiv = 0;
  if constexpr (W <= SI2_WARP_MAXW) {
    __syncthreads();
    SI2_STAMP(SI2_T_LOADED);
    if (warp == 0) npiv = semi_inverse_warp<W>(U, Ms, s);
  } else {
    // phase 1: find the pivotable column set d1 (W is not tracked)
    u32 m[W], w[W];
    load_row<W>(U + t * W, m);
    store_row<W>(Ms + t * W, m);
    __syncthreads();
    SI2_STAMP(SI2_T_LOADED);
    int pos;
    eliminate<W, false>(m, w, Ms, Ws, s, s.d1, pos);
    SI2_STAMP(SI2_T_PHASE1);
    // phase 2: re-eliminate U masked by d1 (rows and columns) from eye * d1
    const u32 m1 = __ballot_sync(GF2_FULL_MASK, s.d1[t] != 0);  // word warp
    if (lane == 0) s.cm[warp] = m1;
    __syncthreads();
    const bool keep = s.d1[t] != 0;
    load_row<W>(U + t * W, m);
#pragma unroll
    for (int q = 0; q < W; ++q) {
      m[q] = keep ? m[q] & s.cm[q] : 0u;
      w[q] = keep && q == warp ? 1u << lane : 0u;
    }
    store_row<W>(Ms + t * W, m);
    store_row<W>(Ws + t * W, w);
    __syncthreads();
    SI2_STAMP(SI2_T_P2INIT);
    npiv = eliminate<W, true>(m, w, Ms, Ws, s, s.d, pos);
    SI2_STAMP(SI2_T_PHASE2);
    const u32 m2 = __ballot_sync(GF2_FULL_MASK, s.d[t] != 0);
    if (lane == 0) s.cm[warp] = m2;
    store_row<W>(Ms + pos * W, w);   // winv in logical order
  }
  __syncthreads();
  u32 cm[W], u[W], ua[W];
#pragma unroll
  for (int q = 0; q < W; ++q) cm[q] = s.cm[q];
  load_row<W>(U + t * W, u);
  load_row<W>(UA + t * W, ua);
  // the spliced rows of t into Ws
  {
    u32 sp[W];
#pragma unroll
    for (int q = 0; q < W; ++q) sp[q] = (ua[q] & cm[q]) | (u[q] & ~cm[q]);
    store_row<W>(Ws + t * W, sp);
  }
  __syncthreads();
  SI2_STAMP(SI2_T_WINV);

  // thread t owns row i = t of every output
  const int i = t;
  const bool di = s.d[i] != 0;
  u32 wi[W], c[W], chk[W];
  load_row<W>(Ms + i * W, wi);
#pragma unroll
  for (int q = 0; q < W; ++q) c[q] = chk[q] = 0;
#pragma unroll
  for (int kw = 0; kw < W; ++kw) {
    const u32 x = wi[kw];
#pragma unroll 4
    for (int b = 0; b < 32; ++b) {
      const u32 mk = bit_mask(x, b);
      const int k = 32 * kw + b;
      u32 uk[W], sk[W];
      load_row<W>(U + k * W, uk);
      load_row<W>(Ws + k * W, sk);
#pragma unroll
      for (int q = 0; q < W; ++q) {
        c[q] ^= mk & sk[q];
        chk[q] ^= mk & uk[q];
      }
    }
  }
  SI2_STAMP(SI2_T_PRODUCTS);
  int ok = 1;
  u32* top = reinterpret_cast<u32*>(rhs) + i * 2 * W;  // [c, winv]
  u32* bot = top + n * 2 * W;                         // [vtAv & cm, 0]
#pragma unroll
  for (int q = 0; q < W; ++q) {
    top[q] = c[q];
    top[W + q] = wi[q];
    bot[q] = u[q] & cm[q];
    bot[W + q] = 0u;
    winv[i * W + q] = static_cast<int>(wi[q]);
    if (check) {
      // winv * (vtAv & cm) == diag(d); winv's support within d
      const u32 eye = di && q == (i >> 5) ? 1u << (i & 31) : 0u;
      ok &= (chk[q] & cm[q]) == eye;
      ok &= di || (wi[q] & ~cm[q]) == 0u;
      // symmetry of vtAv, vtAAv and winv
      ok &= transposed_word<W>(U, i, q) == u[q];
      ok &= transposed_word<W>(UA, i, q) == ua[q];
      ok &= transposed_word<W>(Ms, i, q) == wi[q];
    }
  }
  d_out[i] = di ? 1 : 0;
  if (!ok) atomicAnd(&s.ok, 0);
  SI2_STAMP(SI2_T_CHECKS);
  __syncthreads();
  if (t == 0) {
    npiv_out[0] = npiv;
    if (!frozen) {
      state[0] = npiv == 0;
      state[1] = check ? s.ok : 1;
    }
  }
  SI2_STAMP(SI2_T_END);
#ifdef SI2_TIMELINE
  if (t == 0) si2_stamps[SI2_T_NS_END] = globaltimer_ns();
#endif
}

template <int W>
static cudaError_t launch(const int* grams, int check, int* winv, int* d,
                          int* npiv, int* rhs, int* state, cudaStream_t s) {
  constexpr int n = 32 * W;
  const size_t smem = 4 * static_cast<size_t>(n) * W * sizeof(u32);
  auto kernel = semi_inverse_gf2_kernel<W>;
  static bool opted_in = false;  // once per W
  if (!opted_in) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    opted_in = true;
  }
  kernel<<<1, n, smem, s>>>(grams, check, winv, d, npiv, rhs, state);
  return cudaGetLastError();
}

extern "C" int semi_inverse_gf2(const int* grams, int n, int check, int* winv,
                                int* d, int* npiv, int* rhs, int* state,
                                void* stream) {
  if (n < 32 || n > GF2_MAXN || n % 32 != 0) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
#define SI2_CALL(w) \
  return static_cast<int>(launch<w>(grams, check, winv, d, npiv, rhs, state, s))
  GF2_SWITCH_W(n / 32, SI2_CALL)
#undef SI2_CALL
}
