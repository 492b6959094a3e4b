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
// into itself, in M and in W.  Over GF(2) no row is normalised.  On a GPU:
//   * One thread per row of M and W.  A thread keeps its rows in registers
//     (W = n / 32 words each, a template parameter) and mirrors them to
//     shared memory after each change, where the pivot row is read.  Rows
//     never move: each thread keeps its row's logical position `pos` in a
//     register, and a swap of logical rows j and i changes two threads'
//     pos, which every thread works out from (j, i) itself.
//   * The pivot is a block-wide min over the candidates' keys
//     (pos << 10 | row): __reduce_min_sync in each warp, the W warp minima
//     in shared memory (double-buffered by step), one barrier per step.  The
//     key gives the pivot's logical index and its physical row together.
//   * A step writes only the threads' own rows; the pivot row is read by
//     all and written by none, so the step's one barrier orders it all.
// Phase 1 needs only which columns pivot (d1), so it tracks no W.  The
// checks and the right-hand side then run a thread per output row:
// transposes by 32 broadcast loads per word, the two n x n products by
// masked XORs of broadcast rows.
//
// What bounds it on an H100: the dependent chain, not bytes or operations.
// 2n pivot steps run one after another, each a warp reduction, a barrier,
// a read of the warp minima and the row update; then the checks and
// c = winv * spliced, n * W masked word XORs per thread.
#include "gf2.cuh"

#define SI2_NO_PIVOT 0x7fffffff

struct Si2Shared {
  int red[2][GF2_MAXW];  // warp minima of the pivot keys, by step parity
  u32 d1[GF2_MAXN];      // phase 1's pivot columns
  u32 d[GF2_MAXN];       // phase 2's
  u32 cm[GF2_MAXW];      // column mask: of d1, then of d
  int ok;
};

template <int W>
__device__ __forceinline__ void xor_row(u32 (&a)[W], const u32* row) {
  u32 b[W];
  load_row<W>(row, b);
#pragma unroll
  for (int q = 0; q < W; ++q) a[q] ^= b[q];
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
      const bool bit = (m[jw] >> b) & 1u;
      const int key = bit && pos >= j ? (pos << 10) | t : SI2_NO_PIVOT;
      const int wmin = __reduce_min_sync(GF2_FULL_MASK, key);
      if (lane == 0) s.red[b & 1][warp] = wmin;
      __syncthreads();
      int k = s.red[b & 1][0];
#pragma unroll
      for (int q = 1; q < W; ++q) k = min(k, s.red[b & 1][q]);
      if (t == 0) d[j] = k != SI2_NO_PIVOT;
      if (k == SI2_NO_PIVOT) continue;  // uniform: nothing is written
      const int piv = k >> 10, P = k & 1023;
      ++npiv;
      if (pos == piv)
        pos = j;
      else if (pos == j)
        pos = piv;
      if (bit && t != P) {
        xor_row<W>(m, Ms + P * W);
        store_row<W>(Ms + t * W, m);
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
  u32* U = dyn;          // vtAv
  u32* UA = U + n * W;   // vtAAv
  u32* Ms = UA + n * W;  // M's rows; after phase 2, winv in logical order
  u32* Ws = Ms + n * W;  // phase 2's W rows; then the spliced rows
  const int frozen = t == 0 ? state[3] : 0;  // read early, used at the end

  // phase 1: find the pivotable column set d1 (W is not tracked)
  u32 u[W], m[W], w[W];
#pragma unroll
  for (int q = 0; q < W; ++q) {
    u[q] = static_cast<u32>(__ldg(grams + t * W + q));
    m[q] = u[q];
    w[q] = static_cast<u32>(__ldg(grams + (n + t) * W + q));
  }
  store_row<W>(U + t * W, u);
  store_row<W>(UA + t * W, w);
  store_row<W>(Ms + t * W, m);
  if (t == 0) s.ok = 1;
  __syncthreads();
  int pos;
  eliminate<W, false>(m, w, Ms, Ws, s, s.d1, pos);
  // phase 2: re-eliminate U masked by d1 (rows and columns) from eye * d1
  const u32 m1 = __ballot_sync(GF2_FULL_MASK, s.d1[t] != 0);  // word `warp`
  if (lane == 0) s.cm[warp] = m1;
  __syncthreads();
  const bool keep = s.d1[t] != 0;
#pragma unroll
  for (int q = 0; q < W; ++q) {
    m[q] = keep ? u[q] & s.cm[q] : 0u;
    w[q] = keep && q == warp ? 1u << lane : 0u;
  }
  store_row<W>(Ms + t * W, m);
  store_row<W>(Ws + t * W, w);
  __syncthreads();
  const int npiv = eliminate<W, true>(m, w, Ms, Ws, s, s.d, pos);
  const u32 m2 = __ballot_sync(GF2_FULL_MASK, s.d[t] != 0);
  if (lane == 0) s.cm[warp] = m2;
  __syncthreads();
  u32 cm[W];
#pragma unroll
  for (int q = 0; q < W; ++q) cm[q] = s.cm[q];
  // winv in logical order into Ms; the spliced rows of t into Ws
  store_row<W>(Ms + pos * W, w);
  {
    u32 ua[W], sp[W];
    load_row<W>(UA + t * W, ua);
#pragma unroll
    for (int q = 0; q < W; ++q) sp[q] = (ua[q] & cm[q]) | (u[q] & ~cm[q]);
    store_row<W>(Ws + t * W, sp);
  }
  __syncthreads();

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
      ok &= transposed_word<W>(UA, i, q) == UA[i * W + q];
      ok &= transposed_word<W>(Ms, i, q) == wi[q];
    }
  }
  d_out[i] = di ? 1 : 0;
  if (!ok) atomicAnd(&s.ok, 0);
  __syncthreads();
  if (t == 0) {
    npiv_out[0] = npiv;
    if (!frozen) {
      state[0] = npiv == 0;
      state[1] = check ? s.ok : 1;
    }
  }
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
