// semi_inverse_wide — the n x n two-phase Gauss-Jordan "semi-inverse" of
// the Gram matrix for wide primes (p < 2^62), the fused invariant checks and
// the orthogonalize right-hand side, in one CTA, on u64 residues.
//
// Replaces, in the JAX package, ops/wide_ops.py::semi_inverse_device (with
// _eliminate_device: a fori_loop of masked one-hot row swaps on uint32
// pairs and a Fermat inverse per pivot, gfp_wide.py::modinv_device),
// models/lanczos_wide.py::check_invariants_device, and the n x n prologue
// of models/lanczos_wide.py::orthogonalize_device (c = -winv * where(d,
// vtAAv, vtAv), vtAvd = where(d, -vtAv, 0)).  ops/wide_ops.py::
// semi_inverse_py is the host oracle of the elimination.
//
// Input grams (2n, n) = [vtAv ; vtAAv], standard residues.  Outputs: winv
// (n, n), d (n), npiv (1), rhs (2n, 2n) = [[c, winv], [vtAvd, 0]], all
// standard residues, and the solver's latched flags in state = [stop,
// inv_ok, k_done, frozen]: stop = (npiv == 0) and inv_ok (1 when check ==
// 0) are written unless the state is frozen (an earlier iteration halted).
//
// The elimination is the narrow semi_inverse.cu's, step for step (its
// header gives the argument): logical rows map to physical rows of shared
// memory through perm (held in registers, lane l holds rows l and l + 32),
// and no row is normalised: each physical row holds a nonzero multiple of
// the true row, the step being R_q <- a R_q - M[q, j] R_P for q != P; the
// scales are products of pivots (pref), and one inverse of their product
// per launch undoes them.  What changes for p < 2^62 is the arithmetic: M
// and W are held in Montgomery form (x~ = x 2^64 mod p; modp64.cuh), where
// zero stays zero (every pivot search sees what the reference sees) and a
// row update is ONE reduction: a~ m~ + nb~ mP~ < 2 p^2 < p 2^64, so
// redc(a~ m~ + nb~ mP~) = (a m + nb mP)~.  The inverse is a Fermat chain of
// Montgomery products (inv_mont, ~124 for a 62-bit p).  The check and the
// right-hand side are dot products of winv~'s rows (Montgomery) with the
// Grams' columns (standard): the lazy 128-bit sum reduced by reduce_mont
// is the standard residue of the sum itself.  Shared memory holds two
// n x (n | 1) u64 matrices: 66 KB at n = 64, so it is dynamic.
//
// What bounds it on an H100: the dependent chain, as for the narrow kernel
// (2n pivot steps, each a barrier, a ballot search, the register swap and
// the row update), plus the Fermat inverse: ~120 Montgomery products, 61
// of them (the squarings, for p = 2^61 - 1) one after another.  Measured
// with -DSIW_TIMELINE (utils/kernel_sweeps.py; PERF.md) on an H100 80GB
// HBM3 at 700 W: the inverse ~15,470 cycles at every n (~254 a bit of the
// exponent), about half of the launch at n = 4, and a pivot step ~940 /
// 1,360 cycles (phase 1 / 2) at n = 4.
#include "modp64.cuh"

#define SIW_MAXN 64
#define SIW_GROUP 4  // rows a thread loads before it stores (ILP)
#define SIW_MAX_WARPS 16  // see siw_warps
#define SIW_LD(n) ((n) | 1)
#define FULL_MASK 0xffffffffu

// Design measurement only: built with -DSIW_TIMELINE (utils/kernel_sweeps.py),
// thread 0 records clock64() at fixed slots of siw_stamps, which
// semi_inverse_wide_stamps copies to the host.  Slots: the end of each
// phase (SIW_T_*, and %globaltimer in ns at the kernel's start and end), the
// start and end of the Fermat inverse (thread 0 computes it), and the start
// of each pivot step of phase 1 (SIW_T_STEP1 + j) and phase 2 (SIW_T_STEP2
// + j).
#ifdef SIW_TIMELINE
enum {
  SIW_T_START, SIW_T_LOADED, SIW_T_PHASE1, SIW_T_P2INIT, SIW_T_PHASE2,
  SIW_T_SIG, SIW_T_WINV, SIW_T_CHECK, SIW_T_END, SIW_T_NS_START,
  SIW_T_NS_END, SIW_T_INV_START, SIW_T_INV_END,
  SIW_T_STEP1 = 16, SIW_T_STEP2 = SIW_T_STEP1 + SIW_MAXN,
  SIW_T_SLOTS = SIW_T_STEP2 + SIW_MAXN
};
__device__ long long siw_stamps[SIW_T_SLOTS];
#define SIW_STAMP(slot) \
  if (threadIdx.x == 0) siw_stamps[slot] = clock64()
__device__ __forceinline__ long long globaltimer_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int semi_inverse_wide_stamps(long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, siw_stamps, sizeof(siw_stamps)));
}
#else
#define SIW_STAMP(slot)
#endif

// Dynamic shared memory, carved by n: M and W (n x SIW_LD(n) u64 each; after
// phase 2 M holds winv~, logical rows, stride n), pref (n + 1), sig (n) u64;
// perm (n) int; d1, d (n) u32; ok.
struct SiwLayout {
  u64 *M, *W, *pref, *sig;
  int* perm;
  u32 *d1, *d;
  int* ok;
};

__host__ __device__ inline size_t siw_smem_bytes(int n) {
  const size_t ld = SIW_LD(n);
  return (2 * n * ld + (n + 1) + n) * sizeof(u64) + n * sizeof(int) +
         2 * n * sizeof(u32) + sizeof(int);
}

__device__ inline SiwLayout siw_layout(unsigned char* base, int n) {
  SiwLayout s;
  const int ld = SIW_LD(n);
  s.M = reinterpret_cast<u64*>(base);
  s.W = s.M + n * ld;
  s.pref = s.W + n * ld;
  s.sig = s.pref + n + 1;
  s.perm = reinterpret_cast<int*>(s.sig + n);
  s.d1 = reinterpret_cast<u32*>(s.perm + n);
  s.d = s.d1 + n;
  s.ok = reinterpret_cast<int*>(s.d + n);
  return s;
}

__device__ __forceinline__ void block_sync() {
  if (blockDim.x == 32)
    __syncwarp();
  else
    __syncthreads();
}

// One Gauss-Jordan sweep over the columns on the row-scaled, row-permuted
// Montgomery representation, from M (and W) as the block sees them, with
// perm = identity.  Writes d (and, with W, pref and the final perm) and
// returns the number of pivots.  Every thread of the block calls it; it ends
// with a barrier.
template <bool WITH_W>
__device__ int eliminate(SiwLayout& s, int n, const WideField& f, u32* d) {
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31;
  const int rstride = T / n;  // T >= n (checked by the entry point)
  const bool active = tid < rstride * n;
  const int cw = tid % n, q0 = tid / n, ld = SIW_LD(n);
  int perm_lo = lane, perm_hi = lane + 32;
  int npiv = 0;
  u64 pref = mont_mul(1, f.r2, f);  // the form of 1
  for (int j = 0; j < n; ++j) {
    SIW_STAMP((WITH_W ? SIW_T_STEP2 : SIW_T_STEP1) + j);
    // first logical row i >= j with M[perm[i], j] != 0: its index piv, its
    // physical row P and the pivot a~, found by every warp on its own
    int piv = -1, P = 0;
    u64 a = 0;
    if (j < 32) {
      const u64 m = lane >= j && lane < n ? s.M[perm_lo * ld + j] : 0ull;
      const unsigned mask = __ballot_sync(FULL_MASK, m != 0ull);
      if (mask) {
        piv = __ffs(mask) - 1;
        a = __shfl_sync(FULL_MASK, m, piv);
        P = __shfl_sync(FULL_MASK, perm_lo, piv);
      }
    }
    if (piv < 0 && n > 32) {
      const int i = lane + 32;
      const u64 m = i >= j && i < n ? s.M[perm_hi * ld + j] : 0ull;
      const unsigned mask = __ballot_sync(FULL_MASK, m != 0ull);
      if (mask) {
        const int l = __ffs(mask) - 1;
        piv = 32 + l;
        a = __shfl_sync(FULL_MASK, m, l);
        P = __shfl_sync(FULL_MASK, perm_hi, l);
      }
    }
    if (tid == 0) {
      d[j] = piv >= 0;
      if (WITH_W) s.pref[j] = pref;
    }
    if (piv < 0) continue;  // uniform: nothing is written, no barrier
    // swap logical rows j and piv: perm[j] = P, perm[piv] = old perm[j]
    const int pj = j < 32 ? __shfl_sync(FULL_MASK, perm_lo, j)
                          : __shfl_sync(FULL_MASK, perm_hi, j - 32);
    if (lane == (j & 31)) (j < 32 ? perm_lo : perm_hi) = P;
    if (lane == (piv & 31)) (piv < 32 ? perm_lo : perm_hi) = pj;
    if (active) {
      // R_r <- a R_r - M[r, j] R_P for the thread's rows r != P, in column
      // cw: a~ m~ + nb~ mP~ < 2 p^2 < p 2^64, one REDC each.  A group's
      // loads all come before its stores, so they overlap.
      const u64 mP = cw > j ? s.M[P * ld + cw] : 0ull;
      const u64 wP = WITH_W ? s.W[P * ld + cw] : 0ull;
      for (int q = q0; q < n; q += SIW_GROUP * rstride) {
        u64 b[SIW_GROUP], m[SIW_GROUP], w[SIW_GROUP];
#pragma unroll
        for (int g = 0; g < SIW_GROUP; ++g) {
          const int r = q + g * rstride;
          b[g] = r < n ? s.M[r * ld + j] : 0ull;
          m[g] = r < n && cw > j ? s.M[r * ld + cw] : 0ull;
          w[g] = r < n && WITH_W ? s.W[r * ld + cw] : 0ull;
        }
#pragma unroll
        for (int g = 0; g < SIW_GROUP; ++g) {
          const int r = q + g * rstride;
          if (r >= n || r == P) continue;
          const u64 nb = f.p - b[g];  // -M[r, j], in (0, p]
          if (cw > j) {
            U128 t = {0, 0};
            mac128(t, a, m[g]);
            mac128(t, nb, mP);
            s.M[r * ld + cw] = redc(t.hi, t.lo, f);
          }
          if (WITH_W) {
            U128 t = {0, 0};
            mac128(t, a, w[g]);
            mac128(t, nb, wP);
            s.W[r * ld + cw] = redc(t.hi, t.lo, f);
          }
        }
      }
    }
    if (WITH_W) pref = mont_mul(pref, a, f);
    npiv += 1;
    block_sync();
  }
  if (WITH_W && tid < 32) {
    if (tid == 0) s.pref[n] = pref;
    if (lane < n) s.perm[lane] = perm_lo;
    if (lane + 32 < n) s.perm[lane + 32] = perm_hi;
  }
  block_sync();
  return npiv;
}

// sum_k am[k] * b[k * stride] over k < n, am in Montgomery form and b
// standard: the standard residue of the sum (reduce_mont), folded every
// WIDE_FOLD terms.
__device__ __forceinline__ u64 dot_mont(const u64* am, const u64* b,
                                        int stride, int n,
                                        const WideField& f) {
  U128 acc = {0, 0};
  for (int k = 0; k < n; ++k) {
    mac128(acc, am[k], __ldg(b + k * stride));
    if ((k & (WIDE_FOLD - 1)) == WIDE_FOLD - 1) fold128(acc, f);
  }
  return reduce_mont(acc, f);
}

__global__ void __launch_bounds__(32 * SIW_MAX_WARPS)
    semi_inverse_wide_kernel(const u64* __restrict__ grams, int n,
                                         WideField f, int check,
                                         u64* __restrict__ winv,
                                         int* __restrict__ d_out,
                                         int* __restrict__ npiv_out,
                                         u64* __restrict__ rhs,
                                         int* __restrict__ state) {
  extern __shared__ __align__(16) unsigned char siw_smem[];
  SiwLayout s = siw_layout(siw_smem, n);
  const int tid = threadIdx.x, T = blockDim.x;
  const int nn = n * n;
  const u64* vtAv = grams;
  const u64* vtAAv = grams + nn;
  const int ld = SIW_LD(n);
  const int frozen = tid == 0 ? state[3] : 0;  // read early, used at the end
#ifdef SIW_TIMELINE
  if (tid == 0) siw_stamps[SIW_T_NS_START] = globaltimer_ns();
#endif
  SIW_STAMP(SIW_T_START);

  // phase 1: find the pivotable column set d1 (W is not tracked); M~ = U R
  for (int e = tid; e < nn; e += T) {
    const int i = e / n, c = e - i * n;
    s.M[i * ld + c] = mont_mul(__ldg(vtAv + e), f.r2, f);
  }
  block_sync();
  SIW_STAMP(SIW_T_LOADED);
  eliminate<false>(s, n, f, s.d1);
  SIW_STAMP(SIW_T_PHASE1);
  // phase 2: re-eliminate the d1-masked matrix from W0 = eye * d1
  const u64 one = mont_mul(1, f.r2, f);
  for (int e = tid; e < nn; e += T) {
    const int i = e / n, c = e - i * n;
    s.M[i * ld + c] = (s.d1[i] && s.d1[c]) ? mont_mul(__ldg(vtAv + e), f.r2, f)
                                           : 0ull;
    s.W[i * ld + c] = (i == c && s.d1[c]) ? one : 0ull;
  }
  if (tid == 0) *s.ok = 1;
  block_sync();
  SIW_STAMP(SIW_T_P2INIT);
  const int npiv = eliminate<true>(s, n, f, s.d);
  SIW_STAMP(SIW_T_PHASE2);

  // undo the row scales: winv~[i, :] = W~[perm[i], :] / lambda_i, into M
  // (logical rows, stride n)
  if (tid < n) {
    SIW_STAMP(SIW_T_INV_START);
    const u64 inv_a = inv_mont(s.pref[n], f);
    s.sig[tid] = s.d[tid] ? mont_mul(s.pref[tid], inv_a, f) : inv_a;
    SIW_STAMP(SIW_T_INV_END);
  }
  block_sync();
  SIW_STAMP(SIW_T_SIG);
  // M is dead after phase 2: it takes winv~ (logical rows, stride n)
  for (int e = tid; e < nn; e += T) {
    const int i = e / n, c = e - i * n;
    const u64 wm = mont_mul(s.W[s.perm[i] * ld + c], s.sig[i], f);
    s.M[e] = wm;
    winv[e] = redc(0, wm, f);
  }
  block_sync();
  SIW_STAMP(SIW_T_WINV);
  const u64* W = s.M;  // winv~

  // fused invariants (models/lanczos_wide.py::check_invariants_device):
  // symmetry of vtAv, vtAAv, winv; winv[i,c] != 0 => d_i or d_c;
  // winv * where(d, vtAv, 0) == diag(d)
  if (check) {
    int ok = 1;
    for (int e = tid; e < nn; e += T) {
      const int i = e / n, c = e - i * n;
      const int et = c * n + i;
      ok &= __ldg(vtAv + e) == __ldg(vtAv + et);
      ok &= __ldg(vtAAv + e) == __ldg(vtAAv + et);
      ok &= W[e] == W[et];
      ok &= (W[e] == 0ull) || s.d[i] || s.d[c];
      const u64 acc = s.d[c] ? dot_mont(W + i * n, vtAv + c, n, n, f) : 0ull;
      ok &= acc == ((i == c) ? static_cast<u64>(s.d[c]) : 0ull);
    }
    if (!ok) atomicAnd(s.ok, 0);
  }
  SIW_STAMP(SIW_T_CHECK);

  // right-hand side of the fused update [v | p] * rhs
  const int w = 2 * n;
  for (int e = tid; e < w * w; e += T) {
    const int R = e / w, C = e - R * w;
    u64 out = 0;
    if (R < n && C < n) {  // c = -(winv * where(d, vtAAv, vtAv))
      const u64 acc = dot_mont(W + R * n, (s.d[C] ? vtAAv : vtAv) + C, n, n, f);
      out = acc ? f.p - acc : 0ull;
    } else if (R < n) {
      out = redc(0, W[R * n + (C - n)], f);
    } else if (C < n && s.d[C]) {
      const u64 g = __ldg(vtAv + (R - n) * n + C);
      out = g ? f.p - g : 0ull;
    }
    rhs[e] = out;
  }
  for (int i = tid; i < n; i += T) d_out[i] = static_cast<int>(s.d[i]);
  block_sync();
  if (tid == 0) {
    npiv_out[0] = npiv;
    if (!frozen) {
      state[0] = npiv == 0;
      state[1] = check ? *s.ok : 1;
    }
  }
  SIW_STAMP(SIW_T_END);
#ifdef SIW_TIMELINE
  if (tid == 0) siw_stamps[SIW_T_NS_END] = globaltimer_ns();
#endif
}

// The CTA's size in warps for block width n: one warp up to n = 4 (its
// barriers are then __syncwarp), else n / 2, as the narrow kernel measured,
// up to SIW_MAX_WARPS: the u64 arithmetic takes ~100 registers a thread,
// and 32 warps of that ask for more than an SM's 65,536.
static int siw_warps(int n) {
  const int w = n <= 4 ? 1 : n / 2;
  return w < SIW_MAX_WARPS ? w : SIW_MAX_WARPS;
}

extern "C" int semi_inverse_wide(const u64* grams, int n, unsigned long long p,
                                 unsigned long long mu,
                                 unsigned long long pinv,
                                 unsigned long long r2, int check, u64* winv,
                                 int* d, int* npiv, u64* rhs, int* state,
                                 void* stream) {
  if (n < 1 || n > SIW_MAXN) return cudaErrorInvalidValue;
  const int warps = siw_warps(n);
  if (warps < 1 || warps > 32 || 32 * warps < n) return cudaErrorInvalidValue;
  static bool smem_set = false;  // the attribute, once for the widest n
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        semi_inverse_wide_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(siw_smem_bytes(SIW_MAXN)));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const size_t smem = siw_smem_bytes(n);
  semi_inverse_wide_kernel<<<1, 32 * warps, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      grams, n, WideField{p, mu, pinv, r2}, check, winv, d, npiv, rhs, state);
  return static_cast<int>(cudaGetLastError());
}
