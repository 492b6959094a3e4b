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
// header gives the argument): logical rows map to physical rows, and no row
// is normalised: each physical row holds a nonzero multiple of the true
// row, the step being R_q <- a R_q - M[q, j] R_P for q != P; the scales are
// products of pivots (pref), and one inverse of their product per launch
// undoes them.  What changes for p < 2^62 is the arithmetic: M and W are
// held in Montgomery form (x~ = x 2^64 mod p; modp64.cuh), where zero stays
// zero (every pivot search sees what the reference sees) and a row update
// is ONE reduction: a~ m~ + nb~ mP~ < 2 p^2 < p 2^64, so redc(a~ m~ + nb~
// mP~) = (a m + nb mP)~.  Two layouts of the elimination:
//   * n <= SIW_REG_MAX_N (the main path's n = 4; one warp): M and W live in
//     registers, lane l < n^2 holding entry (l / n, l % n) of each and the
//     logical position of its physical row.  A pivot search is one
//     __reduce_min_sync over (position, lane) keys of column j's nonzeros,
//     the pivot, M[q, j] and row P come by __shfl_sync, and a swap
//     exchanges two positions: no shared memory and no barrier in a step;
//   * above: M and W in shared memory, perm in registers (lane l holds
//     logical rows l and l + 32), every warp searching column j itself
//     (ballot, ffs, shuffles), thread t updating column t % n of rows t / n,
//     t / n + T / n, ... with its chains side by side (update_rows), and
//     ONE barrier a step.
// Both stage the Grams in shared memory first, for the checks' and the
// right-hand side's dot products.
// Phase 1 eliminates from W = I too: where it finds every pivot (a Gram of
// full rank, the usual case), phase 2's inputs (U masked by d1 x d1, W0 =
// diag(d1)) are phase 1's own, so its results are phase 2's and phase 2 is
// skipped.  The inverse of the pivots' product is Kaliski's binary almost
// inverse (modp64.cuh::mont_inverse: ~0.7 bitlen(p) branch-free steps of a
// subtraction, a count of trailing zeros and shifts, then one reduction by
// the power of two it leaves).  The check and the right-hand side are dot
// products of winv~'s rows (Montgomery) with the Grams' columns (standard):
// the lazy 128-bit sum reduced by reduce_mont is the standard residue of the
// sum itself.
//
// What bounds it on an H100: the dependent chain, as for the narrow kernel:
// 2n pivot steps (each at least a warp reduction and a dependent read, ~80
// cycles) and the inverse's steps, one after another.  Measured with
// -DSIW_TIMELINE and -DSIW_STEP_BENCH (utils/kernel_sweeps.py; PERF.md) on
// an H100 80GB HBM3 at 700 W: the inverse ~5,500-5,950 cycles, 42-46 steps
// of ~130 (one thread's ~35 dependent instructions a step; the step alone
// 124.8 cycles); a pivot step in
// registers at n = 4 ~920 cycles (search ~350, update ~400), at n = 32
// ~3,000 (the update ~2,300: the IMADs of two 64 x 64 -> 128-bit products
// and a REDC an entry, issue-bound); the check and right-hand side ~50,000
// of ~159,000 cycles at n = 32.
#include "modp64.cuh"

#define SIW_MAXN 64
#define SIW_MAX_WARPS 16  // see siw_warps
#define SIW_LD(n) ((n) | 1)
#define FULL_MASK 0xffffffffu
// n up to which the elimination runs in one warp's registers (n^2 <= 32;
// utils/kernel_sweeps.py builds -DSIW_REG_MAX_N=0 to time the shared-memory
// elimination there; PERF.md)
#ifndef SIW_REG_MAX_N
#define SIW_REG_MAX_N 4
#endif
#if SIW_REG_MAX_N < 0 || SIW_REG_MAX_N > 4
#error "semi_inverse_wide: the register elimination takes n <= 4 (one warp)"
#endif

// Design measurement only: built with -DSIW_TIMELINE (utils/kernel_sweeps.py),
// thread 0 records clock64() at fixed slots of siw_stamps, which
// semi_inverse_wide_stamps copies to the host.  Slots: the end of each
// phase (SIW_T_*, and %globaltimer in ns at the kernel's start and end), the
// start and end of the inverse (thread 0 computes it) and its step count,
// the start of each pivot step of phase 1 (SIW_T_STEP1 + j) and phase 2
// (SIW_T_STEP2 + j, when it runs), and for phase 1's first SIW_T_NSUB
// steps the end of each part of the step (SIW_T_SUB + 4 j + k: search,
// swap, update, barrier).
#ifdef SIW_TIMELINE
enum {
  SIW_T_START, SIW_T_LOADED, SIW_T_PHASE1, SIW_T_P2INIT, SIW_T_PHASE2,
  SIW_T_SIG, SIW_T_WINV, SIW_T_CHECK, SIW_T_END, SIW_T_NS_START,
  SIW_T_NS_END, SIW_T_INV_START, SIW_T_INV_END, SIW_T_INV_STEPS,
  SIW_T_STEP1 = 16, SIW_T_STEP2 = SIW_T_STEP1 + SIW_MAXN,
  SIW_T_SUB = SIW_T_STEP2 + SIW_MAXN, SIW_T_NSUB = 3,
  SIW_T_SLOTS = SIW_T_SUB + 4 * SIW_T_NSUB
};
__device__ long long siw_stamps[SIW_T_SLOTS];
#define SIW_STAMP(slot) \
  if (threadIdx.x == 0) siw_stamps[slot] = clock64()
// part k of pivot step j, in phase 1 only
#define SIW_STAMP_PART(j, k) \
  if (phase == 1 && (j) < SIW_T_NSUB) SIW_STAMP(SIW_T_SUB + 4 * (j) + (k))
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
#define SIW_STAMP_PART(j, k)
#endif

// Design measurement only: built with -DSIW_STEP_BENCH
// (utils/kernel_sweeps.py), one thread runs almost_inverse on `count`
// residues one after another, clock64() around each, and reports the
// cycles and the steps they took (out[0], out[1]; out[2] keeps the
// results live): the latency of one dependent step of the inverse, which
// chip_smoke.py's bound of this kernel takes, measured apart from it.
#ifdef SIW_STEP_BENCH
__global__ void siw_step_bench_kernel(const u64* __restrict__ a, int count,
                                      u64 p, long long* out) {
  long long cycles = 0, steps = 0;
  u64 sink = 0;
  for (int i = 0; i < count; ++i) {
    const u64 x = a[i];
    int k, n;
    const long long t0 = clock64();
    const u64 y = almost_inverse(x, p, k, n);
    sink ^= y;
    const long long t1 = clock64();
    cycles += t1 - t0;
    steps += n;
  }
  out[0] = cycles;
  out[1] = steps;
  out[2] = static_cast<long long>(sink);
}
extern "C" int semi_inverse_wide_step_bench(const u64* a, int count,
                                            unsigned long long p,
                                            long long* out) {
  siw_step_bench_kernel<<<1, 1>>>(a, count, p, out);
  return static_cast<int>(cudaGetLastError());
}
#endif

// Dynamic shared memory, carved by n: the Grams G = [vtAv ; vtAAv] (2n x n
// u64, read once from global memory: the checks and the right-hand side
// read them again), M and W (n x SIW_LD(n) u64 each; after phase 2 M holds
// winv~, logical rows, stride n), pref (n + 1), sig (n) u64; perm (n) int;
// d1, d (n) u32; ok.  130 KB at n = 64, so it is dynamic.
struct SiwLayout {
  u64 *G, *M, *W, *pref, *sig;
  int* perm;
  u32 *d1, *d;
  int* ok;
};

__host__ __device__ inline size_t siw_smem_bytes(int n) {
  const size_t ld = SIW_LD(n);
  return (2 * n * n + 2 * n * ld + (n + 1) + n) * sizeof(u64) +
         n * sizeof(int) + 2 * n * sizeof(u32) + sizeof(int);
}

__device__ inline SiwLayout siw_layout(unsigned char* base, int n) {
  SiwLayout s;
  const int ld = SIW_LD(n);
  s.G = reinterpret_cast<u64*>(base);
  s.M = s.G + 2 * n * n;
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

// A thread's part of a pivot step: rows q0, q0 + rstride, ... (G at a
// time) of column cw.  All of a group's loads come before its stores, and
// every update is computed whether or not its row needs it (the stores
// alone are predicated), so the compiler interleaves the 2G independent
// product-and-REDC chains of M and W instead of running them one by one.
template <int G>
__device__ __forceinline__ void update_rows(SiwLayout& s, int n,
                                            const WideField& f, int j, int P,
                                            u64 a, u64 mP, u64 wP, int q0,
                                            int rstride, int cw) {
  const int ld = SIW_LD(n);
  for (int q = q0; q < n; q += G * rstride) {
    u64 b[G], m[G], w[G], om[G], ow[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int r = q + g * rstride;
      b[g] = r < n ? s.M[r * ld + j] : 0ull;
      m[g] = r < n && cw > j ? s.M[r * ld + cw] : 0ull;
      w[g] = r < n ? s.W[r * ld + cw] : 0ull;
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const u64 nb = f.p - b[g];  // -M[r, j], in (0, p]
      U128 t = {0, 0};
      mac128(t, a, m[g]);
      mac128(t, nb, mP);
      om[g] = redc(t.hi, t.lo, f);
      U128 t2 = {0, 0};
      mac128(t2, a, w[g]);
      mac128(t2, nb, wP);
      ow[g] = redc(t2.hi, t2.lo, f);
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const int r = q + g * rstride;
      if (r < n && r != P) {
        if (cw > j) s.M[r * ld + cw] = om[g];
        s.W[r * ld + cw] = ow[g];
      }
    }
  }
}

// One Gauss-Jordan sweep over the columns on the row-scaled, row-permuted
// Montgomery representation, from M (and W) as the block sees them, with
// perm = identity.  Writes d, pref and the final perm and returns the
// number of pivots (phase 1 or 2 names the timeline's slots).  Every thread
// of the block calls it; it ends with a barrier.
__device__ __noinline__ int eliminate(SiwLayout s, int n,
                                      const WideField f, u32* d, int phase) {
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31;
  const int rstride = T / n;  // T >= n (checked by the entry point)
  const bool active = tid < rstride * n;
  const int cw = tid % n, q0 = tid / n, ld = SIW_LD(n);
  const int rows = (n + rstride - 1) / rstride;  // rows a thread updates
  int perm_lo = lane, perm_hi = lane + 32;
  int npiv = 0;
  u64 pref = mont_mul(1, f.r2, f);  // the form of 1
  for (int j = 0; j < n; ++j) {
    SIW_STAMP((phase == 1 ? SIW_T_STEP1 : SIW_T_STEP2) + j);
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
    SIW_STAMP_PART(j, 0);
    if (tid == 0) {
      d[j] = piv >= 0;
      s.pref[j] = pref;
    }
    if (piv < 0) continue;  // uniform: nothing is written, no barrier
    // swap logical rows j and piv: perm[j] = P, perm[piv] = old perm[j]
    const int pj = j < 32 ? __shfl_sync(FULL_MASK, perm_lo, j)
                          : __shfl_sync(FULL_MASK, perm_hi, j - 32);
    if (lane == (j & 31)) (j < 32 ? perm_lo : perm_hi) = P;
    if (lane == (piv & 31)) (piv < 32 ? perm_lo : perm_hi) = pj;
    SIW_STAMP_PART(j, 1);
    if (active) {
      // R_r <- a R_r - M[r, j] R_P for the thread's rows r != P, in column
      // cw: a~ m~ + nb~ mP~ < 2 p^2 < p 2^64, one REDC each
      const u64 mP = cw > j ? s.M[P * ld + cw] : 0ull;
      const u64 wP = s.W[P * ld + cw];
      if (rows == 1)
        update_rows<1>(s, n, f, j, P, a, mP, wP, q0, rstride, cw);
      else if (rows == 2)
        update_rows<2>(s, n, f, j, P, a, mP, wP, q0, rstride, cw);
      else
        update_rows<4>(s, n, f, j, P, a, mP, wP, q0, rstride, cw);
    }
    pref = mont_mul(pref, a, f);
    npiv += 1;
    SIW_STAMP_PART(j, 2);
    block_sync();
    SIW_STAMP_PART(j, 3);
  }
  if (tid < 32) {
    if (tid == 0) s.pref[n] = pref;
    if (lane < n) s.perm[lane] = perm_lo;
    if (lane + 32 < n) s.perm[lane + 32] = perm_hi;
  }
  block_sync();
  return npiv;
}

// The same sweep for n <= SIW_REG_MAX_N on one warp, M and W in registers
// (m, w of lane l < n^2: entry (q, c) = (l / n, l % n) of the physical
// rows; pos: the logical position of row q, from the identity).  Writes d,
// pref, the final perm and W (into shared memory, physical rows) for the
// epilogue; returns the number of pivots.  The pivot is the
// nonzero of column j at the least logical position >= j: the least key
// (pos << 5) | lane, so the one reduction also names its lane.
__device__ __noinline__ int eliminate_warp(SiwLayout s, int n,
                                           const WideField f, u32* d, u64 m,
                                           u64 w, int phase) {
  const int lane = threadIdx.x & 31, ld = SIW_LD(n);
  const bool in = lane < n * n;
  const int q = in ? lane / n : 0, c = in ? lane - q * n : 0;
  int pos = q, npiv = 0;
  u64 pref = mont_mul(1, f.r2, f);  // the form of 1
  for (int j = 0; j < n; ++j) {
    SIW_STAMP((phase == 1 ? SIW_T_STEP1 : SIW_T_STEP2) + j);
    const unsigned key = in && c == j && pos >= j && m != 0ull
                             ? static_cast<unsigned>(pos << 5 | lane)
                             : 0xffffffffu;
    const unsigned best = __reduce_min_sync(FULL_MASK, key);
    if (lane == 0) {
      d[j] = best != 0xffffffffu;
      s.pref[j] = pref;
    }
    if (best == 0xffffffffu) continue;  // uniform
    const int pl = best & 31, ppos = best >> 5, P = pl / n;
    const u64 a = __shfl_sync(FULL_MASK, m, pl);
    const u64 mq = __shfl_sync(FULL_MASK, m, q * n + j);  // M[q, j]
    const u64 mP = __shfl_sync(FULL_MASK, m, P * n + c);  // M[P, c]
    const u64 wP = __shfl_sync(FULL_MASK, w, P * n + c);
    SIW_STAMP_PART(j, 0);
    // swap logical rows j and ppos
    pos = q == P ? j : pos == j ? ppos : pos;
    SIW_STAMP_PART(j, 1);
    {  // both chains computed, kept by selects (no branch between them)
      const bool row = in && q != P;
      const u64 nb = f.p - mq;  // -M[q, j], in (0, p]
      U128 t = {0, 0};
      mac128(t, a, m);
      mac128(t, nb, mP);
      const u64 om = redc(t.hi, t.lo, f);
      U128 t2 = {0, 0};
      mac128(t2, a, w);
      mac128(t2, nb, wP);
      const u64 ow = redc(t2.hi, t2.lo, f);
      w = row ? ow : w;
      m = row && c > j ? om : m;
    }
    pref = mont_mul(pref, a, f);
    npiv += 1;
    SIW_STAMP_PART(j, 2);
    SIW_STAMP_PART(j, 3);  // no barrier
  }
  if (lane == 0) s.pref[n] = pref;
  if (in) {
    s.W[q * ld + c] = w;
    if (c == 0) s.perm[pos] = q;
  }
  __syncwarp();
  return npiv;
}

// sum_k am[k] * b[k * stride] over k < n, am in Montgomery form and b
// standard, both in shared memory: the standard residue of the sum
// (reduce_mont), folded every WIDE_FOLD terms; a fold's WIDE_FOLD products
// are formed side by side.
__device__ __forceinline__ u64 dot_mont(const u64* am, const u64* b,
                                        int stride, int n,
                                        const WideField& f) {
  U128 acc = {0, 0};
  for (int k0 = 0; k0 < n; k0 += WIDE_FOLD) {
#pragma unroll
    for (int k = k0; k < k0 + WIDE_FOLD; ++k)
      if (k < n) mac128(acc, am[k], b[k * stride]);
    fold128(acc, f);
  }
  return reduce_mont(acc, f);
}

// REG: the one-warp register elimination (n <= SIW_REG_MAX_N), else the
// shared-memory one: two instantiations, each with only its elimination's
// code (and each elimination's code once: both phases call it), which a
// single warp then fetches from cold instruction caches in a solve.
template <bool REG>
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
  const u64* vtAv = s.G;  // the Grams, staged in shared memory
  const u64* vtAAv = s.G + nn;
  const int ld = SIW_LD(n);
  const int frozen = tid == 0 ? state[3] : 0;  // read early, used at the end
#ifdef SIW_TIMELINE
  if (tid == 0) siw_stamps[SIW_T_NS_START] = globaltimer_ns();
#endif
  SIW_STAMP(SIW_T_START);
  for (int e = tid; e < 2 * nn; e += T) s.G[e] = __ldg(grams + e);
  block_sync();

  // phase 1: eliminate M~ = U R from W~ = I R, which finds the pivotable
  // column set d1; phase 2: re-eliminate the d1-masked matrix from W0 =
  // eye * d1.  When every column pivots (the usual case), phase 2's inputs
  // are phase 1's own, so phase 1's results are phase 2's and it is
  // skipped.
  const u64 one = mont_mul(1, f.r2, f);
  int npiv;
  if (REG) {  // one warp: lane e holds entry e of M and W
    const int i = tid / n, c = tid - i * n;
    const bool in = tid < nn;
    const u64 m = in ? mont_mul(vtAv[tid], f.r2, f) : 0ull;
    if (tid == 0) *s.ok = 1;
    SIW_STAMP(SIW_T_LOADED);
    npiv = eliminate_warp(s, n, f, s.d1, m, in && i == c ? one : 0ull, 1);
    SIW_STAMP(SIW_T_PHASE1);
    SIW_STAMP(SIW_T_P2INIT);
    if (npiv == n) {
      s.d = s.d1;  // uniform: phase 2 is phase 1
    } else {
      const u64 m2 = in && s.d1[i] && s.d1[c] ? m : 0ull;
      const u64 w2 = in && i == c && s.d1[c] ? one : 0ull;
      npiv = eliminate_warp(s, n, f, s.d, m2, w2, 2);
    }
  } else {
    for (int e = tid; e < nn; e += T) {
      const int i = e / n, c = e - i * n;
      s.M[i * ld + c] = mont_mul(vtAv[e], f.r2, f);
      s.W[i * ld + c] = i == c ? one : 0ull;
    }
    if (tid == 0) *s.ok = 1;
    block_sync();
    SIW_STAMP(SIW_T_LOADED);
    npiv = eliminate(s, n, f, s.d1, 1);
    SIW_STAMP(SIW_T_PHASE1);
    const bool full = npiv == n;  // uniform
    if (full) {
      s.d = s.d1;  // phase 2 is phase 1
    } else {
      for (int e = tid; e < nn; e += T) {
        const int i = e / n, c = e - i * n;
        s.M[i * ld + c] = (s.d1[i] && s.d1[c])
                              ? mont_mul(vtAv[e], f.r2, f) : 0ull;
        s.W[i * ld + c] = (i == c && s.d1[c]) ? one : 0ull;
      }
      block_sync();
    }
    SIW_STAMP(SIW_T_P2INIT);
    if (!full) npiv = eliminate(s, n, f, s.d, 2);
  }
  SIW_STAMP(SIW_T_PHASE2);

  // undo the row scales: winv~[i, :] = W~[perm[i], :] / lambda_i, into M
  // (logical rows, stride n)
  if (tid < n) {
    SIW_STAMP(SIW_T_INV_START);
    int steps;
    const u64 inv_a = mont_inverse(s.pref[n], f, steps);
    SIW_STAMP(SIW_T_INV_END);
#ifdef SIW_TIMELINE
    if (tid == 0) siw_stamps[SIW_T_INV_STEPS] = steps;
#endif
    s.sig[tid] = s.d[tid] ? mont_mul(s.pref[tid], inv_a, f) : inv_a;
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
      ok &= vtAv[e] == vtAv[et];
      ok &= vtAAv[e] == vtAAv[et];
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
      const u64 g = vtAv[(R - n) * n + C];
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
        semi_inverse_wide_kernel<false>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(siw_smem_bytes(SIW_MAXN)));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const size_t smem = siw_smem_bytes(n);
  const auto kernel = n <= SIW_REG_MAX_N ? semi_inverse_wide_kernel<true>
                                         : semi_inverse_wide_kernel<false>;
  kernel<<<1, 32 * warps, smem, static_cast<cudaStream_t>(stream)>>>(
      grams, n, WideField{p, mu, pinv, r2}, check, winv, d, npiv, rhs, state);
  return static_cast<int>(cudaGetLastError());
}
