// semi_inverse — the n x n two-phase Gauss-Jordan "semi-inverse" of the
// Gram matrix, the fused invariant checks and the orthogonalize right-hand
// side, in one CTA.
//
// Replaces, in the JAX package, ops/semi_inverse.py::semi_inverse_device
// (a fori_loop of masked one-hot row swaps), models/lanczos.py::
// check_invariants_device, and the n x n prologue of orthogonalize_device
// (c = -winv * where(d, vtAAv, vtAv), vtAvd = where(d, -vtAv, 0)).
//
// Input grams (2n, n) = [vtAv ; vtAAv].  Outputs: winv (n, n), d (n),
// npiv (1), rhs (2n, 2n) = [[c, winv], [vtAvd, 0]], and the solver's
// latched flags in state = [stop, inv_ok, k_done, frozen]: stop = (npiv == 0)
// and inv_ok (1 when check == 0) are written unless the state is frozen (an
// earlier iteration halted; see orthogonalize.cu).
//
// The elimination is the reference's, step for step: for column j the pivot
// is the first row i >= j with M[i, j] != 0; rows j and i swap in M and W;
// row j is normalised; every other row i subtracts M[i, j] (M's column after
// the swap) times row j, in M and in W.  Two changes of representation make
// it fast on a GPU and leave every output residue as it was:
//   * Rows are never moved.  perm maps logical rows to the physical rows of
//     shared memory, so a swap is an exchange of two perm entries; perm
//     lives in registers (lane l holds logical rows l and l + 32), the same
//     in every warp.
//   * No row is normalised.  Each physical row q holds lambda_q times the
//     true row, for a nonzero scale lambda_q.  With a = M[P, j] at the pivot
//     row P, the step is  R_q <- a * R_q - M[q, j] * R_P  for q != P, which
//     is the true update scaled by lambda_q * a; the pivot row keeps its
//     values and its scale becomes a.  So no step inverts anything, and a
//     zero stays a zero, so every pivot search sees what the reference sees.
//     The scales are products of pivots: with pref[i] = prod of the pivots
//     a_s of steps s < i and A = pref[n], the row at a pivot position i has
//     lambda = A / pref[i] (it was reset to a_i at step i and scaled by every
//     later pivot) and the row at a non-pivot position has lambda = A (never
//     a pivot, scaled at every step).  One inverse of A per launch (Fermat
//     on Barrett products, modp.cuh) then gives every row's 1 / lambda.
// Phase 1 needs only which columns pivot (d1), so it tracks no W and no
// scale.  M's column j is dead after step j (later steps read columns > j
// only and M itself is not an output), so step j writes only M's columns
// > j and all of W's, reads column j and row P, and needs no second buffer:
// ONE barrier per pivot step and none for a column without a pivot.  Every
// warp searches the pivot itself (one shared-memory load of column j per
// lane, __ballot_sync, __ffs, the pivot and its row by __shfl_sync), so no
// thread waits on another for it; M and W have an odd row stride, so that
// column load is free of bank conflicts.  Thread t works on column t % n
// and the rows t / n, t / n + T / n, ..., SI_GROUP rows' loads at a time;
// with one warp (T = 32) the barrier is a __syncwarp.  The pivot steps and
// the inverse reduce with reduce_short (32-bit multiplies; modp.cuh), the
// check and the right-hand side sum n products lazily and reduce with
// barrett_reduce: no 64-bit %.
//
// What bounds it on an H100: the dependent chain, not bytes or operations.
// 2n pivot steps run one after another, each a barrier, a pivot search (a
// shared-memory load, a ballot, two shuffles), the register swap and the
// row update (two more shared-memory loads, two multiplies, a short
// reduction, a store); then one ~30-product Fermat chain and the n-term dot
// products of the check and the right-hand side.  Measured (PERF.md, with
// utils/kernel_sweeps.py), a pivot step takes about 0.5 us, several times
// the sum of its instructions' latencies, most of it in the row update, and
// a launch at n = 4 is about half fixed cost (the Grams' first load, the
// inverse, the check and the right-hand side).  The CTA shape by n
// (si_warps, at the end) is measured there too.
#include "modp.cuh"

#define SI_MAXN 64
#define SI_GROUP 4  // rows a thread loads before it stores (ILP)
// Row stride of M and W in shared memory: odd, so that the 32 lanes reading
// one column hit 32 different banks.
#define SI_LD(n) ((n) | 1)
#define FULL_MASK 0xffffffffu

// Design measurement only: built with -DSI_TIMELINE (utils/kernel_sweeps.py),
// thread 0 records clock64() at fixed slots of si_stamps, which
// semi_inverse_stamps copies to the host.  Slots: the kernel's phases
// (SI_T_*, and %globaltimer in ns at its start and end), the start of each
// pivot step of phase 1 (SI_T_STEP1 + j) and phase 2 (SI_T_STEP2 + j), and
// for phase 2's first SI_T_NSUB steps the end of each part of the step
// (SI_T_SUB + 5 j + k: search, swap, update, pivot product, barrier).
#ifdef SI_TIMELINE
enum {
  SI_T_START, SI_T_LOADED, SI_T_PHASE1, SI_T_P2INIT, SI_T_PHASE2, SI_T_WINV,
  SI_T_CHECK, SI_T_RHS, SI_T_END, SI_T_NS_START, SI_T_NS_END,
  SI_T_STEP1 = 16, SI_T_STEP2 = SI_T_STEP1 + SI_MAXN,
  SI_T_SUB = SI_T_STEP2 + SI_MAXN, SI_T_NSUB = 3,
  SI_T_SLOTS = SI_T_SUB + 5 * SI_T_NSUB
};
__device__ long long si_stamps[SI_T_SLOTS];
#define SI_STAMP(slot) \
  if (threadIdx.x == 0) si_stamps[slot] = clock64()
// part k of pivot step j, in eliminate<WITH_W = true> only
#define SI_STAMP_PART(j, k) \
  if (WITH_W && (j) < SI_T_NSUB) SI_STAMP(SI_T_SUB + 5 * (j) + (k))
__device__ __forceinline__ long long globaltimer_ns() {
  long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int semi_inverse_stamps(long long* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, si_stamps, sizeof(si_stamps)));
}
#else
#define SI_STAMP(slot)
#define SI_STAMP_PART(j, k)
#endif

struct SiShared {
  u32 M[SI_MAXN * SI_LD(SI_MAXN)];  // physical rows, stride SI_LD(n); after
                                    // phase 2, winv (logical, stride n)
  u32 W[SI_MAXN * SI_LD(SI_MAXN)];  // phase 2's W, physical rows, row-scaled
  int perm[SI_MAXN];         // phase 2's final logical -> physical rows
  u32 pref[SI_MAXN + 1];     // pref[j]: product of phase 2's pivots before j
  u32 sig[SI_MAXN];          // 1 / lambda of logical row i
  u32 d1[SI_MAXN];
  u32 d[SI_MAXN];
  int ok;
};

__device__ __forceinline__ void block_sync() {
  if (blockDim.x == 32)
    __syncwarp();
  else
    __syncthreads();
}

// One Gauss-Jordan sweep over the columns on the row-scaled, row-permuted
// representation (see above), from M (and W) as the block sees them, with
// perm = identity.  Writes d (and, with W, pref and the final perm) and
// returns the number of pivots.  Every thread of the block calls it; it ends
// with a barrier.
template <bool WITH_W>
__device__ int eliminate(SiShared& s, int n, const ShortBarrett& sb, u32* d) {
  const int tid = threadIdx.x, T = blockDim.x, lane = tid & 31;
  const int rstride = T / n;  // T >= n (checked by the entry point)
  const bool active = tid < rstride * n;
  const int cw = tid % n, q0 = tid / n, ld = SI_LD(n);
  int perm_lo = lane, perm_hi = lane + 32;
  int npiv = 0;
  u32 pref = 1;  // product of the pivots so far (phase 2's row scales)
  for (int j = 0; j < n; ++j) {
    SI_STAMP((WITH_W ? SI_T_STEP2 : SI_T_STEP1) + j);
    // first logical row i >= j with M[perm[i], j] != 0: its index piv, its
    // physical row P and the pivot a, found by every warp on its own
    int piv = -1, P = 0;
    u32 a = 0;
    if (j < 32) {
      const u32 m = lane >= j && lane < n ? s.M[perm_lo * ld + j] : 0u;
      const unsigned mask = __ballot_sync(FULL_MASK, m != 0u);
      if (mask) {
        piv = __ffs(mask) - 1;
        a = __shfl_sync(FULL_MASK, m, piv);
        P = __shfl_sync(FULL_MASK, perm_lo, piv);
      }
    }
    if (piv < 0 && n > 32) {
      const int i = lane + 32;
      const u32 m = i >= j && i < n ? s.M[perm_hi * ld + j] : 0u;
      const unsigned mask = __ballot_sync(FULL_MASK, m != 0u);
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
    SI_STAMP_PART(j, 0);
    if (piv < 0) continue;  // uniform: nothing is written, no barrier
    // swap logical rows j and piv: perm[j] = P, perm[piv] = old perm[j]
    const int pj = j < 32 ? __shfl_sync(FULL_MASK, perm_lo, j)
                          : __shfl_sync(FULL_MASK, perm_hi, j - 32);
    if (lane == (j & 31)) (j < 32 ? perm_lo : perm_hi) = P;
    if (lane == (piv & 31)) (piv < 32 ? perm_lo : perm_hi) = pj;
    SI_STAMP_PART(j, 1);
    if (active) {
      // R_r <- a * R_r - M[r, j] * R_P for the thread's rows r != P, in
      // column cw: a * R + nb * R_P < 2 p^2, one short reduction each.
      // A group's loads all come before its stores, so they overlap.
      const u32 mP = cw > j ? s.M[P * ld + cw] : 0u;
      const u32 wP = WITH_W ? s.W[P * ld + cw] : 0u;
      for (int q = q0; q < n; q += SI_GROUP * rstride) {
        u32 b[SI_GROUP], m[SI_GROUP], w[SI_GROUP];
#pragma unroll
        for (int g = 0; g < SI_GROUP; ++g) {
          const int r = q + g * rstride;
          b[g] = r < n ? s.M[r * ld + j] : 0u;
          m[g] = r < n && cw > j ? s.M[r * ld + cw] : 0u;
          w[g] = r < n && WITH_W ? s.W[r * ld + cw] : 0u;
        }
#pragma unroll
        for (int g = 0; g < SI_GROUP; ++g) {
          const int r = q + g * rstride;
          if (r >= n || r == P) continue;
          const u64 nb = sb.p - b[g];  // -M[r, j], in (0, p]
          if (cw > j)
            s.M[r * ld + cw] =
                reduce_short(static_cast<u64>(a) * m[g] + nb * mP, sb);
          if (WITH_W)
            s.W[r * ld + cw] =
                reduce_short(static_cast<u64>(a) * w[g] + nb * wP, sb);
        }
      }
    }
    SI_STAMP_PART(j, 2);
    if (WITH_W) pref = mulmod_b(pref, a, sb);
    npiv += 1;
    SI_STAMP_PART(j, 3);
    block_sync();
    SI_STAMP_PART(j, 4);
  }
  if (WITH_W && tid < 32) {
    if (tid == 0) s.pref[n] = pref;
    s.perm[lane] = perm_lo;
    if (lane + 32 < n) s.perm[lane + 32] = perm_hi;
  }
  block_sync();
  return npiv;
}

// sum_k a[k] * b[k * stride] mod p over k < n, folded every LAZY_FOLD terms
__device__ __forceinline__ u64 dot_mod(const u32* a, const int* b, int stride,
                                       int n, u64 p, u64 mu) {
  u64 acc = 0;
  for (int k = 0; k < n; ++k) {
    acc += static_cast<u64>(a[k]) * static_cast<u32>(__ldg(b + k * stride));
    if ((k & (LAZY_FOLD - 1)) == LAZY_FOLD - 1) acc = barrett_reduce(acc, p, mu);
  }
  return barrett_reduce(acc, p, mu);
}

__global__ void semi_inverse_kernel(const int* __restrict__ grams, int n,
                                    u64 p, u64 mu, int check,
                                    int* __restrict__ winv,
                                    int* __restrict__ d_out,
                                    int* __restrict__ npiv_out,
                                    int* __restrict__ rhs,
                                    int* __restrict__ state) {
  __shared__ SiShared s;
  const int tid = threadIdx.x, T = blockDim.x;
  const int nn = n * n;
  const int* vtAv = grams;
  const int* vtAAv = grams + nn;
  const int ld = SI_LD(n);
  const ShortBarrett sb = short_barrett(p, mu);
  const int frozen = tid == 0 ? state[3] : 0;  // read early, used at the end
#ifdef SI_TIMELINE
  if (tid == 0) si_stamps[SI_T_NS_START] = globaltimer_ns();
#endif
  SI_STAMP(SI_T_START);

  // phase 1: find the pivotable column set d1 (W is not tracked)
  for (int e = tid; e < nn; e += T) {
    const int i = e / n, c = e - i * n;
    s.M[i * ld + c] = static_cast<u32>(__ldg(vtAv + e));
  }
  block_sync();
  SI_STAMP(SI_T_LOADED);
  eliminate<false>(s, n, sb, s.d1);
  SI_STAMP(SI_T_PHASE1);
  // phase 2: re-eliminate the d1-masked matrix from W0 = eye * d1
  for (int e = tid; e < nn; e += T) {
    const int i = e / n, c = e - i * n;
    s.M[i * ld + c] = (s.d1[i] && s.d1[c]) ? static_cast<u32>(__ldg(vtAv + e)) : 0u;
    s.W[i * ld + c] = (i == c) ? s.d1[c] : 0u;
  }
  if (tid == 0) s.ok = 1;
  block_sync();
  SI_STAMP(SI_T_P2INIT);
  const int npiv = eliminate<true>(s, n, sb, s.d);
  SI_STAMP(SI_T_PHASE2);

  // undo the row scales: winv[i, :] = W[perm[i], :] / lambda_i, into M
  if (tid < n) {
    const u32 inv_a = inv_fermat(s.pref[n], sb);
    s.sig[tid] = s.d[tid] ? mulmod_b(s.pref[tid], inv_a, sb) : inv_a;
  }
  block_sync();
  for (int e = tid; e < nn; e += T) {
    const int i = e / n, c = e - i * n;
    const u32 w = mulmod_b(s.W[s.perm[i] * ld + c], s.sig[i], sb);
    s.M[e] = w;
    winv[e] = static_cast<int>(w);
  }
  block_sync();
  SI_STAMP(SI_T_WINV);
  const u32* W = s.M;

  // fused invariants (models/lanczos.py::check_invariants_device):
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
      ok &= (W[e] == 0u) || s.d[i] || s.d[c];
      const u64 acc = s.d[c] ? dot_mod(W + i * n, vtAv + c, n, n, p, mu) : 0;
      ok &= acc == ((i == c) ? static_cast<u64>(s.d[c]) : 0ull);
    }
    if (!ok) atomicAnd(&s.ok, 0);
  }
  SI_STAMP(SI_T_CHECK);

  // right-hand side of the fused update [v | p] * rhs
  const int w = 2 * n;
  for (int e = tid; e < w * w; e += T) {
    const int R = e / w, C = e - R * w;
    u32 out = 0;
    if (R < n && C < n) {  // c = -(winv * where(d, vtAAv, vtAv))
      const u64 acc =
          dot_mod(W + R * n, (s.d[C] ? vtAAv : vtAv) + C, n, n, p, mu);
      out = acc ? static_cast<u32>(p - acc) : 0u;
    } else if (R < n) {
      out = W[R * n + (C - n)];
    } else if (C < n && s.d[C]) {
      const u32 g = static_cast<u32>(__ldg(vtAv + (R - n) * n + C));
      out = g ? static_cast<u32>(p - g) : 0u;
    }
    rhs[e] = static_cast<int>(out);
  }
  for (int i = tid; i < n; i += T) d_out[i] = static_cast<int>(s.d[i]);
  SI_STAMP(SI_T_RHS);
  block_sync();
  if (tid == 0) {
    npiv_out[0] = npiv;
    if (!frozen) {
      state[0] = npiv == 0;
      state[1] = check ? s.ok : 1;
    }
  }
  SI_STAMP(SI_T_END);
#ifdef SI_TIMELINE
  if (tid == 0) si_stamps[SI_T_NS_END] = globaltimer_ns();
#endif
}

// The CTA's size in warps for block width n (1 <= n <= SI_MAXN): one warp
// up to n = 4, whose barriers are then __syncwarp, else n / 2 (at most 32).
// The fastest shape, or within 4% of it, at every n that
// utils/kernel_sweeps.py measured (PERF.md); that tool builds the kernel
// with -DSI_WARPS=w to force another.
static int si_warps(int n) {
#ifdef SI_WARPS
  return SI_WARPS;
#else
  return n <= 4 ? 1 : n / 2;
#endif
}

extern "C" int semi_inverse(const int* grams, int n, unsigned long long p,
                            unsigned long long mu, int check, int* winv,
                            int* d, int* npiv, int* rhs, int* state,
                            void* stream) {
  if (n < 1 || n > SI_MAXN) return cudaErrorInvalidValue;
  const int warps = si_warps(n);
  if (warps < 1 || warps > 32 || 32 * warps < n) return cudaErrorInvalidValue;
  semi_inverse_kernel<<<1, 32 * warps, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      grams, n, p, mu, check, winv, d, npiv, rhs, state);
  return static_cast<int>(cudaGetLastError());
}
