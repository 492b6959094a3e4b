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
// What bounds it on an H100: latency, not bytes or operations — n
// sequential pivot steps on a matrix of at most 64 x 64.  Design: the whole
// computation is one CTA with M and W in shared memory (32 KB at n = 64),
// so the n steps of each phase are __syncthreads()-separated loops inside
// one launch instead of 2n kernel launches.  Bit-exact with the JAX
// reference: the pivot is the first nonzero row >= j; M and W see the same
// swap and normalisation; W's multiplier comes from M's column after the
// swap; the pivot inverse is Fermat's a^(p-2) in u64 (p = 2: a^0 = 1).
#include "modp.cuh"

#define SI_MAXN 64
#define SI_THREADS 256

struct SiShared {
  u32 M[SI_MAXN * SI_MAXN];
  u32 W[SI_MAXN * SI_MAXN];
  u32 mult[SI_MAXN];
  u32 d1[SI_MAXN];
  u32 d[SI_MAXN];
  u32 pinv;
  int piv;
  int npiv;
  int ok;
};

// One Gauss-Jordan sweep over the columns; updates M (and W) in place,
// writes d and npiv.  Every thread of the block calls it.
__device__ void eliminate(SiShared& s, bool with_w, int n, u64 p, u32* d) {
  const int tid = threadIdx.x, T = blockDim.x;
  if (tid == 0) s.npiv = 0;
  for (int j = 0; j < n; ++j) {
    __syncthreads();
    if (tid == 0) {
      int piv = -1;
      for (int i = j; i < n; ++i)
        if (s.M[i * n + j] != 0) { piv = i; break; }
      s.piv = piv;
      d[j] = piv >= 0;
      if (piv >= 0) {
        s.pinv = static_cast<u32>(powmod(s.M[piv * n + j], p - 2, p));
        s.npiv += 1;
      }
    }
    __syncthreads();
    const int piv = s.piv;
    if (piv < 0) continue;  // uniform: no pivot, column left as it is
    const u64 pinv = s.pinv;
    // swap rows j and piv, normalising the new row j
    for (int c = tid; c < n; c += T) {
      u32 a = s.M[piv * n + c], b = s.M[j * n + c];
      s.M[j * n + c] = static_cast<u32>(mulmod(a, pinv, p));
      if (piv != j) s.M[piv * n + c] = b;
      if (with_w) {
        u32 wa = s.W[piv * n + c], wb = s.W[j * n + c];
        s.W[j * n + c] = static_cast<u32>(mulmod(wa, pinv, p));
        if (piv != j) s.W[piv * n + c] = wb;
      }
    }
    __syncthreads();
    // multipliers from M's column j after the swap (-M[i, j]; 0 on row j)
    for (int i = tid; i < n; i += T)
      s.mult[i] = (i == j) ? 0u : static_cast<u32>((p - s.M[i * n + j]) % p);
    __syncthreads();
    for (int e = tid; e < n * n; e += T) {
      const int i = e / n, c = e - (e / n) * n;
      if (i == j) continue;
      s.M[e] = static_cast<u32>((s.M[e] + mulmod(s.mult[i], s.M[j * n + c], p)) % p);
      if (with_w)
        s.W[e] = static_cast<u32>((s.W[e] + mulmod(s.mult[i], s.W[j * n + c], p)) % p);
    }
  }
  __syncthreads();
}

__global__ void semi_inverse_kernel(const int* __restrict__ grams, int n,
                                    u64 p, int check, int* __restrict__ winv,
                                    int* __restrict__ d_out,
                                    int* __restrict__ npiv_out,
                                    int* __restrict__ rhs,
                                    int* __restrict__ state) {
  __shared__ SiShared s;
  const int tid = threadIdx.x, T = blockDim.x;
  const int nn = n * n;
  const int* vtAv = grams;
  const int* vtAAv = grams + nn;

  // phase 1: find the pivotable column set d1 (W is not tracked)
  for (int e = tid; e < nn; e += T) s.M[e] = static_cast<u32>(vtAv[e]);
  eliminate(s, false, n, p, s.d1);
  // phase 2: re-eliminate the d1-masked matrix from W0 = eye * d1
  for (int e = tid; e < nn; e += T) {
    const int i = e / n, c = e - (e / n) * n;
    s.M[e] = (s.d1[i] && s.d1[c]) ? static_cast<u32>(vtAv[e]) : 0u;
    s.W[e] = (i == c) ? s.d1[c] : 0u;
  }
  if (tid == 0) s.ok = 1;
  eliminate(s, true, n, p, s.d);

  // fused invariants (models/lanczos.py::check_invariants_device):
  // symmetry of vtAv, vtAAv, winv; winv[i,c] != 0 => d_i or d_c;
  // winv * where(d, vtAv, 0) == diag(d)
  if (check) {
    int ok = 1;
    for (int e = tid; e < nn; e += T) {
      const int i = e / n, c = e - (e / n) * n;
      const int et = c * n + i;
      ok &= vtAv[e] == vtAv[et];
      ok &= vtAAv[e] == vtAAv[et];
      ok &= s.W[e] == s.W[et];
      ok &= (s.W[e] == 0u) || s.d[i] || s.d[c];
      u64 acc = 0;
      if (s.d[c])
        for (int k = 0; k < n; ++k)
          acc += mulmod(s.W[i * n + k], static_cast<u32>(vtAv[k * n + c]), p);
      acc %= p;
      ok &= acc == ((i == c) ? static_cast<u64>(s.d[c]) : 0ull);
    }
    if (!ok) atomicAnd(&s.ok, 0);
  }

  // right-hand side of the fused update [v | p] * rhs
  const int w = 2 * n;
  for (int e = tid; e < w * w; e += T) {
    const int R = e / w, C = e - (e / w) * w;
    u32 out = 0;
    if (R < n && C < n) {
      u64 acc = 0;  // c = -(winv * where(d, vtAAv, vtAv))
      for (int k = 0; k < n; ++k) {
        const int* src = s.d[C] ? vtAAv : vtAv;
        acc += mulmod(s.W[R * n + k], static_cast<u32>(src[k * n + C]), p);
      }
      out = static_cast<u32>((p - acc % p) % p);
    } else if (R < n) {
      out = s.W[R * n + (C - n)];
    } else if (C < n) {
      out = s.d[C] ? static_cast<u32>((p - static_cast<u32>(vtAv[(R - n) * n + C])) % p)
                   : 0u;
    }
    rhs[e] = static_cast<int>(out);
  }
  for (int e = tid; e < nn; e += T) winv[e] = static_cast<int>(s.W[e]);
  for (int i = tid; i < n; i += T) d_out[i] = static_cast<int>(s.d[i]);
  __syncthreads();
  if (tid == 0) {
    npiv_out[0] = s.npiv;
    if (!state[3]) {
      state[0] = s.npiv == 0;
      state[1] = check ? s.ok : 1;
    }
  }
}

extern "C" int semi_inverse(const int* grams, int n, unsigned long long p,
                            int check, int* winv, int* d, int* npiv,
                            int* rhs, int* state, void* stream) {
  if (n < 1 || n > SI_MAXN) return cudaErrorInvalidValue;
  semi_inverse_kernel<<<1, SI_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      grams, n, p, check, winv, d, npiv, rhs, state);
  return static_cast<int>(cudaGetLastError());
}
