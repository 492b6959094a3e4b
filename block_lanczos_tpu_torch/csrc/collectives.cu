// The mesh's exact all-reduces: the part of each collective that is not
// the transport's sum.  Replaces what the JAX package's collectives compute
// in their own bodies around `jax.lax.psum`:
//   * block_lanczos_tpu/parallel/collectives.py::psum_mod (:20): narrow
//     residues, 15-bit limbs split, summed in u32, recombined mod p;
//   * parallel/collectives.py::psum_mod_wide (:28): wide residues as five
//     15-bit limbs, recombined mod p;
//   * parallel/distributed_gf2.py::pxor (:39): XOR as the parity of lane
//     sums, each word spread into L-bit lanes.
// Here the transport is torch.distributed's all_reduce(SUM) (NCCL on the
// card, gloo on the host), which sums int32 or int64 as SIGNED integers:
// wrap-around is not relied on anywhere, so every payload is chosen (by
// the wrappers, block_lanczos_tpu_torch/parallel/collectives.py) so that
// the sum of R ranks' payloads cannot leave its type's range:
//
//   K1  psum_mod (p <= 2^30 - 35):   R (p - 1) < 2^31: the int32 partial
//       itself (no pack), else `psum_mod_pack` widens it to int64 (sums
//       below R 2^30).  `psum_mod_fold` writes sum mod p (Barrett,
//       modp.cuh) back into the int32 partial.
//   K2  psum_mod_wide (p < 2^62):    R <= 2: the int64 partial itself
//       (R (p - 1) < 2^63), else `psum_mod_wide_pack` sends two 31-bit
//       halves as int64 (sums below 2^31 R, exact to R < 2^32).
//       `psum_mod_wide_fold` recombines hi 2^31 + lo in 128 bits and
//       reduces it mod p (modp64.cuh::reduce128), or Barrett-reduces the
//       plain sum.
//   K3  pxor (bit words):            `pxor_spread` writes L planes, plane k
//       holding bits k, k + L, ... of each word at positions 0, L, 2L, ...
//       (one bit a lane); the lane sums count the ranks whose bit is set
//       and their low bits are the XOR.  The top lane (position 32 - L)
//       enters NEGATED, so a plane is (lower lanes) - (top lane): the sum
//       of R planes lies in [-R 2^(32-L), 2^(32-L)) and stays in int32 for
//       R <= 2^(L-1); read back as 32 bits, the top lane holds -count mod
//       2^L, whose low bit is the count's.  L = 2 takes 2 ranks (the TPU's
//       u32 lanes took 3 by wrapping), 4 up to 8, 8 up to 128, 16 up to
//       32768, 32 (one bit a plane, no top lane to negate) above.
//       `pxor_fold` keeps each lane's low bit.
//
// Bound: each is an elementwise pass over the partial and its payload, so
// bytes at the HBM rate bound it (the transport's time is not the
// kernel's); a grid-stride loop of 32-bit or 64-bit loads, coalesced, with
// enough CTAs to fill the card.  Every entry point launches on the given
// stream, does not synchronise, and returns cudaGetLastError(); a count of
// 0 launches nothing.  Inputs are canonical residues (K1, K2): the
// kernels that produce them (spmv, gram) reduce fully.
#include "modp64.cuh"

#define COLL_THREADS 256
#define COLL_MAX_CTAS 4096

static inline unsigned coll_ctas(long long n) {
  const long long c = (n + COLL_THREADS - 1) / COLL_THREADS;
  return static_cast<unsigned>(c < COLL_MAX_CTAS ? c : COLL_MAX_CTAS);
}

#define GRID_STRIDE(i, n)                                              \
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + \
                     threadIdx.x;                                      \
       i < (n); i += static_cast<long long>(gridDim.x) * blockDim.x)

// ---------------------------------------------------------------------------
// K1: narrow residues
// ---------------------------------------------------------------------------

__global__ void psum_mod_pack_kernel(const int* __restrict__ x,
                                     long long* __restrict__ payload,
                                     long long n) {
  GRID_STRIDE(i, n) payload[i] = x[i];
}

// sums may alias x (the int32 payload is the partial itself)
template <typename T>
__global__ void psum_mod_fold_kernel(const T* sums, int* x, long long n,
                                     u64 p, u64 mu) {
  GRID_STRIDE(i, n) {
    x[i] = static_cast<int>(barrett_reduce(static_cast<u64>(sums[i]), p,
                                           mu));
  }
}

extern "C" int psum_mod_pack(const void* x, void* payload, long long n,
                             void* stream) {
  if (n > 0)
    psum_mod_pack_kernel<<<coll_ctas(n), COLL_THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const int*>(x), static_cast<long long*>(payload), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int psum_mod_fold(const void* sums, int sums64, void* x,
                             long long n, u64 p, u64 mu, void* stream) {
  if (n > 0) {
    const cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (sums64)
      psum_mod_fold_kernel<long long><<<coll_ctas(n), COLL_THREADS, 0, s>>>(
          static_cast<const long long*>(sums), static_cast<int*>(x), n, p,
          mu);
    else
      psum_mod_fold_kernel<int><<<coll_ctas(n), COLL_THREADS, 0, s>>>(
          static_cast<const int*>(sums), static_cast<int*>(x), n, p, mu);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K2: wide residues
// ---------------------------------------------------------------------------

#define HALF_BITS 31
#define HALF_MASK ((1ull << HALF_BITS) - 1)

// payload (2, n): the low halves, then the high halves (x < 2^62, so
// x >> 31 < 2^31)
__global__ void psum_mod_wide_pack_kernel(const long long* __restrict__ x,
                                      long long* __restrict__ payload,
                                      long long n) {
  GRID_STRIDE(i, n) {
    const u64 v = static_cast<u64>(x[i]);
    payload[i] = static_cast<long long>(v & HALF_MASK);
    payload[n + i] = static_cast<long long>(v >> HALF_BITS);
  }
}

// halves: sums (2, n) of halves, T = hi 2^31 + lo < 2^94 for R < 2^32;
// else sums (n,) of whole residues below 2^63 (R <= 2), which may alias x.
__global__ void psum_mod_wide_fold_kernel(const long long* sums, int halves,
                                      long long* x, long long n,
                                      WideField f) {
  GRID_STRIDE(i, n) {
    u64 r;
    if (halves) {
      const u64 lo = static_cast<u64>(sums[i]);
      const u64 hi = static_cast<u64>(sums[n + i]);
      U128 t = {hi << HALF_BITS, hi >> (64 - HALF_BITS)};
      add128(t, lo);
      r = reduce128(t, f);
    } else {
      r = barrett_reduce(static_cast<u64>(sums[i]), f.p, f.mu);
    }
    x[i] = static_cast<long long>(r);
  }
}

extern "C" int psum_mod_wide_pack(const void* x, void* payload, long long n,
                              void* stream) {
  if (n > 0)
    psum_mod_wide_pack_kernel<<<coll_ctas(n), COLL_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(x), static_cast<long long*>(payload),
        n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int psum_mod_wide_fold(const void* sums, int halves, void* x,
                              long long n, u64 p, u64 mu, u64 pinv, u64 r2,
                              void* stream) {
  if (n > 0)
    psum_mod_wide_fold_kernel<<<coll_ctas(n), COLL_THREADS, 0,
                            static_cast<cudaStream_t>(stream)>>>(
        static_cast<const long long*>(sums), halves,
        static_cast<long long*>(x), n, WideField{p, mu, pinv, r2});
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K3: XOR of bit words
// ---------------------------------------------------------------------------

// One bit every `lanes` positions: 0x55555555, 0x11111111, 0x01010101,
// 0x00010001, 0x00000001.
__device__ __forceinline__ u32 lane_mask(int lanes) {
  u32 m = 0;
  for (int b = 0; b < 32; b += lanes) m |= 1u << b;
  return m;
}

// payload (lanes, n): plane k = (lower lanes of (x >> k)) - (its top lane),
// as an int32 two's complement pattern (unsigned arithmetic: no overflow)
__global__ void pxor_spread_kernel(const u32* __restrict__ x,
                                   u32* __restrict__ payload, long long n,
                                   int lanes) {
  const u32 mask = lane_mask(lanes);
  const u32 top = lanes < 32 ? 1u << (32 - lanes) : 0u;
  GRID_STRIDE(i, n) {
    const u32 w = x[i];
    for (int k = 0; k < lanes; ++k) {
      const u32 v = (w >> k) & mask;  // logical shift: u32
      payload[k * n + i] = (v & ~top) - (v & top);
    }
  }
}

__global__ void pxor_fold_kernel(const u32* __restrict__ sums,
                                 u32* __restrict__ x, long long n,
                                 int lanes) {
  const u32 mask = lane_mask(lanes);
  GRID_STRIDE(i, n) {
    u32 w = 0;
    for (int k = 0; k < lanes; ++k) w |= (sums[k * n + i] & mask) << k;
    x[i] = w;
  }
}

extern "C" int pxor_spread(const void* x, void* payload, long long n,
                           int lanes, void* stream) {
  if (n > 0)
    pxor_spread_kernel<<<coll_ctas(n), COLL_THREADS, 0,
                         static_cast<cudaStream_t>(stream)>>>(
        static_cast<const u32*>(x), static_cast<u32*>(payload), n, lanes);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pxor_fold(const void* sums, void* x, long long n, int lanes,
                         void* stream) {
  if (n > 0)
    pxor_fold_kernel<<<coll_ctas(n), COLL_THREADS, 0,
                       static_cast<cudaStream_t>(stream)>>>(
        static_cast<const u32*>(sums), static_cast<u32*>(x), n, lanes);
  return static_cast<int>(cudaGetLastError());
}
