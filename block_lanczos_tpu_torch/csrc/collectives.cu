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
// kernel's).  Every entry point launches on the given stream, does not
// synchronise, and returns cudaGetLastError(); a count of 0 launches
// nothing.  Inputs are canonical residues (K1, K2): the kernels that
// produce them (spmv, gram) reduce fully.
//
// K1 and K2 (redesigned for Hopper; K3 keeps its first design):
//   * one wave: the grid is the card's SMs times the CTAs of COLL_THREADS
//     threads an SM holds of the kernel (read once per device), or fewer
//     when the work needs fewer, each thread striding over the rest;
//   * 16-byte accesses: each thread moves whole int4 / longlong2 vectors
//     (4 int32 or 2 int64 elements a vector; K1's int64 payload two
//     longlong2 for the int4 of x), with a scalar head that brings every
//     pointer to a 16-byte boundary and a scalar tail; where no head aligns
//     them all (views that start off a boundary by different amounts),
//     the whole pass is scalar;
//   * K1's int32 sums (below 2^31) fold by the 32-bit Barrett step
//     (modp.cuh::barrett_reduce32, m = mu >> 32: one __umulhi), its int64
//     sums by barrett_reduce; K2 keeps barrett_reduce for whole sums and
//     reduce128 for halves.
#include <stdint.h>

#include <atomic>
#include <initializer_list>

#include "modp64.cuh"

#define COLL_THREADS 256
#define COLL_MAX_CTAS 4096
#define MAX_DEVICES 64

// K3's grid: a thread an element, at most COLL_MAX_CTAS CTAs.
static inline unsigned coll_ctas(long long n) {
  const long long c = (n + COLL_THREADS - 1) / COLL_THREADS;
  return static_cast<unsigned>(c < COLL_MAX_CTAS ? c : COLL_MAX_CTAS);
}

#define GRID_STRIDE(i, n)                                              \
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + \
                     threadIdx.x;                                      \
       i < (n); i += static_cast<long long>(gridDim.x) * blockDim.x)

// The vector split of n elements: [0, head) and [head + vec * nvec, n) go
// element by element, the nvec vectors of `vec` elements between them by
// 16-byte accesses.
struct Split {
  long long head, nvec;
};

struct Operand {
  const void* ptr;
  int size;  // bytes an element
};

// head brings the first operand to a 16-byte boundary; every other operand
// must then be on one at element head too (a vector advances each by a
// multiple of 16 bytes: vec * size), else the pass is all scalar.
static Split split16(long long n, int vec, std::initializer_list<Operand> ops) {
  const Split scalar = {n, 0};
  const uintptr_t a = reinterpret_cast<uintptr_t>(ops.begin()->ptr);
  const int size = ops.begin()->size;
  if (a % size) return scalar;
  const long long head = static_cast<long long>((16 - a % 16) % 16) / size;
  if (head >= n) return scalar;
  for (const Operand& op : ops)
    if ((reinterpret_cast<uintptr_t>(op.ptr) + head * op.size) % 16)
      return scalar;
  return {head, (n - head) / vec};
}

// The thread's share of an elementwise pass: vectors first, then the scalar
// head and tail.  Op::vector(i) handles elements i .. i + VEC - 1 (16-byte
// aligned), Op::scalar(i) element i.
template <int VEC, typename Op>
__device__ __forceinline__ void elementwise(const Op& op, long long n,
                                            Split s) {
  const long long t = blockIdx.x * static_cast<long long>(blockDim.x) +
                      threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long v = t; v < s.nvec; v += stride) op.vector(s.head + v * VEC);
  const long long tail = s.head + s.nvec * VEC;
  const long long scalars = s.head + (n - tail);
  for (long long k = t; k < scalars; k += stride)
    op.scalar(k < s.head ? k : tail + (k - s.head));
}

// Launch an elementwise kernel over n > 0 elements on the stream: the split
// from the operands' addresses, one CTA of COLL_THREADS threads for each
// COLL_THREADS work items (vectors and scalar elements), at most one wave:
// the current device's SMs times the CTAs of this kernel that one SM holds
// (the occupancy calculator: its registers and threads), read once per
// device.  A failed query leaves 0 CTAs, which the launch refuses
// (cudaGetLastError reports it).
template <int VEC, typename Op>
static void launch_pass(void (*kernel)(Op, long long, Split), const Op& op,
                        long long n, std::initializer_list<Operand> operands,
                        void* stream) {
  static std::atomic<int> wave[MAX_DEVICES];  // this kernel's, by device
  int dev = 0, ctas = 0;
  cudaGetDevice(&dev);
  const bool cached = dev >= 0 && dev < MAX_DEVICES;
  if (cached) ctas = wave[dev].load();
  if (ctas == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                  COLL_THREADS, 0);
    ctas = sms * per_sm;
    if (cached) wave[dev].store(ctas);
  }
  const Split s = split16(n, VEC, operands);
  const long long need =
      (s.nvec + (n - s.nvec * VEC) + COLL_THREADS - 1) / COLL_THREADS;
  kernel<<<static_cast<unsigned>(need < ctas ? need : ctas), COLL_THREADS, 0,
           static_cast<cudaStream_t>(stream)>>>(op, n, s);
}

// ---------------------------------------------------------------------------
// K1: narrow residues
// ---------------------------------------------------------------------------

struct ModPack {  // int32 x -> int64 payload
  const int* x;
  long long* payload;
  __device__ void scalar(long long i) const { payload[i] = x[i]; }
  __device__ void vector(long long i) const {
    const int4 v = *reinterpret_cast<const int4*>(x + i);
    longlong2* out = reinterpret_cast<longlong2*>(payload + i);
    out[0] = make_longlong2(v.x, v.y);
    out[1] = make_longlong2(v.z, v.w);
  }
};

// int32 sums below 2^31 (R (p - 1) < 2^31); sums may alias x (the int32
// payload is the partial itself): each element is read before it is written
// by the same thread
struct ModFold32 {
  const int* sums;
  int* x;
  u32 p, m;
  __device__ int reduce(int s) const {
    return static_cast<int>(barrett_reduce32(static_cast<u32>(s), p, m));
  }
  __device__ void scalar(long long i) const { x[i] = reduce(sums[i]); }
  __device__ void vector(long long i) const {
    const int4 v = *reinterpret_cast<const int4*>(sums + i);
    *reinterpret_cast<int4*>(x + i) =
        make_int4(reduce(v.x), reduce(v.y), reduce(v.z), reduce(v.w));
  }
};

// int64 sums below R 2^30
struct ModFold64 {
  const long long* sums;
  int* x;
  u64 p, mu;
  __device__ int reduce(long long s) const {
    return static_cast<int>(barrett_reduce(static_cast<u64>(s), p, mu));
  }
  __device__ void scalar(long long i) const { x[i] = reduce(sums[i]); }
  __device__ void vector(long long i) const {
    const longlong2* in = reinterpret_cast<const longlong2*>(sums + i);
    const longlong2 a = in[0], b = in[1];
    *reinterpret_cast<int4*>(x + i) =
        make_int4(reduce(a.x), reduce(a.y), reduce(b.x), reduce(b.y));
  }
};

__global__ void __launch_bounds__(COLL_THREADS)
    psum_mod_pack_kernel(ModPack op, long long n, Split s) {
  elementwise<4>(op, n, s);
}

__global__ void __launch_bounds__(COLL_THREADS)
    psum_mod_fold32_kernel(ModFold32 op, long long n, Split s) {
  elementwise<4>(op, n, s);
}

__global__ void __launch_bounds__(COLL_THREADS)
    psum_mod_fold64_kernel(ModFold64 op, long long n, Split s) {
  elementwise<4>(op, n, s);
}

extern "C" int psum_mod_pack(const void* x, void* payload, long long n,
                             void* stream) {
  if (n > 0)
    launch_pass<4>(psum_mod_pack_kernel,
                   ModPack{static_cast<const int*>(x),
                           static_cast<long long*>(payload)},
                   n, {{x, 4}, {payload, 8}}, stream);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int psum_mod_fold(const void* sums, int sums64, void* x,
                             long long n, u64 p, u64 mu, void* stream) {
  if (n > 0 && sums64)
    launch_pass<4>(psum_mod_fold64_kernel,
                   ModFold64{static_cast<const long long*>(sums),
                             static_cast<int*>(x), p, mu},
                   n, {{x, 4}, {sums, 8}}, stream);
  else if (n > 0)
    launch_pass<4>(psum_mod_fold32_kernel,
                   ModFold32{static_cast<const int*>(sums),
                             static_cast<int*>(x), static_cast<u32>(p),
                             static_cast<u32>(mu >> 32)},
                   n, {{x, 4}, {sums, 4}}, stream);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// K2: wide residues
// ---------------------------------------------------------------------------

#define HALF_BITS 31
#define HALF_MASK ((1ull << HALF_BITS) - 1)

// payload (2, n): the low halves, then the high halves (x < 2^62, so
// x >> 31 < 2^31)
struct WidePack {
  const long long* x;
  long long* lo;
  long long* hi;  // lo + n
  __device__ static long long low(long long v) {
    return static_cast<long long>(static_cast<u64>(v) & HALF_MASK);
  }
  __device__ static long long high(long long v) {
    return static_cast<long long>(static_cast<u64>(v) >> HALF_BITS);
  }
  __device__ void scalar(long long i) const {
    lo[i] = low(x[i]);
    hi[i] = high(x[i]);
  }
  __device__ void vector(long long i) const {
    const longlong2 v = *reinterpret_cast<const longlong2*>(x + i);
    *reinterpret_cast<longlong2*>(lo + i) = make_longlong2(low(v.x),
                                                           low(v.y));
    *reinterpret_cast<longlong2*>(hi + i) = make_longlong2(high(v.x),
                                                           high(v.y));
  }
};

// whole sums below 2^63 (R <= 2), which may alias x
struct WideFold {
  const long long* sums;
  long long* x;
  u64 p, mu;
  __device__ long long reduce(long long s) const {
    return static_cast<long long>(barrett_reduce(static_cast<u64>(s), p,
                                                 mu));
  }
  __device__ void scalar(long long i) const { x[i] = reduce(sums[i]); }
  __device__ void vector(long long i) const {
    const longlong2 v = *reinterpret_cast<const longlong2*>(sums + i);
    *reinterpret_cast<longlong2*>(x + i) = make_longlong2(reduce(v.x),
                                                          reduce(v.y));
  }
};

// sums (2, n) of halves, T = hi 2^31 + lo < 2^94 for R < 2^32
struct WideFoldHalves {
  const long long* lo;
  const long long* hi;  // lo + n
  long long* x;
  WideField f;
  __device__ long long reduce(long long l, long long h) const {
    const u64 hu = static_cast<u64>(h);
    U128 t = {hu << HALF_BITS, hu >> (64 - HALF_BITS)};
    add128(t, static_cast<u64>(l));
    return static_cast<long long>(reduce128(t, f));
  }
  __device__ void scalar(long long i) const { x[i] = reduce(lo[i], hi[i]); }
  __device__ void vector(long long i) const {
    const longlong2 l = *reinterpret_cast<const longlong2*>(lo + i);
    const longlong2 h = *reinterpret_cast<const longlong2*>(hi + i);
    *reinterpret_cast<longlong2*>(x + i) = make_longlong2(reduce(l.x, h.x),
                                                          reduce(l.y, h.y));
  }
};

__global__ void __launch_bounds__(COLL_THREADS)
    psum_mod_wide_pack_kernel(WidePack op, long long n, Split s) {
  elementwise<2>(op, n, s);
}

__global__ void __launch_bounds__(COLL_THREADS)
    psum_mod_wide_fold_kernel(WideFold op, long long n, Split s) {
  elementwise<2>(op, n, s);
}

__global__ void __launch_bounds__(COLL_THREADS)
    psum_mod_wide_fold_halves_kernel(WideFoldHalves op, long long n,
                                     Split s) {
  elementwise<2>(op, n, s);
}

extern "C" int psum_mod_wide_pack(const void* x, void* payload, long long n,
                                  void* stream) {
  long long* lo = static_cast<long long*>(payload);
  if (n > 0)
    launch_pass<2>(psum_mod_wide_pack_kernel,
                   WidePack{static_cast<const long long*>(x), lo, lo + n}, n,
                   {{x, 8}, {lo, 8}, {lo + n, 8}}, stream);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int psum_mod_wide_fold(const void* sums, int halves, void* x,
                                  long long n, u64 p, u64 mu, u64 pinv,
                                  u64 r2, void* stream) {
  const long long* lo = static_cast<const long long*>(sums);
  long long* out = static_cast<long long*>(x);
  if (n > 0 && halves)
    launch_pass<2>(psum_mod_wide_fold_halves_kernel,
                   WideFoldHalves{lo, lo + n, out, WideField{p, mu, pinv, r2}},
                   n, {{x, 8}, {lo, 8}, {lo + n, 8}}, stream);
  else if (n > 0)
    launch_pass<2>(psum_mod_wide_fold_kernel, WideFold{lo, out, p, mu}, n,
                   {{x, 8}, {lo, 8}}, stream);
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
