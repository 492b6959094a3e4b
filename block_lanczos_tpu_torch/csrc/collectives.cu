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
//       `pxor_fold` keeps each lane's low bit.  The payload is (L, S): plane
//       k starts S = n rounded up to 4 words after plane k - 1 (of the two
//       ways to keep every plane on a 16-byte boundary where the payload
//       starts on one, this padded plane stride rather than a
//       word-interleaved (n, L) layout: each plane's stores stay
//       contiguous across a warp).  The S - n padding words of a plane are
//       neither written by the spread nor read by the fold: the wrappers
//       allocate the payload zeroed, so the transport sums zeros there.
//
// Bound: each is an elementwise pass over the partial and its payload, so
// bytes at the HBM rate bound it (the transport's time is not the
// kernel's).  Every entry point launches on the given stream, does not
// synchronise, and returns cudaGetLastError(); a count of 0 launches
// nothing.  Inputs are canonical residues (K1, K2): the kernels that
// produce them (spmv, gram) reduce fully.
//
// The three, as designed for Hopper:
//   * one wave: the grid is the card's SMs times the CTAs of COLL_THREADS
//     threads an SM holds of the kernel (read once per device), or fewer
//     when the work needs fewer, each thread striding over the rest;
//   * 16-byte accesses: each thread moves whole int4 / longlong2 vectors
//     (4 int32 or 2 int64 elements a vector; K1's int64 payload two
//     longlong2 for the int4 of x; K3 one uint4 of x and one of each of
//     its L planes), with a scalar head that brings every pointer to a
//     16-byte boundary and a scalar tail; where no head aligns them all
//     (views that start off a boundary by different amounts), the whole
//     pass is scalar;
//   * K1's int32 sums (below 2^31) fold by the 32-bit Barrett step
//     (modp.cuh::barrett_reduce32, m = mu >> 32: one __umulhi), its int64
//     sums by barrett_reduce; K2 keeps barrett_reduce for whole sums and
//     reduce128 for halves;
//   * K3's lane width is a template parameter (L in 2, 4, 8, 16, 32, one
//     instantiation each): the lane mask and the top lane are constants
//     and every loop over the planes unrolls, its plane offsets one add
//     of S a plane;
//   * K3's spread writes its planes with streaming stores (st.global.cs,
//     evict-first): on the H100 plain stores left the spread under half
//     the rate of streaming ones from L = 8 on (PERF.md).  The fold's loads
//     and stores stay plain: its output is the next kernel's input.
#include <stdint.h>

#include <atomic>
#include <initializer_list>

#include "modp64.cuh"

#define COLL_THREADS 256
#define MAX_DEVICES 64

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

// Words between two planes of the payload: n rounded up to 4.
static inline long long plane_stride(long long n) { return (n + 3) & ~3ll; }

// The lanes of width L: one bit every L positions (0x55555555, 0x11111111,
// 0x01010101, 0x00010001, 0x00000001) and the top one, which is negated.
template <int L>
struct Lanes {
  static constexpr u32 MASK =
      static_cast<u32>(0xFFFFFFFFull / ((1ull << L) - 1));
  static constexpr u32 TOP = L < 32 ? 1u << (32 - L) : 0u;
  // plane k of the word w: (lower lanes of (w >> k)) - (its top lane), as
  // an int32 two's complement pattern (unsigned arithmetic: no overflow)
  __device__ static u32 plane(u32 w, int k) {
    const u32 v = (w >> k) & MASK;  // logical shift: u32
    return (v & ~TOP) - (v & TOP);
  }
  // the lane parities of plane k's sum, back at bits k, k + L, ...
  __device__ static u32 parity(u32 s, int k) { return (s & MASK) << k; }
};

template <int L>
struct XorSpread {  // x -> payload (L, stride)
  const u32* x;
  u32* payload;
  long long stride;
  __device__ void scalar(long long i) const {
    const u32 w = x[i];
    u32* out = payload + i;
#pragma unroll
    for (int k = 0; k < L; ++k, out += stride)
      __stcs(out, Lanes<L>::plane(w, k));
  }
  __device__ void vector(long long i) const {
    const uint4 w = *reinterpret_cast<const uint4*>(x + i);
    u32* out = payload + i;
#pragma unroll
    for (int k = 0; k < L; ++k, out += stride)
      __stcs(reinterpret_cast<uint4*>(out),
             make_uint4(Lanes<L>::plane(w.x, k), Lanes<L>::plane(w.y, k),
                        Lanes<L>::plane(w.z, k), Lanes<L>::plane(w.w, k)));
  }
};

template <int L>
struct XorFold {  // summed payload (L, stride) -> x
  const u32* sums;
  u32* x;
  long long stride;
  __device__ void scalar(long long i) const {
    const u32* in = sums + i;
    u32 w = 0;
#pragma unroll
    for (int k = 0; k < L; ++k, in += stride) w |= Lanes<L>::parity(*in, k);
    x[i] = w;
  }
  __device__ void vector(long long i) const {
    const u32* in = sums + i;
    uint4 w = make_uint4(0, 0, 0, 0);
#pragma unroll
    for (int k = 0; k < L; ++k, in += stride) {
      const uint4 s = *reinterpret_cast<const uint4*>(in);
      w.x |= Lanes<L>::parity(s.x, k);
      w.y |= Lanes<L>::parity(s.y, k);
      w.z |= Lanes<L>::parity(s.z, k);
      w.w |= Lanes<L>::parity(s.w, k);
    }
    *reinterpret_cast<uint4*>(x + i) = w;
  }
};

template <int L>
__global__ void __launch_bounds__(COLL_THREADS)
    pxor_spread_kernel(XorSpread<L> op, long long n, Split s) {
  elementwise<4>(op, n, s);
}

template <int L>
__global__ void __launch_bounds__(COLL_THREADS)
    pxor_fold_kernel(XorFold<L> op, long long n, Split s) {
  elementwise<4>(op, n, s);
}

// The spread (in x, out the payload) or the fold (in the summed payload,
// out x) of n words at lane width L.  Plane k's element i lies k * stride
// words (a multiple of 16 bytes) past the payload's element i, so the
// split of x and the payload's first plane holds for every plane.
template <int L>
static void xor_pass(bool fold, const void* in, void* out, long long n,
                     void* stream) {
  if (n <= 0) return;
  const u32* src = static_cast<const u32*>(in);
  u32* dst = static_cast<u32*>(out);
  if (fold)
    launch_pass<4>(pxor_fold_kernel<L>, XorFold<L>{src, dst, plane_stride(n)},
                   n, {{out, 4}, {in, 4}}, stream);
  else
    launch_pass<4>(pxor_spread_kernel<L>,
                   XorSpread<L>{src, dst, plane_stride(n)}, n,
                   {{in, 4}, {out, 4}}, stream);
}

// A lane width other than 2, 4, 8, 16 or 32 launches nothing and returns
// cudaErrorInvalidValue.
static int pxor_pass(bool fold, const void* in, void* out, long long n,
                     int lanes, void* stream) {
  switch (lanes) {
    case 2: xor_pass<2>(fold, in, out, n, stream); break;
    case 4: xor_pass<4>(fold, in, out, n, stream); break;
    case 8: xor_pass<8>(fold, in, out, n, stream); break;
    case 16: xor_pass<16>(fold, in, out, n, stream); break;
    case 32: xor_pass<32>(fold, in, out, n, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pxor_spread(const void* x, void* payload, long long n,
                           int lanes, void* stream) {
  return pxor_pass(false, x, payload, n, lanes, stream);
}

extern "C" int pxor_fold(const void* sums, void* x, long long n, int lanes,
                         void* stream) {
  return pxor_pass(true, sums, x, n, lanes, stream);
}
