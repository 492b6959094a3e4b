// final_unpack — the end of a GF(2) solve on the card: v's bit block
// unpacked, and the final check's two answers, in one pass.
//
// Replaces, on a CUDA device, the host's half of models/lanczos_gf2.py::
// BlockLanczosGF2.solve()'s final step: the download of v's and tmp's packed
// words, ops/gf2.py::unpack_bits_np of both (a (N, W, 32) broadcast and its
// copy each) and models/lanczos.py::final_check's scans of the unpacked bits.
// It replaces no TPU kernel: the JAX package unpacks on the host as well.
// The wrapper is ops/gf2.py::final_unpack; ops/gf2.py::final_unpack_np is
// this kernel in NumPy.
//
// What it writes.  v is (rows >= n_eff, W) words, tmp (rows >= m_eff, W) or
// absent; n = 32 W, so every bit of a word is a column.  Over the first
// nv = n_eff W words of v, flat, word g's bit b goes to element 32 g + b of
// `out` as 0 or 1, which is out[r, 32 w + b] for g = r W + w: the (n_eff, n)
// uint32 block of unpack_bits_np.  flags[0] becomes 1 if any of those words
// is nonzero (v != 0) and flags[1] if any of tmp's first nt = m_eff W words
// is (v^T M != 0); the entry point zeroes both first.  Past nv and nt nothing
// is read: the padding rows count for neither.
//
// Bound.  A streaming pass: nv + nt words read, 32 nv words written; at the
// GF(2) cell's 500,000 x 128 that is 8 + 8 MB in and 256 MB out, 0.081 ms at
// the H100's 3.35 TB/s.  Hence, as collectives.cu's passes:
//   * one wave of CTAs (the card's SMs times the CTAs an SM holds of the
//     kernel, read once per device), each warp striding over the rest;
//   * a 16-byte load per four words: a warp takes a tile of 128 words of v,
//     lane l words 4l .. 4l + 3, then stages them in shared memory, so that
//     each of its 32 store steps writes four words' 512 contiguous bytes,
//     lane l the 16 bytes of bits 4 (l % 8) .. 4 (l % 8) + 3 of word
//     l / 8 of the step: every 16-byte store of the warp is coalesced;
//   * the stores are streaming (st.global.cs, evict-first): the block is read
//     once, by the download that follows, and should not push the L2 out;
//   * the flags: each thread ORs the words it loads, __any_sync reduces a
//     warp, and one atomicOr a warp that found a set word.
// The vector loads need v, tmp and out on 16-byte boundaries; the entry
// point refuses others (the solver's buffers are whole allocations).
#include <stdint.h>

#include <algorithm>
#include <atomic>
#include <initializer_list>

#include "gf2.cuh"

#define FU_THREADS 256
#define FU_WARPS (FU_THREADS / 32)
#define FU_TILE 128  // words of v a warp unpacks at a time
#define FU_MAX_DEVICES 64

// words i .. i + 3 of a flat array of n words, zero past n
__device__ __forceinline__ uint4 load4(const u32* __restrict__ w, long long i,
                                       long long n) {
  if (i + 4 <= n) return __ldcs(reinterpret_cast<const uint4*>(w + i));
  uint4 r = make_uint4(0, 0, 0, 0);
  if (i < n) r.x = w[i];
  if (i + 1 < n) r.y = w[i + 1];
  if (i + 2 < n) r.z = w[i + 2];
  return r;
}

__global__ void __launch_bounds__(FU_THREADS)
    final_unpack_kernel(const u32* __restrict__ v, long long nv,
                        const u32* __restrict__ tmp, long long nt,
                        uint4* __restrict__ out, int* __restrict__ flags) {
  __shared__ __align__(16) u32 stage[FU_WARPS][FU_TILE];
  const int lane = threadIdx.x & 31, wib = threadIdx.x >> 5;
  const long long warp = blockIdx.x * static_cast<long long>(FU_WARPS) + wib;
  const long long warps = static_cast<long long>(gridDim.x) * FU_WARPS;
  u32* st = stage[wib];

  // v: whole warps take whole tiles, so every lane runs every iteration
  u32 any_v = 0;
  for (long long t = warp; t * FU_TILE < nv; t += warps) {
    const long long base = t * FU_TILE;
    const uint4 w = load4(v, base + 4 * lane, nv);
    any_v |= w.x | w.y | w.z | w.w;
    *reinterpret_cast<uint4*>(st + 4 * lane) = w;
    __syncwarp();
    const long long left = nv - base;  // words of this tile (<= FU_TILE)
    const int shift = 4 * (lane & 7);
    uint4* o = out + base * 8 + lane;  // 8 uint4 of bits a word
#pragma unroll 4
    for (int k = 0; k < FU_TILE / 4; ++k) {
      const int j = 4 * k + (lane >> 3);  // the word of the tile
      if (j < left) {
        const u32 x = st[j] >> shift;
        __stcs(o + 32 * k,
               make_uint4(x & 1, (x >> 1) & 1, (x >> 2) & 1, (x >> 3) & 1));
      }
    }
    __syncwarp();
  }

  // tmp: only whether any word is set
  u32 any_t = 0;
  const long long thread = warp * 32 + lane, threads = warps * 32;
  for (long long i = 4 * thread; i < nt; i += 4 * threads) {
    const uint4 w = load4(tmp, i, nt);
    any_t |= w.x | w.y | w.z | w.w;
  }

  if (__any_sync(GF2_FULL_MASK, any_v != 0) && lane == 0)
    atomicOr(flags, 1);
  if (__any_sync(GF2_FULL_MASK, any_t != 0) && lane == 0)
    atomicOr(flags + 1, 1);
}

// v: (>= n_eff, W) words; tmp: (>= m_eff, W) words or null (then m_eff is
// ignored and flags[1] stays 0); out: (n_eff, 32 W) u32; flags: 2 ints,
// zeroed here, then set as above.  n_eff, m_eff >= 0, 1 <= W <= GF2_MAXW.
extern "C" int final_unpack(const void* v, const void* tmp, long long n_eff,
                            long long m_eff, int W, void* out, void* flags,
                            void* stream) {
  if (n_eff < 0 || m_eff < 0 || W < 1 || W > GF2_MAXW || flags == nullptr ||
      (n_eff > 0 && (v == nullptr || out == nullptr)))
    return cudaErrorInvalidValue;
  for (const void* p : {v, tmp, static_cast<const void*>(out)})
    if (reinterpret_cast<uintptr_t>(p) % 16) return cudaErrorMisalignedAddress;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(flags, 0, 2 * sizeof(int), s);
  const long long nv = n_eff * W, nt = tmp == nullptr ? 0 : m_eff * W;
  // CTAs the work needs: a tile of v a warp, four words of tmp a thread
  const long long tiles = (nv + FU_TILE - 1) / FU_TILE;
  const long long need = std::max((tiles + FU_WARPS - 1) / FU_WARPS,
                                  (nt + 4 * FU_THREADS - 1) / (4 * FU_THREADS));
  if (need == 0) return static_cast<int>(cudaGetLastError());
  static std::atomic<int> wave[FU_MAX_DEVICES];  // by device
  int dev = 0, ctas = 0;
  cudaGetDevice(&dev);
  const bool cached = dev >= 0 && dev < FU_MAX_DEVICES;
  if (cached) ctas = wave[dev].load();
  if (ctas == 0) {
    int sms = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, final_unpack_kernel,
                                                  FU_THREADS, 0);
    ctas = sms * per_sm;
    if (cached) wave[dev].store(ctas);
  }
  final_unpack_kernel<<<static_cast<unsigned>(need < ctas ? need : ctas),
                        FU_THREADS, 0, s>>>(
      static_cast<const u32*>(v), nv, static_cast<const u32*>(tmp), nt,
      static_cast<uint4*>(out), static_cast<int*>(flags));
  return static_cast<int>(cudaGetLastError());
}
