// gram_wide — exact G = [v | Av]^T * Av mod p for wide primes (p < 2^62), on
// u64 residues, in one launch.
//
// Replaces, in the JAX package, ops/wide_ops.py::gram_mod (chunked Montgomery
// pair products with 15-bit limb sums, scanned over row chunks), which the
// wide solver calls as gram_mod([v | Av], Av) (models/lanczos_wide.py:73).
// Shapes: v (N, n), Av (N, n) -> G (2n, n), row-major: G[i, j] =
// sum_r X[r, i] Av[r, j], X = [v | Av] never materialised.
//
// Design (the narrow gram_mod.cu's one-launch partial-sum scheme, with
// partials that stay residues):
//   * A CTA of GW_THREADS threads is `lanes` row lanes of `outs` outputs
//     each: thread (lane, o) forms output o of its CTA's output tile over
//     the rows lane, lane + lanes, ... of its CTA's row stripe.  At the
//     main path's n = 4, 2n^2 = 32 outputs: a warp is one lane, its 32
//     threads read one row of v and of Av (two 32-byte sectors) and form all
//     32 products of that row.  Larger n tile the outputs over gridDim.y.
//   * Products are summed raw in 128 bits and folded by Barrett every
//     WIDE_FOLD rows (modp64.cuh); each thread reduces once, by reduce128.
//   * The CTA adds its lanes' residues in 128 bits (reduce128) and writes one
//     partial residue per output into a u64 scratch, [row stripe][o].
//     Partials below p < 2^62 cannot be added with atomics as the narrow
//     kernel's are (the CTAs' sum would leave u64), so they are stored, and
//     the CTA that draws the last ticket (threadfence reduction) sums them in
//     128 bits, `lanes` threads an output, writes G and resets the ticket
//     with atomicExch: the wrapper allocates the scratch once per device and
//     never clears it.
// What bounds it on an H100: bytes, v and Av read once (19.2 MB at the bench
// size, n = 4: 0.0057 ms at 3.35 TB/s); 2n^2 = 32 products a row, about 8
// integer multiply-adds each (modp64.cuh: mac128), 77 M at the bench:
// 0.0023 ms against the 67 T/s the chip_smoke bounds take.  It runs at
// about 8x the byte bound (PERF.md), and more CTAs made it slower: the
// 64-bit products' integer work, not the loads, is what to cut next.
#include <cstdint>

#include "modp64.cuh"

#define GW_THREADS 256
#define GW_MAX_CTAS 1024            // row stripes at most
#define GW_SCRATCH (1 << 20)        // partial slots; the ticket comes after
// Rows a lane walks, at least, when N allows: fewer make more CTAs, so more
// row loads in flight, and more partials for the last CTA to add.  128 was
// the fastest of {16, 32, 64, 128, 256} at the bench size, n = 4, on an
// H100 80GB HBM3 at 700 W; 16 and 32 were 30% slower, so load latency does
// not bound it (utils/kernel_sweeps.py builds with -DGW_ROWS_PER_LANE=r;
// PERF.md).
#ifndef GW_ROWS_PER_LANE
#define GW_ROWS_PER_LANE 128
#endif

__global__ void __launch_bounds__(GW_THREADS)
    gram_wide_kernel(const u64* __restrict__ v, const u64* __restrict__ av,
                     int n, long long N, int outs, int lanes, WideField f,
                     u64* scratch, u64* gout) {
  __shared__ U128 part[GW_THREADS];
  __shared__ bool last;
  const int ab = 2 * n * n;
  const int tid = threadIdx.x, lane = tid / outs, oi = tid - lane * outs;
  const int o = blockIdx.y * outs + oi;
  const bool active = lane < lanes && o < ab;
  U128 acc = {0, 0};
  if (active) {
    const int i = o / n, j = o - i * n;
    const u64* xs = i < n ? v + i : av + (i - n);   // column i of [v | Av]
    const u64* ws = av + j;
    const long long stride = static_cast<long long>(gridDim.x) * lanes;
    long long r = static_cast<long long>(blockIdx.x) * lanes + lane;
    // WIDE_FOLD rows' loads at a time, then their products and one fold
    for (; r < N; r += WIDE_FOLD * stride) {
      u64 a[WIDE_FOLD], b[WIDE_FOLD];
#pragma unroll
      for (int u = 0; u < WIDE_FOLD; ++u) {
        const long long ru = r + u * stride;
        a[u] = ru < N ? __ldg(xs + ru * n) : 0ull;
        b[u] = ru < N ? __ldg(ws + ru * n) : 0ull;
      }
#pragma unroll
      for (int u = 0; u < WIDE_FOLD; ++u) mac128(acc, a[u], b[u]);
      fold128(acc, f);
    }
  }
  // the CTA's partial: its lanes' residues, summed in 128 bits
  part[tid] = {active ? reduce128(acc, f) : 0ull, 0ull};
  __syncthreads();
  if (lane == 0 && o < ab) {
    U128 s = {0, 0};
    for (int l = 0; l < lanes; ++l) add128(s, part[l * outs + oi].lo);
    // [row stripe][o]: a CTA's partials are contiguous
    scratch[static_cast<long long>(blockIdx.x) * ab + o] = reduce128(s, f);
  }
  // the last CTA to finish sums the partials of every output
  __threadfence();
  __syncthreads();
  u64* ticket = scratch + GW_SCRATCH;
  if (tid == 0)
    last = atomicAdd(reinterpret_cast<unsigned long long*>(ticket), 1ull) ==
           static_cast<u64>(gridDim.x) * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // a pass per `outs` outputs: thread (lane, oi) adds the stripes lane,
  // lane + lanes, ... of output o0 + oi (one stripe's reads contiguous
  // across threads), then the CTA adds its lanes' sums
  for (int o0 = 0; o0 < ab; o0 += outs) {
    const int e = o0 + oi;
    U128 s = {0, 0};
    if (lane < lanes && e < ab)
      for (unsigned c = lane; c < gridDim.x; c += lanes)
        add128(s, __ldcg(scratch + static_cast<long long>(c) * ab + e));
    __syncthreads();  // the previous pass has read part
    part[tid] = s;
    __syncthreads();
    if (lane == 0 && e < ab) {
      U128 t = {0, 0};
      for (int l = 0; l < lanes; ++l)
        add128(t, reduce128(part[l * outs + oi], f));
      gout[e] = reduce128(t, f);
    }
  }
  if (tid == 0) atomicExch(reinterpret_cast<unsigned long long*>(ticket), 0ull);
}

extern "C" int gram_wide(const u64* v, const u64* av, int n, long long N,
                         unsigned long long p, unsigned long long mu,
                         unsigned long long pinv, unsigned long long r2,
                         u64* scratch, u64* gout, void* stream) {
  if (n < 1 || N < 0) return cudaErrorInvalidValue;
  const int ab = 2 * n * n;
  const int outs = ab < GW_THREADS ? ab : GW_THREADS;
  const int lanes = GW_THREADS / outs;
  const int tiles = (ab + outs - 1) / outs;
  long long gx = (N + static_cast<long long>(lanes) * GW_ROWS_PER_LANE - 1) /
                 (static_cast<long long>(lanes) * GW_ROWS_PER_LANE);
  if (gx > GW_MAX_CTAS) gx = GW_MAX_CTAS;
  if (gx > GW_SCRATCH / ab) gx = GW_SCRATCH / ab;
  if (gx < 1) gx = 1;
  const dim3 grid(static_cast<unsigned>(gx), static_cast<unsigned>(tiles));
  gram_wide_kernel<<<grid, GW_THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      v, av, n, N, outs, lanes, WideField{p, mu, pinv, r2}, scratch, gout);
  return static_cast<int>(cudaGetLastError());
}
