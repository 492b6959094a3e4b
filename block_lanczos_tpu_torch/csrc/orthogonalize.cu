// orthogonalize — one step of the Thome recurrence, in place:
//
//   upd = [v | p] * rhs                      (rhs from semi_inverse.cu)
//   v  <- where(d, Av, v) + upd[:, :n]       (mod p)
//   p  <- where(d, 0,  p) + upd[:, n:]       (mod p)
//
// Replaces, in the JAX package, the (N, 2n) x (2n, 2n) pass of
// models/lanczos.py::orthogonalize_device (dense.matmul_mod plus the masked
// selects on d) and the stop/invariant selects of iteration_step
// (models/lanczos.py:144-148), which XLA fused on the TPU.
//
// v and p are updated IN PLACE.  When the latched state says stop or a
// failed invariant (state = [stop, inv_ok, k_done, frozen]), v and p are
// left untouched: on stop the converged block is the pre-update v, as in the
// reference.  Thread (0, 0) counts the iteration in k_done while the state
// is not yet frozen and freezes it on a halt, so a block of K launched
// iterations counts exactly the unhalted ones (the stopping probe included)
// and every iteration after a halt recomputes the same values and changes
// nothing.
//
// What bounds it on an H100: bytes — v, p and Av read once, v and p
// written once (24 MB at the bench size, n = 4).  Design: one thread per
// output element (row, column of [v' | p']), the 2n threads of a row in one
// block; each thread forms its output in a register, the block
// synchronises, then writes — so the in-place update never overwrites an
// input that a thread of the same row still has to read.  Products are
// reduced % p before they are summed (modp.cuh).
#include "modp.cuh"

__global__ void orthogonalize_kernel(int* __restrict__ v, int* __restrict__ pb,
                                     const int* __restrict__ av,
                                     const int* __restrict__ rhs,
                                     const int* __restrict__ d, long long N,
                                     int n, u64 p, int* __restrict__ state) {
  const bool halt = state[0] != 0 || state[1] == 0;
  if (blockIdx.x == 0 && threadIdx.x == 0 && state[3] == 0) {
    state[2] += 1;
    if (halt) state[3] = 1;
  }
  if (halt) return;  // uniform over the grid: nobody writes stop/inv_ok here

  const int w = 2 * n;
  const int rows_per_block = blockDim.x / w;
  const int local = threadIdx.x / w;
  const int c = threadIdx.x - local * w;
  const long long r = static_cast<long long>(blockIdx.x) * rows_per_block + local;
  const bool active = local < rows_per_block && r < N;
  u32 out = 0;
  if (active) {
    const int* vr = v + r * n;
    const int* pr = pb + r * n;
    u64 acc = 0;
    for (int k = 0; k < n; ++k)
      acc += mulmod(static_cast<u32>(vr[k]), static_cast<u32>(__ldg(rhs + k * w + c)), p);
    if (c < n) {
      // rows n..2n of rhs are zero in the right half: only v' needs p
      for (int k = 0; k < n; ++k)
        acc += mulmod(static_cast<u32>(pr[k]),
                      static_cast<u32>(__ldg(rhs + (n + k) * w + c)), p);
      const u32 base = __ldg(d + c) ? static_cast<u32>(__ldg(av + r * n + c))
                                    : static_cast<u32>(vr[c]);
      out = static_cast<u32>((base + acc) % p);
    } else {
      const int cj = c - n;
      const u32 base = __ldg(d + cj) ? 0u : static_cast<u32>(pr[cj]);
      out = static_cast<u32>((base + acc) % p);
    }
  }
  __syncthreads();
  if (active) {
    if (c < n)
      v[r * n + c] = static_cast<int>(out);
    else
      pb[r * n + (c - n)] = static_cast<int>(out);
  }
}

extern "C" int orthogonalize(int* v, int* pb, const int* av, const int* rhs,
                             const int* d, long long N, int n,
                             unsigned long long p, int* state, void* stream) {
  const int w = 2 * n;
  if (n < 1 || w > 1024) return cudaErrorInvalidValue;
  const int rows_per_block = (w >= 256) ? 1 : 256 / w;
  const int threads = rows_per_block * w;
  const long long nblocks = N > 0 ? (N + rows_per_block - 1) / rows_per_block : 1;
  orthogonalize_kernel<<<static_cast<unsigned>(nblocks), threads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      v, pb, av, rhs, d, N, n, p, state);
  return static_cast<int>(cudaGetLastError());
}
