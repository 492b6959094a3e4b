// spmv_ell — exact mod-p sparse product y = op * x over the hybrid layout.
//
// Replaces, in the JAX package, ops/spmm.py::spmv_hybrid (the ELL slab
// walk) together with ops/spmm.py::_spmv_prefix (the CSR spill's limb
// prefix-sum difference), which XLA compiled on the TPU.  Computes
//
//   y[r, j] = sum_k vals[k, r] * x[cols[k, r], j]
//           + sum_{e in rowptr[r] .. rowptr[r+1]} sp_vals[e] * x[sp_cols[e], j]
//
// mod p for r < out_dim, and y[r, :] = 0 for out_dim <= r < out_rows (zero
// padding must stay zero through every phase of the solver).
//
// What bounds it on an H100: bytes.  Each true nonzero costs 8 B of slab
// (column + value) plus a gather of x; x (at most 4.8 MB at the bench size,
// n = 4) stays in the 50 MB L2, so the floor is the slab stream at
// 3.35 TB/s.  Design: one thread per output element (row r, lane j), so the
// n threads of a row sit next to each other and read x[col, 0..n) as one
// contiguous run; the slab is stored column-major (L, out_dim) so that
// neighbouring rows read neighbouring slab addresses; empty slots (value 0)
// skip their gather.  The row's spill segment is walked by the same thread
// after the slab, so there is one launch and no second pass.  Every product
// is reduced % p before it is summed (modp.cuh).
#include "modp.cuh"

__global__ void spmv_ell_kernel(const int* __restrict__ cols,
                                const int* __restrict__ vals, int ell,
                                long long ld, const int* __restrict__ rowptr,
                                const int* __restrict__ sp_cols,
                                const int* __restrict__ sp_vals,
                                const int* __restrict__ x,
                                int* __restrict__ y, long long out_dim,
                                long long out_rows, int n, u64 p) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= out_rows * n) return;
  long long r = t / n;
  int j = static_cast<int>(t - r * n);
  u64 acc = 0;
  if (r < out_dim) {
    for (int k = 0; k < ell; ++k) {
      long long s = static_cast<long long>(k) * ld + r;
      u32 v = static_cast<u32>(__ldg(vals + s));
      if (v != 0) {
        long long c = __ldg(cols + s);
        acc += mulmod(v, static_cast<u32>(__ldg(x + c * n + j)), p);
      }
    }
    int e1 = __ldg(rowptr + r + 1);
    for (int e = __ldg(rowptr + r); e < e1; ++e) {
      long long c = __ldg(sp_cols + e);
      acc += mulmod(static_cast<u32>(__ldg(sp_vals + e)),
                    static_cast<u32>(__ldg(x + c * n + j)), p);
    }
    acc %= p;
  }
  y[t] = static_cast<int>(acc);
}

extern "C" int spmv_ell(const int* cols, const int* vals, int ell,
                        long long ld, const int* rowptr, const int* sp_cols,
                        const int* sp_vals, const int* x, int* y,
                        long long out_dim, long long out_rows, int n,
                        unsigned long long p, void* stream) {
  const int threads = 256;
  long long total = out_rows * n;
  if (total > 0) {
    unsigned blocks = static_cast<unsigned>((total + threads - 1) / threads);
    spmv_ell_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
        cols, vals, ell, ld, rowptr, sp_cols, sp_vals, x, y, out_dim,
        out_rows, n, p);
  }
  return static_cast<int>(cudaGetLastError());
}
