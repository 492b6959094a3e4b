// Shared mod-p arithmetic for the narrow-field kernels (p <= 2^30 - 35).
//
// Residues live in int32 tensors with 0 <= r < p < 2^30.  The arithmetic
// rule every kernel follows:
//   * a product of two residues is < 2^60 and is formed exactly in u64;
//   * every product is reduced % p BEFORE it is summed, so a u64 sum of
//     addends < 2^30 stays exact for up to 2^34 terms;
//   * the sum is reduced once more at the end.
// Integer sums are associative, so results are bit-exact whatever the
// summation order, thread split or block order.  `%` by a runtime p is slow
// but exact; Barrett or Montgomery reduction is a later optimisation.
#pragma once

#include <cuda_runtime.h>

typedef unsigned long long u64;
typedef unsigned int u32;

__device__ __forceinline__ u64 mulmod(u64 a, u64 b, u64 p) {
  return (a * b) % p;
}

// a^e mod p by square-and-multiply; e == 0 gives 1 (p = 2 inverts via e = 0).
__device__ __forceinline__ u64 powmod(u64 a, u64 e, u64 p) {
  u64 r = 1 % p;
  a %= p;
  while (e) {
    if (e & 1) r = mulmod(r, a, p);
    a = mulmod(a, a, p);
    e >>= 1;
  }
  return r;
}

// Error text for the codes the C entry points return (cudaGetLastError()).
extern "C" const char* bl_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
