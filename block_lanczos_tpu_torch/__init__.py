"""block_lanczos_tpu_torch — exact block Lanczos over GF(p) on PyTorch + CUDA.

The PyTorch port of `block_lanczos_tpu`: the same solver, the same residues
bit for bit, with the per-iteration device work done by hand-written CUDA
kernels for Hopper (`csrc/`).  It covers the narrow field (p <= 2^30 - 35,
including p = 2 with any n that is not a multiple of 32) on four kernels,
the bitsliced GF(2) solver (p = 2, n % 32 == 0) on four more and the wide
field (2^30 - 35 < p < 2^62, native 64-bit residues) on four more, each on
one device or on a mesh of torch.distributed ranks (parallel/), whose exact
all-reduces are three more kernels.

Entry points run on the CUDA device unless the caller asks for the CPU
(`device="cpu"`), where every kernel wrapper takes its plain PyTorch
version.  The package imports neither JAX nor anything of the JAX package.

Layout (each module mirrors its counterpart in the JAX package):
  ops/gfp.py           field context and elementwise mod-p arithmetic
  ops/spmm.py          hybrid ELL + CSR-spill layout and the SpMV kernel
  ops/dense.py         the fused Gram kernel and small dense products
  ops/semi_inverse.py  the single-CTA two-phase Gauss-Jordan kernel
  ops/gf2.py           bit packing, the GF(2) Gram and semi-inverse kernels,
                       dedup of duplicate operator lines
  ops/gfp_wide.py      the wide field: context, plain int64 arithmetic,
                       mirrors of csrc/modp64.cuh
  ops/wide_ops.py      the wide SpMV, Gram and semi-inverse kernels
  models/lanczos.py    orthogonalize kernel, iteration, solve loop
  models/lanczos_gf2.py  the GF(2) layout, SpMV and orthogonalize kernels,
                       BlockLanczosGF2
  models/lanczos_wide.py  the wide orthogonalize kernel, BlockLanczosWide
  parallel/            the mesh: the grid of ranks, the partition, the
                       exact collectives, the three sharded solvers, the
                       launcher of local ranks
  kernels/             nvcc build of csrc/*.cu and the ctypes binding
  convert.py           carrying JAX-package state and layouts across
  utils/               MatrixMarket IO, RNG, generator, checker, salvage,
                       CLI
"""
