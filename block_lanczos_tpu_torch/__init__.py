"""block_lanczos_tpu_torch — exact block Lanczos over GF(p) on PyTorch + CUDA.

The PyTorch port of `block_lanczos_tpu`: the same solver, the same residues
bit for bit, with the per-iteration device work done by four hand-written
CUDA kernels for Hopper (`csrc/`).  This first slice covers the narrow
field (p <= 2^30 - 35, including p = 2 with any n that is not a multiple
of 32) on one device.

Entry points run on the CUDA device unless the caller asks for the CPU
(`device="cpu"`), where every kernel wrapper takes its plain PyTorch
version.  The package imports neither JAX nor anything of the JAX package.

Layout (each module mirrors its counterpart in the JAX package):
  ops/gfp.py           field context and elementwise mod-p arithmetic
  ops/spmm.py          hybrid ELL + CSR-spill layout and the SpMV kernel
  ops/dense.py         the fused Gram kernel and small dense products
  ops/semi_inverse.py  the single-CTA two-phase Gauss-Jordan kernel
  models/lanczos.py    orthogonalize kernel, iteration, solve loop
  kernels/             nvcc build of csrc/*.cu and the ctypes binding
  convert.py           carrying JAX-package state and layouts across
  utils/               MatrixMarket IO, RNG, generator, checker, CLI
"""
